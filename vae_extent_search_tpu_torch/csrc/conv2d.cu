// Implicit-GEMM conv2d + bias + ReLU, stride 1, zero padding, for Hopper
// (sm_90a): the second self-tuning target kernel, whose block configuration
// (boh, bco, bci) the active search tunes by timing it on the card.
//
// Replaces the TPU kernel vae_extent_search_tpu/ops/conv2d_pallas.py
// (_kernel, launched by make_conv2d through pl.pallas_call). Inputs x
// [N, H, W, CI] (NHWC) and w [KH, KW, CI, CO] (HWIO), both float32 or both
// bfloat16, bias [CO] float32; output [N, OH, OW, CO] float32,
//   out[n, oh, ow, co] = max(0, bias[co] + sum over kh, kw, ci of
//                        xpad[n, oh + kh, ow + kw, ci] * w[kh, kw, ci, co])
// with OH = H + 2 pad - KH + 1, OW = W + 2 pad - KW + 1 and xpad x padded
// by `pad` zeros on each side of H and W.
//
// Both paths share the tiling the configuration names: one block computes
// boh output rows x all OW columns x bco output channels of one image, and
// loops over (kh, ci-block of bci). For each it stages in shared memory the
// input window [boh][OW + KW - 1][bci] (rows oh0 + kh - pad ..., every
// padded column) and the weight slices [KW][bci][bco], then runs kw inside,
// so a window is read once for all KW taps. Zero padding is masked while
// the window is loaded (no padded copy of x is made), and bias + ReLU are
// fused into the store. The wrapper (ops/conv2d.py) checks the
// configuration against the lattice of the path its dtype takes.
//
// bfloat16: tensor cores. Bound on an H100 at 1 x 56 x 56 x 256 -> 256,
// 3 x 3: operations, 3.70 GFLOP is 3.7 us at 989 TFLOP/s against ~6.0 MB of
// input, weights and f32 output (1.8 us at 3.35 TB/s). Warps multiply with
// mma.sync m16n8k16 (bf16 in, f32 accumulators in registers), each warp an
// MT x NT grid of 16 x 8 tiles of the [boh * OW, bco] output tile. A
// fragments come from the window through ldmatrix, one row address per lane
// (an output position), so the kw tap is an address offset; wgmma's 8-row
// core matrices cannot take that one-position shift. B fragments come from
// the weight slices through ldmatrix.trans. Rows of both are padded by 16
// bytes, so the eight addresses of an ldmatrix fall in eight different
// bank groups. The window and weights of the (kh, ci-block) one or two
// steps ahead are loaded with cp.async (16 bytes, zero-filled through
// src-size for padding and ragged edges) into a ring of three buffers (two
// where three do not fit) while the current one is multiplied, with one
// barrier per step; each thread's 16-byte channel chunk is fixed and its
// row and column advance without divisions. Where CI or CO is not a
// multiple of 8 the loads are plain element loads.
// Ragged edges are masked rather than refused: positions past boh * OW or
// rows past OH are not stored, channels past CO are zero weights and not
// stored, channels past CI are zeros, so boh, bco and bci need not divide
// OH, CO and CI, and bci = 16 covers CI < 16.
//
// float32: the CUDA cores (tensor cores in f32 would be TF32). Each thread
// owns a TM x TN micro-tile of the output tile, strided by the thread grid,
// at most 256 threads; boh | OH, bco | CO, bci | CI.
//
// Sums run in a fixed order, so two launches give the same bits. Each
// instance's shared-memory limit is raised once, on its first launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxSmem = 232448;  // an H100 block's 227 KB
int g_attr_calls = 0;             // cudaFuncSetAttribute calls made

template <typename K>
cudaError_t raise_smem_once(K kernel, bool& done) {
  if (done) return cudaSuccess;
  ++g_attr_calls;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  done = err == cudaSuccess;
  return err;
}

struct Args {
  const void* x;
  const void* w;
  const float* bias;
  float* out;
  int N, H, W, CI, CO, KH, KW, pad, OH, OW, boh, bco, bci;
};

// ---------------------------------------------------------------------------
// float32 on the CUDA cores
// ---------------------------------------------------------------------------

template <int TM, int TN>
__global__ void __launch_bounds__(kMaxThreads) conv_f32(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const float* __restrict__ x = static_cast<const float*>(a.x);
  const float* __restrict__ w = static_cast<const float*>(a.w);
  const int H = a.H, W = a.W, CI = a.CI, CO = a.CO, KH = a.KH, KW = a.KW, pad = a.pad;
  const int OH = a.OH, OW = a.OW, boh = a.boh, bco = a.bco, bci = a.bci;
  const int OWp = OW + KW - 1;                      // padded window width
  float* xs = reinterpret_cast<float*>(smem_raw);   // [boh][OWp][bci]
  float* ws = xs + boh * OWp * bci;                 // [KW][bci][bco]
  const int tiles_co = CO / bco, tiles_oh = OH / boh;
  int b = blockIdx.x;
  const int co0 = (b % tiles_co) * bco;
  b /= tiles_co;
  const int oh0 = (b % tiles_oh) * boh;
  const int n = b / tiles_oh;
  const int P = boh * OW;                           // output positions per block
  const int RX = bco / TN, RY = P / TM;             // the thread grid
  const int tid = threadIdx.x, nt = blockDim.x;
  const int tx = tid % RX, ty = tid / RX;

  int xoff[TM];  // each owned position's window offset at kw = 0, c = 0
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int p = ty + i * RY;
    xoff[i] = ((p / OW) * OWp + p % OW) * bci;
  }
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int win = boh * OWp * bci, wsl = KW * bci * bco;
  for (int kh = 0; kh < KH; ++kh) {
    for (int ci0 = 0; ci0 < CI; ci0 += bci) {
      for (int e = tid; e < win; e += nt) {
        const int c = e % bci, t = e / bci;
        const int col = t % OWp, r = t / OWp;
        const int ih = oh0 + r + kh - pad, iw = col - pad;
        float v = 0.f;
        if (ih >= 0 && ih < H && iw >= 0 && iw < W)
          v = x[(((size_t)n * H + ih) * W + iw) * CI + ci0 + c];
        xs[e] = v;
      }
      for (int e = tid; e < wsl; e += nt) {
        const int co = e % bco, t = e / bco;
        const int c = t % bci, kw = t / bci;
        ws[e] = w[(((size_t)kh * KW + kw) * CI + ci0 + c) * CO + co0 + co];
      }
      __syncthreads();
      for (int kw = 0; kw < KW; ++kw) {
        for (int c = 0; c < bci; ++c) {
          float av[TM], bv[TN];
#pragma unroll
          for (int i = 0; i < TM; ++i) av[i] = xs[xoff[i] + kw * bci + c];
#pragma unroll
          for (int j = 0; j < TN; ++j) bv[j] = ws[(kw * bci + c) * bco + tx + j * RX];
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int p = ty + i * RY;
    const size_t row = ((size_t)n * OH + oh0 + p / OW) * OW + p % OW;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int co = co0 + tx + j * RX;
      a.out[row * CO + co] = fmaxf(acc[i][j] + a.bias[co], 0.f);
    }
  }
}

template <int TM, int TN>
cudaError_t launch_f32(const Args& a, cudaStream_t s) {
  static bool attr_done = false;
  cudaError_t err = raise_smem_once(conv_f32<TM, TN>, attr_done);
  if (err != cudaSuccess) return err;
  const size_t smem =
      ((size_t)a.boh * (a.OW + a.KW - 1) * a.bci + (size_t)a.KW * a.bci * a.bco) * 4;
  const unsigned blocks = (unsigned)(a.N * (a.OH / a.boh) * (a.CO / a.bco));
  const int threads = (a.boh * a.OW / TM) * (a.bco / TN);
  conv_f32<TM, TN><<<blocks, threads, smem, s>>>(a);
  return cudaGetLastError();
}

template <int TM>
cudaError_t launch_f32_tn(int tn, const Args& a, cudaStream_t s) {
  switch (tn) {
    case 1: return launch_f32<TM, 1>(a, s);
    case 2: return launch_f32<TM, 2>(a, s);
    case 4: return launch_f32<TM, 4>(a, s);
    case 8: return launch_f32<TM, 8>(a, s);
  }
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores: cp.async ring + ldmatrix + mma.sync
// ---------------------------------------------------------------------------

constexpr int kPad = 8;  // bf16 elements of padding per shared-memory row (16 bytes)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared-memory elements of one buffer: the window [boh][OWp][bci + kPad]
// and the weight slices [KW][bci][bco + kPad].
__host__ __device__ inline int bf16_window(int boh, int OWp, int bci) {
  return boh * OWp * (bci + kPad);
}
__host__ __device__ inline int bf16_buffer(int boh, int OWp, int bci, int KW, int bco) {
  return bf16_window(boh, OWp, bci) + KW * bci * (bco + kPad);
}

// Stage one (kh, ci-block) into buffer `buf` (element offset in shared
// memory): cp.async 16-byte chunks where CI and CO are multiples of 8
// (`vec`), plain element loads otherwise; zeros outside x, past CI, past CO.
__device__ __forceinline__ void stage_bf16(const Args& a, __nv_bfloat16* buf, bool vec, int n,
                                           int oh0, int co0, int kh, int ci0, int OWp) {
  const __nv_bfloat16* __restrict__ x = static_cast<const __nv_bfloat16*>(a.x);
  const __nv_bfloat16* __restrict__ w = static_cast<const __nv_bfloat16*>(a.w);
  const int bci = a.bci, bco = a.bco, CI = a.CI, CO = a.CO;
  const int xr = bci + kPad, wr = bco + kPad;
  __nv_bfloat16* xs = buf;
  __nv_bfloat16* ws = buf + bf16_window(a.boh, OWp, bci);
  const int tid = threadIdx.x, nt = blockDim.x;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  if (vec) {
    // window: the thread's 16-byte channel chunk c8 is fixed (bci / 8 is a
    // power of two dividing the block's threads); (row, column) advance
    // without a division
    const int c8n = bci / 8, c8 = tid & (c8n - 1), tstep = nt / c8n;
    const int ci = ci0 + c8 * 8, tn = a.boh * OWp;
    int t = tid / c8n, r = t / OWp, col = t - r * OWp;
    const int dr = tstep / OWp, dcol = tstep - dr * OWp;
    for (; t < tn; t += tstep) {
      const int ih = oh0 + r + kh - a.pad, iw = col - a.pad;
      const bool ok = ih >= 0 && ih < a.H && iw >= 0 && iw < a.W && ci < CI;
      const __nv_bfloat16* src = ok ? x + (((size_t)n * a.H + ih) * a.W + iw) * CI + ci : x;
      cp_async16(smem_u32(xs + t * xr + c8 * 8), src, ok);
      r += dr;
      col += dcol;
      if (col >= OWp) { col -= OWp; ++r; }
    }
    // weights: rows (kw, c) of bco / 8 chunks; bci is a power of two
    const int o8n = bco / 8, wn = a.KW * bci, dt = nt / o8n, do8 = nt - dt * o8n;
    const int lg_bci = __ffs(bci) - 1;
    int o8 = tid % o8n, tw = tid / o8n;
    while (tw < wn) {
      const int kw = tw >> lg_bci, c = tw & (bci - 1);
      const int cc = ci0 + c, co = co0 + o8 * 8;
      const bool ok = cc < CI && co < CO;
      const __nv_bfloat16* src = ok ? w + (((size_t)kh * a.KW + kw) * CI + cc) * CO + co : w;
      cp_async16(smem_u32(ws + tw * wr + o8 * 8), src, ok);
      o8 += do8;
      tw += dt;
      if (o8 >= o8n) { o8 -= o8n; ++tw; }
    }
  } else {
    const int win = a.boh * OWp * bci;
    for (int e = tid; e < win; e += nt) {
      const int c = e % bci, t = e / bci;
      const int col = t % OWp, r = t / OWp;
      const int ih = oh0 + r + kh - a.pad, iw = col - a.pad, ci = ci0 + c;
      __nv_bfloat16 v = zero;
      if (ih >= 0 && ih < a.H && iw >= 0 && iw < a.W && ci < CI)
        v = x[(((size_t)n * a.H + ih) * a.W + iw) * CI + ci];
      xs[t * xr + c] = v;
    }
    const int wsl = a.KW * bci * bco;
    for (int e = tid; e < wsl; e += nt) {
      const int o = e % bco, t = e / bco;
      const int c = t % bci, kw = t / bci;
      const int ci = ci0 + c, co = co0 + o;
      __nv_bfloat16 v = zero;
      if (ci < CI && co < CO) v = w[(((size_t)kh * a.KW + kw) * CI + ci) * CO + co];
      ws[t * wr + o] = v;
    }
  }
}

// blockDim = 32 * WR * WC warps; warp (wr, wc) computes MT x NT tiles of
// 16 positions x 8 channels at positions 16 MT wr + ..., channels 8 NT wc + ...
template <int MT, int NT>
__global__ void __launch_bounds__(kMaxThreads) conv_bf16(Args a, int WC, int vec, int nbuf) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int OW = a.OW, OWp = OW + a.KW - 1, bci = a.bci, bco = a.bco;
  const int xr = bci + kPad, wr = bco + kPad;
  const int buf_elems = bf16_buffer(a.boh, OWp, bci, a.KW, bco);
  const int tiles_co = (a.CO + bco - 1) / bco, tiles_oh = (a.OH + a.boh - 1) / a.boh;
  int b = blockIdx.x;
  const int co0 = (b % tiles_co) * bco;
  b /= tiles_co;
  const int oh0 = (b % tiles_oh) * a.boh;
  const int n = b / tiles_oh;
  const int P = a.boh * OW;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wrow = warp / WC, wcol = warp % WC;
  const int pw = wrow * MT * 16, cw = wcol * NT * 8;  // the warp's first position, channel

  // lane's ldmatrix row in each m tile: window element offset at kw = 0, k = 0
  int aoff[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int p = min(pw + mt * 16 + (lane & 15), P - 1);
    aoff[mt] = ((p / OW) * OWp + p % OW) * xr + (lane >> 4) * 8;
  }
  // lane's ldmatrix.trans row: k row (lane & 7) + 8 ((lane >> 3) & 1), channel (lane >> 4) * 8
  const int boff = ((lane & 7) + ((lane >> 3) & 1) * 8) * wr + cw + (lane >> 4) * 8;

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  // a ring of nbuf buffers, one cp.async group per (kh, ci-block), empty
  // past the end so that wait_group counts iterations: at iteration it,
  // wait for its group, one barrier (every warp is then done with
  // iteration it - 1's buffer), issue the loads of iteration it + nbuf - 1
  // into that buffer, and multiply while they fly
  const int nci = (a.CI + bci - 1) / bci, iters = a.KH * nci;
  for (int s = 0; s < nbuf - 1; ++s) {
    if (s < iters) stage_bf16(a, smem + s * buf_elems, vec, n, oh0, co0, s / nci,
                              (s % nci) * bci, OWp);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int it = 0; it < iters; ++it) {
    if (nbuf == 3) asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    else asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    const int nx = it + nbuf - 1;
    if (nx < iters)
      stage_bf16(a, smem + (nx % nbuf) * buf_elems, vec, n, oh0, co0, nx / nci,
                 (nx % nci) * bci, OWp);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    __nv_bfloat16* cur = smem + (it % nbuf) * buf_elems;
    const uint32_t xs = smem_u32(cur), ws = smem_u32(cur + bf16_window(a.boh, OWp, bci));
    // the k steps of 16 channels, kw outer: step st is tap kw = st / (bci /
    // 16); its A rows sit 16 st + 8 kw elements into each window row (the
    // row is bci + 8 long), its B rows 16 st rows into the weights. Unrolled
    // so that ptxas can issue the next steps' ldmatrix under this one's mma
    const int lg = __ffs(bci / 16) - 1, steps = a.KW << lg;
#pragma unroll 2
    for (int st = 0; st < steps; ++st) {
      const int aoffs = 16 * st + 8 * (st >> lg);
      uint32_t af[MT][4], bf[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) ldmatrix_x4(af[mt], xs + 2 * (aoff[mt] + aoffs));
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, ws + 2 * (boff + 16 * st * wr + np * 16));
        bf[2 * np][0] = r[0];
        bf[2 * np][1] = r[1];
        bf[2 * np + 1][0] = r[2];
        bf[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
    }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = pw + mt * 16 + lane / 4 + 8 * h;
      const int oh = oh0 + p / OW;
      if (p >= P || oh >= a.OH) continue;
      float* row = a.out + (((size_t)n * a.OH + oh) * OW + p % OW) * a.CO;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int co = co0 + cw + nt * 8 + 2 * (lane % 4);
        if (co < a.CO) row[co] = fmaxf(acc[mt][nt][2 * h] + a.bias[co], 0.f);
        if (co + 1 < a.CO) row[co + 1] = fmaxf(acc[mt][nt][2 * h + 1] + a.bias[co + 1], 0.f);
      }
    }
  }
}

size_t bf16_smem(const Args& a, int nbuf) {
  return 2 * (size_t)nbuf * bf16_buffer(a.boh, a.OW + a.KW - 1, a.bci, a.KW, a.bco);
}

template <int MT, int NT>
cudaError_t launch_bf16(const Args& a, int wr, int wc, int nbuf, cudaStream_t s) {
  static bool attr_done = false;
  cudaError_t err = raise_smem_once(conv_bf16<MT, NT>, attr_done);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)(a.N * ((a.OH + a.boh - 1) / a.boh) *
                                     ((a.CO + a.bco - 1) / a.bco));
  const int vec = a.CI % 8 == 0 && a.CO % 8 == 0;
  conv_bf16<MT, NT><<<blocks, 32 * wr * wc, bf16_smem(a, nbuf), s>>>(a, wc, vec, nbuf);
  return cudaGetLastError();
}

template <int MT>
cudaError_t launch_bf16_nt(int nt, const Args& a, int wr, int wc, int nbuf, cudaStream_t s) {
  switch (nt) {
    case 2: return launch_bf16<MT, 2>(a, wr, wc, nbuf, s);
    case 4: return launch_bf16<MT, 4>(a, wr, wc, nbuf, s);
    case 8: return launch_bf16<MT, 8>(a, wr, wc, nbuf, s);
  }
  return cudaErrorInvalidValue;
}

bool shape_ok(int N, int CI, int CO, int KH, int KW, int pad, int OH, int OW, int boh,
              int bco, int bci) {
  return N > 0 && CI > 0 && CO > 0 && KH > 0 && KW > 0 && pad >= 0 && OH > 0 && OW > 0 &&
         boh > 0 && bco > 0 && bci > 0;
}

}  // namespace

// float32: (tm, tn) the thread micro-tile, each in {1, 2, 4, 8}, dividing
// boh * OW and bco, with (boh * OW / tm) * (bco / tn) <= 256; boh | OH,
// bco | CO, bci | CI. Returns a cudaError_t (0 on success); launches
// nothing on bad arguments.
extern "C" int conv2d_f32_launch(const void* x, const void* w, const void* bias, void* out,
                                 int N, int H, int W, int CI, int CO, int KH, int KW, int pad,
                                 int boh, int bco, int bci, int tm, int tn, void* stream) {
  const int OH = H + 2 * pad - KH + 1, OW = W + 2 * pad - KW + 1;
  if (!shape_ok(N, CI, CO, KH, KW, pad, OH, OW, boh, bco, bci) || OH % boh || CO % bco ||
      CI % bci || tm <= 0 || tn <= 0 || (boh * OW) % tm || bco % tn ||
      (boh * OW / tm) * (bco / tn) > kMaxThreads ||
      ((size_t)boh * (OW + KW - 1) * bci + (size_t)KW * bci * bco) * 4 > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const Args a{x, w, static_cast<const float*>(bias), static_cast<float*>(out), N, H, W, CI, CO,
               KH, KW, pad, OH, OW, boh, bco, bci};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tm) {
    case 1: return (int)launch_f32_tn<1>(tn, a, s);
    case 2: return (int)launch_f32_tn<2>(tn, a, s);
    case 4: return (int)launch_f32_tn<4>(tn, a, s);
    case 8: return (int)launch_f32_tn<8>(tn, a, s);
  }
  return (int)cudaErrorInvalidValue;
}

// bfloat16: bco a multiple of 16 up to 256, bci 16, 32, 64 or 128; (mt, nt)
// the warp's tiles (mt in {1, 2, 4}, nt in {2, 4, 8}), wr x wc <= 8 warps
// covering the [boh * OW, bco] tile; nbuf (2 or 3) buffers within 227 KB.
extern "C" int conv2d_bf16_launch(const void* x, const void* w, const void* bias, void* out,
                                  int N, int H, int W, int CI, int CO, int KH, int KW, int pad,
                                  int boh, int bco, int bci, int mt, int nt, int wr, int wc,
                                  int nbuf, void* stream) {
  const int OH = H + 2 * pad - KH + 1, OW = W + 2 * pad - KW + 1;
  if (!shape_ok(N, CI, CO, KH, KW, pad, OH, OW, boh, bco, bci) || bco % 16 || bco > 256 ||
      (bci != 16 && bci != 32 && bci != 64 && bci != 128) || wr <= 0 || wc <= 0 ||
      wr * wc * 32 > kMaxThreads || wc * nt * 8 != bco || wr * mt * 16 < boh * OW ||
      nbuf < 2 || nbuf > 3)
    return (int)cudaErrorInvalidValue;
  const Args a{x, w, static_cast<const float*>(bias), static_cast<float*>(out), N, H, W, CI, CO,
               KH, KW, pad, OH, OW, boh, bco, bci};
  if (bf16_smem(a, nbuf) > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mt) {
    case 1: return (int)launch_bf16_nt<1>(nt, a, wr, wc, nbuf, s);
    case 2: return (int)launch_bf16_nt<2>(nt, a, wr, wc, nbuf, s);
    case 4: return (int)launch_bf16_nt<4>(nt, a, wr, wc, nbuf, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The template instances this library holds, as (dtype, p, q) triples into
// out[0 .. 3 * cap): dtype 0 float32 with (TM, TN), dtype 1 bfloat16 with
// (MT, NT). Returns their number.
extern "C" int conv2d_instances(int* out, int cap) {
  int n = 0;
  auto add = [&](int d, int p, int q) {
    if (n < cap) { out[3 * n] = d; out[3 * n + 1] = p; out[3 * n + 2] = q; }
    ++n;
  };
  const int micro[4] = {1, 2, 4, 8}, mts[3] = {1, 2, 4}, nts[3] = {2, 4, 8};
  for (int tm : micro)
    for (int tn : micro) add(0, tm, tn);
  for (int mt : mts)
    for (int nt : nts) add(1, mt, nt);
  return n;
}

// cudaFuncSetAttribute calls made so far (one per instance launched).
extern "C" int conv2d_attr_calls() { return g_attr_calls; }
