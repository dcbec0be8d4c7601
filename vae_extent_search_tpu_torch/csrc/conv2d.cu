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
// Both paths tile the output by the configuration: boh output rows of one
// image at a time (a row block), bco output channels, and a loop over (kh,
// ci-block of bci). For each step they stage in shared memory the input
// window the block's positions read at that kh (its rows of xpad, every
// padded column, bci channels) and the weight slices [KW][bci][channels],
// then run kw inside, so the window is read from global memory once for
// all KW taps: a tap is a row offset into it. Zero padding is zero-filled
// while the window is loaded (no padded copy of x is made), and bias +
// ReLU are fused into the store. The wrapper (ops/conv2d.py) checks the
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
// float32: the CUDA cores, exact FFMA (tensor cores in f32 would be TF32, which
// changes the numbers). Bound on an H100 at 1 x 56 x 56 x 256 -> 256, 3 x 3:
// operations, 3.70 GFLOP is 0.0552 ms at 67 TFLOP/s. The implicit GEMM of the
// f32 matmul (matmul.cu), with its tiling and copies from f32_tile.cuh and its
// FMA step: positions are the rows, output channels the columns, k runs over
// (kh, kw, ci). Positions of a row block are laid out OWq = OW rounded up to 4
// per output row (the columns past OW are computed and not stored), so a
// thread's four consecutive positions lie in one row. A row block's boh * OWq
// positions are cut into tiles of BM, a pure function of boh * OWq
// (ops/conv2d.py::f32_bm: the lattice value with the fewest masked positions,
// the larger on a tie); bco is BN. Two instances per (BM, BN) of CONV_F32_BM x
// CONV_F32_BN, one for KW = 3 and one for any KW; a block per (image, row
// block, position tile, channel tile); each thread holds an 8 x TN accumulator
// tile (F32Tile). A tile's window is the contiguous run of its row block's
// padded input rows that its positions read, flattened: position p of output
// row r reads entry p + r (KW - 1) + kw, so the window holds BM + rows (KW - 1)
// entries (rows: those BM positions can span), each a row of bci floats padded
// by 4, [entry][bci + 4] as the matmul's A tile. A thread's A fragment is one
// LDS.128 along ci per row at entry (its group's entry) + kw; B is w as it
// lies, [kh, kw, ci, co] = the weight slices [KW][bci][BN], the matmul's B
// tile. At KW = 3 a group's four rows at tap kw + 1 are three of its rows at
// tap kw and one more, so six row loads per group and ci chunk serve the three
// taps (twelve in the any-KW loop): shared-memory loads are what bounds an 8 x
// 8 tile's FMA rate (one float per four FMAs at 8 x 8, the SM's break-even),
// and the next chunk's rows are loaded while this chunk's FMAs run. Window and
// weights reach a ring of 2-4 stages by cp.async (LDGSTS, 16 bytes) with one
// barrier per (kh, ci-block) step; each thread's window entries advance by a
// fixed (row, column) step, without a division. Zero padding, rows past OH or
// H, channels past CI and CO are zero-filled (src-size 0), never branched
// around, and the stores are masked, so boh, bco and bci need not divide OH, CO
// and CI. The 16-byte copies need CI and CO to be multiples of 4: the wrapper
// stages zero-padded copies otherwise (ops/matmul.py::staged). A tile past the
// last row block's rows returns at once.
//
// Sums run in a fixed order, so two launches give the same bits. Each
// instance's shared-memory limit is raised once, on its first launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "f32_tile.cuh"

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
// float32 on the CUDA cores: cp.async ring + float4 fragments + FFMA
// ---------------------------------------------------------------------------

// The lattice (ops/conv2d.py: F32_BM, F32_BN), one instance per pair.
#define CONV_F32_BM(X) X(32) X(64) X(96) X(128)
#define CONV_F32_BN(X) X(32) X(64) X(96) X(128)

// The launch plan's arithmetic, on the host and in the kernel
// (ops/conv2d.py::f32_plan mirrors it): the padded row width of the
// positions, the window entries of a position tile, one ring stage's floats.
__host__ __device__ inline int f32_row_width(int OW) { return (OW + 3) & ~3; }
__host__ __device__ inline int f32_window(int bm, int boh, int OWq, int KW) {
  const int span = (bm + OWq - 2) / OWq + 1;  // rows that bm positions can span
  return bm + (span < boh ? span : boh) * (KW - 1);
}
__host__ __device__ inline int f32_stage(int bm, int bn, int bci, int boh, int OWq, int KW) {
  return f32_window(bm, boh, OWq, KW) * (bci + kF32Pad) + KW * bci * bn;
}

// Four k-steps of a thread's 8 x TN tile of a (BM, BN) instance (the f32
// matmul's k-step; matmul.cu keeps its own inline copy, whose compiled code
// a shared function changed):
// acc[i][4 g + j] += a[i].kk * B[kk][g WN/2 + j] for kk = 0 .. 3, where a[i]
// holds row i's four k values (one LDS.128 each) and bs points at the
// thread's first column in B's first row (rows BN floats apart, the thread's
// column blocks WN/2 apart). B's fragment for step kk + 1 is loaded before
// the FMAs of step kk.
template <int TN, int BN, int WN>
__device__ __forceinline__ void f32_fma4(float (&acc)[8][TN], const float4 (&a)[8],
                                         const float* bs) {
  constexpr int FN = TN / 4;
  float4 b[2][FN];
#pragma unroll
  for (int g = 0; g < FN; ++g) b[0][g] = *reinterpret_cast<const float4*>(bs + g * (WN / 2));
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (kk < 3) {
#pragma unroll
      for (int g = 0; g < FN; ++g)
        b[(kk + 1) & 1][g] =
            *reinterpret_cast<const float4*>(bs + (kk + 1) * BN + g * (WN / 2));
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y : kk == 2 ? a[i].z : a[i].w;
#pragma unroll
      for (int g = 0; g < FN; ++g) {
        const float4 bv = b[kk & 1][g];
        acc[i][4 * g + 0] = fmaf(av, bv.x, acc[i][4 * g + 0]);
        acc[i][4 * g + 1] = fmaf(av, bv.y, acc[i][4 * g + 1]);
        acc[i][4 * g + 2] = fmaf(av, bv.z, acc[i][4 * g + 2]);
        acc[i][4 * g + 3] = fmaf(av, bv.w, acc[i][4 * g + 3]);
      }
    }
  }
}

// grid: one block per (image, row block, position tile, channel tile),
// channels fastest. smem: `stages` x (window [win][bci + 4], weights
// [KW][bci][BN]) floats. KWT: 3 where KW is 3 (each window row loaded once
// for the three taps), else 0 (any KW). One block per SM is asked of
// ptxas: the KWT = 3 instances keep two chunks of window rows beside the
// accumulators (up to 255 registers, which still leaves room for two or
// more blocks of up to 128 threads).
template <int BM, int BN, int KWT>
__global__ void __launch_bounds__(F32Tile<BM, BN>::kThreads, 1) conv_f32(Args a, int stages) {
  using T = F32Tile<BM, BN>;
  constexpr int TN = T::kTN, FN = TN / 4, WM = T::kWM, WN = T::kWN, NT = T::kThreads;
  constexpr int NC = BN / 4, b_step = NT / NC;
  static_assert(NT % NC == 0 && NT % 8 == 0, "copy layout");
  extern __shared__ __align__(16) float smem_f32[];
  const float* __restrict__ x = static_cast<const float*>(a.x);
  const float* __restrict__ w = static_cast<const float*>(a.w);
  const int H = a.H, W = a.W, CI = a.CI, CO = a.CO, KW = a.KW, bci = a.bci;
  const int OWq = f32_row_width(a.OW), OWp = OWq + KW - 1, P = a.boh * OWq;
  const int tp = (P + BM - 1) / BM, win = f32_window(BM, a.boh, OWq, KW);
  const int lda = bci + kF32Pad, a_size = win * lda, stage_size = a_size + KW * bci * BN;
  const int tiles_co = (CO + BN - 1) / BN, tiles_oh = (a.OH + a.boh - 1) / a.boh;
  int blk = blockIdx.x;
  const int co0 = (blk % tiles_co) * BN;
  blk /= tiles_co;
  const int p0 = (blk % tp) * BM;  // the tile's first position in its row block
  blk /= tp;
  const int oh0 = (blk % tiles_oh) * a.boh, n = blk / tiles_oh;
  const int live = min(a.boh, a.OH - oh0) * OWq;  // positions of rows below OH
  if (p0 >= live) return;
  // the tile's first window entry in the row block's padded rows, flattened
  // (OWp columns a row): position p of row r reads entry p + r (KW - 1) + kw
  const int f0 = p0 + (p0 / OWq) * (KW - 1);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // this thread's positions are p0 + row0 + h * WM/2 + i, its channels
  // co0 + col0 + g * WN/2 + j (i, j < 4); each group of four positions lies
  // in one row (row0, WM/2, BM and OWq are multiples of 4)
  const int row0 = (warp / (BN / WN)) * WM + (lane / T::kLN) * 4;
  const int col0 = (warp % (BN / WN)) * WN + (lane % T::kLN) * 4;
  // each group's window entry at kw = 0; a group past the row block reads
  // the last group's entries, and its outputs are not stored
  int wrow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = min(p0 + row0 + h * (WM / 2), P - 4);
    wrow[h] = p + (p / OWq) * (KW - 1) - f0;
  }
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem_f32));
  // this thread's copies in each step: window entries e0, e0 + e_step, ...
  // at channel a_c, their (row, column) in the padded rows advancing by
  // (dr, dc); weight rows b_r, b_r + b_step, ... at channel b_n
  const int kcn = bci / 4, a_c = (tid % kcn) * 4, e0 = tid / kcn, e_step = NT / kcn;
  const int r_first = (f0 + e0) / OWp, c_first = f0 + e0 - r_first * OWp;
  const int dr = e_step / OWp, dc = e_step - dr * OWp;
  const int b_r = tid / NC, b_n = (tid % NC) * 4, lg_bci = __ffs(bci) - 1;
  const bool b_in = co0 + b_n < CO;
  const float* xn = x + (size_t)n * H * W * CI;
  const int nci = (CI + bci - 1) / bci, iters = a.KH * nci;

  // step `it` (kh, ci-block) into stage s; zeros outside x, past CI and CO
  auto load = [&](int it, int s) {
    const int kh = it / nci, ci0 = (it - kh * nci) * bci;
    const uint32_t as = sbase + 4u * (uint32_t)(s * stage_size);
    const uint32_t bs = as + 4u * (uint32_t)a_size;
    const bool c_in = ci0 + a_c < CI;
    const int ih0 = oh0 + kh - a.pad;
    int r = r_first, c = c_first;
    for (int e = e0; e < win; e += e_step) {
      const int ih = ih0 + r, iw = c - a.pad;
      const bool ok = c_in && (unsigned)ih < (unsigned)H && (unsigned)iw < (unsigned)W;
      cp_async16(as + 4u * (uint32_t)(e * lda + a_c),
                 ok ? xn + ((size_t)ih * W + iw) * CI + ci0 + a_c : x, ok);
      r += dr;
      c += dc;
      if (c >= OWp) { c -= OWp; ++r; }
    }
    const float* wk = w + (size_t)kh * KW * CI * CO + co0 + b_n;
    for (int t = b_r; t < KW * bci; t += b_step) {
      const int kw = t >> lg_bci, ci = ci0 + (t & (bci - 1));
      const bool ok = b_in && ci < CI;
      cp_async16(bs + 4u * (uint32_t)(t * BN + b_n),
                 ok ? wk + ((size_t)kw * CI + ci) * CO : w, ok);
    }
  };

  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int s = 0; s < stages - 1; ++s) {
    if (s < iters) load(s, s);
    cp_async_commit();
  }
  for (int it = 0; it < iters; ++it) {
    cp_async_wait(stages - 2);
    // step it has landed in every thread's view, and every thread is done
    // with step it - 1, whose stage the next copy refills
    __syncthreads();
    if (it + stages - 1 < iters) load(it + stages - 1, (it + stages - 1) % stages);
    cp_async_commit();
    const float* st = smem_f32 + (it % stages) * stage_size;
    if (KWT) {
      // a group's rows at tap kw are its rows at tap 0 shifted by kw
      // entries, so 4 + KWT - 1 row loads per group and ci chunk serve all
      // KWT taps; the next chunk's rows load while this chunk's FMAs run
      const float* a0 = st + wrow[0] * lda;
      const float* a1 = st + wrow[1] * lda;
      const float* bs = st + a_size + col0;
      float4 ar[2][2][4 + KWT - 1];  // [chunk buffer][group][row]
      auto rows = [&](float4 (&r)[2][4 + KWT - 1], int c) {
#pragma unroll
        for (int j = 0; j < 4 + KWT - 1; ++j) {
          r[0][j] = *reinterpret_cast<const float4*>(a0 + j * lda + c);
          r[1][j] = *reinterpret_cast<const float4*>(a1 + j * lda + c);
        }
      };
      auto taps = [&](const float4 (&r)[2][4 + KWT - 1], int c) {
#pragma unroll
        for (int kw = 0; kw < KWT; ++kw) {
          float4 av[8];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            av[i] = r[0][kw + i];
            av[4 + i] = r[1][kw + i];
          }
          f32_fma4<TN, BN, WN>(acc, av, bs + (kw * bci + c) * BN);
        }
      };
      rows(ar[0], 0);
      for (int c = 0; c < bci; c += 8) {  // bci is a multiple of 8
        rows(ar[1], c + 4);
        taps(ar[0], c);
        if (c + 8 < bci) rows(ar[0], c + 8);
        taps(ar[1], c + 4);
      }
    } else {
      for (int kw = 0; kw < KW; ++kw) {
        const float* a0 = st + (wrow[0] + kw) * lda;
        const float* a1 = st + (wrow[1] + kw) * lda;
        const float* bs = st + a_size + kw * bci * BN + col0;
#pragma unroll 2
        for (int c = 0; c < bci; c += 4) {
          float4 av[8];
#pragma unroll
          for (int i = 0; i < 8; ++i)
            av[i] = *reinterpret_cast<const float4*>((i < 4 ? a0 : a1) + (i % 4) * lda + c);
          f32_fma4<TN, BN, WN>(acc, av, bs + c * BN);
        }
      }
    }
  }
  cp_async_wait(0);

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = p0 + row0 + h * (WM / 2);
    if (p >= live) continue;
    const int r = p / OWq, c = p - r * OWq;
    float* orow = a.out + ((size_t)n * a.OH + oh0 + r) * a.OW * CO;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (c + i >= a.OW) continue;
#pragma unroll
      for (int g = 0; g < FN; ++g) {
        const int co = co0 + col0 + g * (WN / 2);
        if (co >= CO) continue;  // CO is a multiple of 4, so co + 3 < CO too
        *reinterpret_cast<float4*>(orow + (size_t)(c + i) * CO + co) =
            make_float4(fmaxf(acc[4 * h + i][4 * g] + a.bias[co], 0.f),
                        fmaxf(acc[4 * h + i][4 * g + 1] + a.bias[co + 1], 0.f),
                        fmaxf(acc[4 * h + i][4 * g + 2] + a.bias[co + 2], 0.f),
                        fmaxf(acc[4 * h + i][4 * g + 3] + a.bias[co + 3], 0.f));
      }
    }
  }
}

size_t f32_smem(const Args& a, int bm, int bn, int stages) {
  return (size_t)stages * f32_stage(bm, bn, a.bci, a.boh, f32_row_width(a.OW), a.KW) *
         sizeof(float);
}

template <int BM, int BN, int KWT>
cudaError_t launch_f32(const Args& a, int stages, cudaStream_t s) {
  static bool attr_done = false;
  if (!attr_done) {
    // two blocks per SM need the largest shared-memory share of the SM's L1
    cudaError_t err = cudaFuncSetAttribute(
        conv_f32<BM, BN, KWT>, cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
  }
  cudaError_t err = raise_smem_once(conv_f32<BM, BN, KWT>, attr_done);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)a.N * ((a.OH + a.boh - 1) / a.boh) *
                           ((a.boh * f32_row_width(a.OW) + BM - 1) / BM) *
                           ((a.CO + BN - 1) / BN);
  conv_f32<BM, BN, KWT><<<(unsigned)blocks, F32Tile<BM, BN>::kThreads, f32_smem(a, BM, BN, stages),
                     s>>>(a, stages);
  return cudaGetLastError();
}

template <int BM>
cudaError_t launch_f32_bn(int bn, const Args& a, int stages, cudaStream_t s) {
#define CASE(BNV)                                                      \
  if (bn == BNV)                                                       \
    return a.KW == 3 ? launch_f32<BM, BNV, 3>(a, stages, s) : launch_f32<BM, BNV, 0>(a, stages, s);
  CONV_F32_BN(CASE)
#undef CASE
  return cudaErrorInvalidValue;
}

cudaError_t launch_f32_any(int bm, int bn, const Args& a, int stages, cudaStream_t s) {
#define CASE(BMV) \
  if (bm == BMV) return launch_f32_bn<BMV>(bn, a, stages, s);
  CONV_F32_BM(CASE)
#undef CASE
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

// float32: bco (BN) and bm (BM, ops/conv2d.py::f32_bm) of the lattice, bci 8,
// 16 or 32, `stages` (2 .. 4) ring stages within 227 KB. CI and CO must be
// multiples of 4 and x, w and out 16-byte aligned (16-byte copies and
// stores). Returns a cudaError_t (0 on success); launches nothing on bad
// arguments.
extern "C" int conv2d_f32_launch(const void* x, const void* w, const void* bias, void* out,
                                 int N, int H, int W, int CI, int CO, int KH, int KW, int pad,
                                 int boh, int bco, int bci, int bm, int stages, void* stream) {
  const int OH = H + 2 * pad - KH + 1, OW = W + 2 * pad - KW + 1;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(out);
  if (!shape_ok(N, CI, CO, KH, KW, pad, OH, OW, boh, bco, bci) || boh > OH || CI % 4 ||
      CO % 4 || (ptrs & 15) || (bci != 8 && bci != 16 && bci != 32) || stages < 2 ||
      stages > kF32MaxStages)
    return (int)cudaErrorInvalidValue;
  const Args a{x, w, static_cast<const float*>(bias), static_cast<float*>(out), N, H, W, CI, CO,
               KH, KW, pad, OH, OW, boh, bco, bci};
  if (f32_smem(a, bm, bco, stages) > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  return (int)launch_f32_any(bm, bco, a, stages, static_cast<cudaStream_t>(stream));
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
// out[0 .. 3 * cap): dtype 0 float32 with (BM, BN), dtype 1 bfloat16 with
// (MT, NT). Returns their number.
extern "C" int conv2d_instances(int* out, int cap) {
  int n = 0;
  auto add = [&](int d, int p, int q) {
    if (n < cap) { out[3 * n] = d; out[3 * n + 1] = p; out[3 * n + 2] = q; }
    ++n;
  };
#define ELEM(V) V,
  const int f32_bm[] = {CONV_F32_BM(ELEM)}, f32_bn[] = {CONV_F32_BN(ELEM)};
#undef ELEM
  const int mts[3] = {1, 2, 4}, nts[3] = {2, 4, 8};
  for (int bm : f32_bm)
    for (int bn : f32_bn) add(0, bm, bn);
  for (int mt : mts)
    for (int nt : nts) add(1, mt, nt);
  return n;
}

// cudaFuncSetAttribute calls made so far (one per instance launched).
extern "C" int conv2d_attr_calls() { return g_attr_calls; }
