// Fused cost-head statistics for candidate selection, for Hopper (sm_90a).
//
// Replaces the TPU kernel vae_extent_search_tpu/ops/fused_head_pallas.py
// (_body, launched by fused_head_stats through pl.pallas_call). For every
// candidate row x [D] it computes:
//   encoder   h = ReLU MLP(x); z = h . W_mu + b_mu                    [L]
//   cost head a0 = z.W0+b0, h0 = relu(a0); a1 = h0.W1+b1, h1 = relu(a1);
//             cost = h1.w2 + b2
//   gradient  g1 = 1[a1>0] w2; g0 = (W1 g1) 1[a0>0]; gnorm = |W0 g0|
//   MC        T dropout passes on h0 (keep a unit when bits >= thresh,
//             scale kept units by 1/(1-rate)), accumulated centred on
//             cost: mc_mean = cost + s/T, mc_var = (s2 - s^2/T)/(T-1)
// and writes cost, gnorm, mc_mean, mc_var ([N] f32 each).
//
// Bound on an H100: operations. Per candidate the work is ~1 M
// multiply-adds at the main path's widths (D=24, H=256, L=64, T=10),
// against ~100 bytes of input and 16 bytes of output, i.e. ~20k FLOP per
// byte of device memory: far right of the ridge. At N = 262,144 that is
// ~0.51 TFLOP per launch: 7.6 ms at the 67 TFLOP/s f32 CUDA-core peak,
// 0.52 ms at the 989 TFLOP/s bf16 tensor-core peak. 67% of the work is
// the T dropout passes through W1 [H0, H1], and W1 enters 12 of the 18
// products (the forward, the backward through W1^T and the T passes).
//
// Common to both instances: nothing but the input row, the weights and
// the outputs touch device memory. A block owns BM candidates and keeps
// their hidden activations in shared memory for the whole launch, so the
// dropout passes reuse h0 without re-running the encoder or the first
// head layer; the input row streams in 16 features at a time, so any D
// fits. Every layer goes through one product routine per instance, under
// one epilogue contract: epi(r, c, value, i) gets each finished f32 sum,
// i being the thread's local row slot.
//
// float32 (fused_head_kernel<float>): the CUDA cores (tensor cores in f32
// would be TF32, which changes the numbers), bound by their FMA rate.
// Activations live transposed ([feature][candidate]); weight chunks of KC
// rows are staged in shared memory once per block and each thread
// accumulates a 4 x 8 tile in registers (two float4 weight loads and one
// float4 activation load per 32 FMAs). The next chunk's global loads are
// issued into registers before the FMAs over the current one and stored
// after them, so their L2 latency hides behind the FMA loop even when a
// block is alone on its SM (a second shared-memory slot would cost the
// second block per SM: 115,200 bytes at width 256, two blocks per SM).
//
// bfloat16 (fused_head_kernel<__nv_bfloat16>): the tensor cores. On the
// CUDA cores this instance ran as fast as f32 (every bf16 operand widened,
// its products exact in f32). Here every product is mma.sync m16n8k16
// (bf16 in, f32 accumulators in registers): a warp owns 32 output
// columns of a 256-column pass, i.e. 2 x 4 tiles of 16 x 8, over all BM =
// 32 rows; A fragments come from the activation buffers ([candidate]
// [feature], bf16) by ldmatrix, B fragments from [k][n] weight rows by
// ldmatrix.trans or from [n][k] rows by plain ldmatrix. Rows are padded by
// 16 bytes so that the eight addresses of an ldmatrix fall in eight bank
// groups. Once the arithmetic is on the tensor cores, the next limit is
// staging the weights: a block stages 972,800 bf16 weights from L2 for
// its 18 products (1.95 MB, 786,432 of them W1's), ~16 GB per bench-shape
// launch. So W1 is kept resident: it is loaded into shared memory once
// per block, right after the encoder, and serves all 12 of its products
// from that copy: the forward and the T passes read it [k][n] through
// ldmatrix.trans, the backward reads the same copy [n][k] as W1^T without
// .trans, so W1^T is never read. Per block that leaves ~0.5 MB of weights
// from L2, ~4 GB per launch. The other weights stream through a cp.async
// ring of 16-row chunks, one barrier per chunk. At BM = 32 rows a staged
// weight serves only 64 multiply-adds, so these products wait on L2
// unless many chunks are in flight: the encoder's products (before W1 is
// loaded) run the ring NDEEP = 8 stages deep through W1's region; the W0
// product keeps NSTAGE = 3 beside W1. gz (after the backward, the last
// reader of W1) loads W0 whole into W1's region and reads it as W0^T
// without .trans, as the backward reads W1, so w0t is not read either. h0 is kept only in bf16: rnd(h0) for
// the forward and hs = rnd(h0 * scale) for the passes (the reference
// rounds h0 * scale after the multiply), so that a pass's masking is a
// bitwise AND of hs with its keep words, four units per Philox call; a
// unit with h0 > 0 whose h0 * scale rounds to 0 is stored as -0, so the
// backward's mask a0 > 0 is exactly "hs is not +0". Shared memory at the
// bench widths (H 256, L 64): resident W1 [256][264] 135,168 B, three bf16
// activation buffers [32][264] 50,688, the ring 28,416 and the row-sum
// scratch 1,024: 215,296 B of the 232,448 a block may take, one block of 8
// warps per SM. Where W1 does not fit beside the rest (H0 x H1 past ~256 x
// 256) the same routine streams W1 (and W1^T for the backward) through
// the ring; the wrapper chooses the route by shape before the launch
// (ops/fused_head.py::smem_plan). Where the input is wider than the first
// encoder layer's output (the per-store rows: D 820 against 256), a block
// would stage that layer's 420 KB of weights from L2 for its 32 rows, ~3.5
// ms of a 9.1-ms launch at N = 262,144 (PERF.md); there the wrapper runs
// the layer ahead of this kernel as one tensor-core GEMM over all rows
// (ops/fused_head.py::split_first_layer, ops/matmul.py, under the same
// contract: f32 sums, bias, ReLU, one rounding) and launches this kernel
// on its [N, 256] bf16 output with the other layers, so this instance
// runs unchanged. float32 never splits. The backward runs after the passes, so
// that gz finds W1's region free. Measured on an H100 (PERF.md), a pass
// is paced by shared-memory reads (each of the 8 warps reads the whole 32
// x 16 A tile per step beside its B tile) and by Philox's IMADs, the ring
// products by L2, not by the tensor cores. Row sums add
// a thread's partials over the four lanes that share a row, then the 8
// warps' partials in a fixed order, so a launch repeats bit for bit, and
// each row's outputs depend on nothing but that row.
//
// The grid is tiles x G. Where the tiles alone fill the card (the bench
// shape) G = 1 and one launch writes all four outputs. At the main path's
// few hundred candidates the T passes are split over G - 1 pass groups,
// as many as give each block an SM of its own
// (ops/fused_head.py::launch_plan): every group runs the encoder and the
// forward itself (the same code on the same data, so its cost is
// bit-identical to the others') and centres its passes [t_bound[g],
// t_bound[g+1]) on it; group 0 also runs the backward and writes cost and
// gnorm. Each group stores its sums s_g, s2_g to a [G, N] scratch pair and
// mc_finish_kernel adds them in the fixed order g = 0 .. G-1, so a launch
// repeats bit for bit. No atomics.
//
// Numerics follow _body: each matmul operand is rounded to the compute
// dtype at the same points (encoder activations and g0 where they are
// stored, h0 where it enters a product, h0 * scale before masking),
// accumulation and biases are f32, and b2 is never rounded. Dropout bits
// come either from an injected [T, N, H0] uint32 array (candidate-major,
// for exact comparisons) or from Philox 4x32-10 with counter (unit / 4,
// t, candidate) and key = seed, so the bits of a candidate do not depend
// on the launch shape or on the plan.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 32;    // candidates per block
constexpr int NT = 256;   // threads per block: 2 row halves x 4 column quarters
constexpr int KC = 16;    // weight rows staged in shared memory per step
constexpr int CW = 256;   // output columns per pass (4 warps x 64)
constexpr int MAX_ENC = 8;
constexpr int MAX_GROUPS = 32;  // grid rows (ops/fused_head.py::MAX_GROUPS)
constexpr int XPT = KC * BM / NT;  // input features a thread stages per chunk
static_assert(CW == NT, "each thread stages one weight column of a chunk");
static_assert(KC * BM % NT == 0, "the input chunk splits evenly over the threads");

struct Params {
  const void* x;
  long long n;
  int n_enc;
  const void* enc_w[MAX_ENC];
  const float* enc_b[MAX_ENC];
  int enc_dims[MAX_ENC + 1];
  const void* w0;   // [L, H0]
  const void* w1;   // [H0, H1]
  const void* w2;   // [H1]
  const void* w0t;  // [H0, L]
  const void* w1t;  // [H1, H0]
  const float* b0;
  const float* b1;
  const float* b2;  // one f32
  int L, H0, H1, T;
  unsigned int thresh;
  float scale;
  const unsigned int* bits;  // [T, N, H0] or null (Philox)
  unsigned long long seed;
  float* cost;
  float* gnorm;
  float* mean;
  float* var;
  float* s_part;   // [G, N] (G > 1 only)
  float* s2_part;  // [G, N]
  int t_bound[MAX_GROUPS + 1];  // group g runs passes [t_bound[g], t_bound[g+1])
  int width;  // rows of each activation buffer (max hidden width)
  int resident;  // bf16: W1 held in shared memory (else streamed)
};

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// round an f32 value to the compute dtype and back
template <typename T> __device__ __forceinline__ float rnd(float v);
template <> __device__ __forceinline__ float rnd<float>(float v) { return v; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const unsigned hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
  return c;
}

// Input rows read straight from device memory (x [n][K], row-major):
// the launch's first product stages them KC features at a time into an
// activation buffer it does not write, so the input width D never bounds
// shared memory.
template <typename T>
struct GlobalIn {
  const T* x;
  long long n;
  float* buf;  // [KC][BM] staging
};

// out[c][r] (r < BM, c < OUT) of in[k][r] (k < K) times W[k][c] (device
// memory, row-major [K][OUT]); epi(r, c, value, i) gets each finished f32
// sum, i being the thread's local row (0..3). The input is the
// shared-memory buffer `in`, or with GLOBAL the rows of g.x. Activation
// buffers hold values already rounded to the compute dtype, except h0,
// which the MC passes need in f32: ROUND rounds `in` at load. (Both are
// template flags so the common products carry no extra registers.)
//
// Thread tid stages column c0 + tid of each chunk of KC weight rows (and
// XPT of its input features with GLOBAL). The chunk after the current one
// is loaded into registers (in the storage dtype; out-of-range elements
// are zero) before the FMA loop and widened into shared memory after it.
template <typename T, bool ROUND, bool GLOBAL, typename Epi>
__device__ __forceinline__ void tile_mm(const float* __restrict__ in, const GlobalIn<T> g,
                                        int K, const T* __restrict__ W, int OUT,
                                        float* __restrict__ wbuf, Epi&& epi) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp >> 2, wc = warp & 3, rg = lane >> 3, cg = lane & 7;
  const int r0 = wr * 16 + rg * 4;
  const long long n0 = (long long)blockIdx.x * BM;
  for (int c0 = 0; c0 < OUT; c0 += CW) {
    const int c = c0 + tid;
    T wv[KC];
    T xv[GLOBAL ? XPT : 1];
    auto fetch = [&](int k0) {
#pragma unroll
      for (int i = 0; i < KC; ++i)
        wv[i] = (c < OUT && k0 + i < K) ? W[(size_t)(k0 + i) * OUT + c] : T();
      if constexpr (GLOBAL) {
#pragma unroll
        for (int j = 0; j < XPT; ++j) {
          const int e = tid + j * NT, r = e / KC, k = k0 + e % KC;
          xv[j] = (n0 + r < g.n && k < K) ? g.x[(n0 + r) * K + k] : T();
        }
      }
    };
    fetch(0);
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < K; k0 += KC) {
      __syncthreads();  // earlier readers of wbuf (and writers of `in`) done
#pragma unroll
      for (int i = 0; i < KC; ++i) wbuf[i * CW + tid] = to_f<T>(wv[i]);
      if constexpr (GLOBAL) {
#pragma unroll
        for (int j = 0; j < XPT; ++j) {
          const int e = tid + j * NT;
          g.buf[(e % KC) * BM + e / KC] = to_f<T>(xv[j]);
        }
      }
      __syncthreads();
      if (k0 + KC < K) fetch(k0 + KC);  // in flight during the FMAs below
      const int kn = min(KC, K - k0);
      const float* ip = GLOBAL ? g.buf + r0 : in + (size_t)k0 * BM + r0;
      const float* wp = wbuf + wc * 64 + cg * 4;
#pragma unroll 4
      for (int kk = 0; kk < kn; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(ip + kk * BM);
        const float4 b0 = *reinterpret_cast<const float4*>(wp + kk * CW);
        const float4 b1 = *reinterpret_cast<const float4*>(wp + kk * CW + 32);
        const float av[4] = {ROUND ? rnd<T>(a.x) : a.x, ROUND ? rnd<T>(a.y) : a.y,
                             ROUND ? rnd<T>(a.z) : a.z, ROUND ? rnd<T>(a.w) : a.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int cc = c0 + wc * 64 + (j < 4 ? cg * 4 + j : 32 + cg * 4 + (j - 4));
      if (cc < OUT) {
#pragma unroll
        for (int i = 0; i < 4; ++i) epi(r0 + i, cc, acc[i][j], i);
      }
    }
  }
}

// Sum each thread's 4 row partials over the block's column split (lanes
// of a warp, then the 4 column-quarter warps through `red`); thread
// r < BM gets row r's total as the return value.
__device__ __forceinline__ float row_total(float (&part)[4], float* red) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp >> 2, wc = warp & 3, rg = lane >> 3, cg = lane & 7;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float v = part[i];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    v += __shfl_xor_sync(0xffffffffu, v, 4);
    part[i] = v;
  }
  if (cg == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) red[wc * BM + wr * 16 + rg * 4 + i] = part[i];
  }
  __syncthreads();
  float total = 0.f;
  if (tid < BM) total = (red[tid] + red[BM + tid]) + (red[2 * BM + tid] + red[3 * BM + tid]);
  __syncthreads();  // red may be rewritten by the next call
  return total;
}

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores: ldmatrix + mma.sync, W1 resident
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int KP = 8;            // bf16 elements of padding per shared-memory row (16 bytes)
constexpr int KS = 16;           // k rows per mma step and per staged chunk
constexpr int NWARP = NT / 32;   // 8 warps
constexpr int WN = 32;           // output columns of a warp per pass: 4 n-tiles of 8
constexpr int CWB = NWARP * WN;  // 256 output columns per pass
constexpr int CROW = CWB + KP;   // a staged weight chunk's row
constexpr int XROW = KS;         // a staged input chunk's row (unpadded: two steps a launch)
constexpr int NSTAGE = 3;        // ring depth: two chunks in flight behind the one multiplied
constexpr int NDEEP = 8;         // the deep ring's depth (the ring and W1's region)
constexpr int STAGE = KS * CROW + BM * XROW;  // bf16 elements of one ring stage

__host__ __device__ inline int round16(int v) { return (v + 15) / 16 * 16; }

__device__ __forceinline__ bf16 bf16_zero() { return __ushort_as_bfloat16((unsigned short)0); }

// Shared-memory layout of the bf16 instance (byte offsets): three bf16
// activation buffers [BM][lda] (the encoder's ping-pong pair, which then
// holds rnd(h0) or the passes' masked units, and g1; hs = rnd(h0 *
// scale), the passes' source), the row-sum scratch [NWARP][BM] f32, the ring
// (NSTAGE stages of a weight chunk [KS][CROW] and an input chunk
// [BM][XROW]) and, on the resident route, W1 [round16(H0)][w1ld] right
// after it. `deep`: the ring and W1's region together hold NDEEP stages,
// which the encoder's products (before W1 is loaded) use as a deeper
// ring. `w0_resident`: W0 [round16(L)][w0ld] fits W1's region, where gz
// reads it once the backward is done with W1.
struct Bf16Layout {
  int lda, w1ld, w0ld;
  bool deep, w0_resident;
  size_t buf_a, buf_b, hs, red, ring, w1, total;
};

__host__ __device__ inline Bf16Layout bf16_layout(int width, int L, int H0, int H1,
                                                  bool resident) {
  Bf16Layout l;
  l.lda = round16(width) + KP;
  l.w1ld = round16(H1) + KP;
  l.w0ld = round16(H0) + KP;
  const size_t buf = (size_t)2 * BM * l.lda;
  l.buf_a = 0;
  l.buf_b = l.buf_a + buf;
  l.hs = l.buf_b + buf;
  l.red = l.hs + buf;
  l.ring = l.red + (size_t)4 * NWARP * BM;
  l.w1 = l.ring + (size_t)2 * NSTAGE * STAGE;
  l.total = l.w1 + (resident ? (size_t)2 * round16(H0) * l.w1ld : 0);
  l.deep = l.total - l.ring >= (size_t)2 * NDEEP * STAGE;
  // W0 [L][H0] in W1's region for gz (ops/fused_head.py::w0_resident)
  l.w0_resident = resident && round16(L) * l.w0ld <= round16(H0) * l.w1ld;
  return l;
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(ptr)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(ptr)));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A weight [R][C] (device memory, row-major) into a resident image
// [round16(R)][ld] in shared memory, zeros past R and C, as one cp.async
// group (16-byte chunks where C is a multiple of 8, else element copies):
// W1 for its 12 products, and W0 for gz once W1 is done with
__device__ __forceinline__ void load_resident(bf16* dst, const bf16* __restrict__ src, int R,
                                              int C, int ld) {
  const int rows = round16(R), cols = round16(C), tid = threadIdx.x;
  if (C % 8 == 0) {
    const int c8n = cols / 8;
    for (int e = tid; e < rows * c8n; e += NT) {
      const int r = e / c8n, c = (e % c8n) * 8;
      const bool ok = r < R && c < C;
      cp_async16(dst + (size_t)r * ld + c, ok ? src + (size_t)r * C + c : src, ok);
    }
  } else {
    for (int e = tid; e < rows * cols; e += NT) {
      const int r = e / cols, c = e % cols;
      dst[(size_t)r * ld + c] = r < R && c < C ? src[(size_t)r * C + c] : bf16_zero();
    }
  }
  cp_async_commit();
}

// KS weight rows k0.. of W [K][OUT] (device memory, row-major), columns
// c0 .. c0 + CWB, into ws [KS][CROW]; zeros past K and OUT. 16-byte
// cp.async chunks where OUT is a multiple of 8, else element copies.
__device__ __forceinline__ void stage_w(bf16* ws, const bf16* __restrict__ W, int K, int OUT,
                                        int k0, int c0) {
  const int tid = threadIdx.x;
  if (OUT % 8 == 0) {
    for (int e = tid; e < KS * (CWB / 8); e += NT) {
      const int r = e / (CWB / 8), cc = (e % (CWB / 8)) * 8, k = k0 + r, c = c0 + cc;
      const bool ok = k < K && c < OUT;
      cp_async16(ws + r * CROW + cc, ok ? W + (size_t)k * OUT + c : W, ok);
    }
  } else {
    for (int e = tid; e < KS * CWB; e += NT) {
      const int r = e / CWB, cc = e % CWB, k = k0 + r, c = c0 + cc;
      ws[r * CROW + cc] = k < K && c < OUT ? W[(size_t)k * OUT + c] : bf16_zero();
    }
  }
}

// features k0 .. k0 + KS of the block's input rows x [n][K] into xs
// [BM][XROW]; zeros past n and K (rows need not be 16-byte aligned)
__device__ __forceinline__ void stage_x(bf16* xs, const bf16* __restrict__ x, long long n,
                                        int K, int k0) {
  const long long n0 = (long long)blockIdx.x * BM;
  for (int e = threadIdx.x; e < BM * KS; e += NT) {
    const int r = e / KS, kk = e % KS, k = k0 + kk;
    xs[r * XROW + kk] = n0 + r < n && k < K ? x[(n0 + r) * K + k] : bf16_zero();
  }
}

// nk chunk steps through a ring of DEPTH stages: stage(s, ks) issues
// chunk ks into stage s, run(s, ks) multiplies it. One cp.async group per
// step (empty past the end), so that at step ks wait_group DEPTH - 2
// leaves the DEPTH - 2 chunks after ks in flight; one barrier a step
// (every warp is then done with the stage the next load overwrites). A
// thread issues its share of the next chunk after its products, where a
// full load queue stalls it beside the other warps' products (measured on
// an H100: ~0.1 ms less at the bench shape than issuing before them).
template <int DEPTH, typename Stage, typename Run>
__device__ __forceinline__ void ring_loop(int nk, Stage&& stage, Run&& run) {
  for (int s = 0; s < DEPTH - 1; ++s) {
    if (s < nk) stage(s, s);
    cp_async_commit();
  }
  for (int ks = 0; ks < nk; ++ks) {
    cp_async_wait<DEPTH - 2>();
    __syncthreads();
    run(ks % DEPTH, ks);
    if (ks + DEPTH - 1 < nk) stage((ks + DEPTH - 1) % DEPTH, ks + DEPTH - 1);
    cp_async_commit();
  }
}

// where a product's operands come from
enum Route {
  RING = 0,    // A in shared memory (or x, GLOBAL), B streamed through the ring from W [K][OUT]
  RES_KN = 1,  // A in shared memory, B = resident W1 read [k][n] (the forward and the passes)
  RES_NK = 2,  // A in shared memory, B = W1^T: the resident copy read [n][k] (the backward)
};

// the ring (NSTAGE stages, or NDEEP where `deep`) and W1's resident copy
struct Stages {
  bf16* ring;
  const bf16* w1s;
  int w1ld;
};

// out[r][c] (r < BM, c < OUT) of A[r][k] (k < K) times B[k][c]; epi(r, c,
// value, i, j) gets each finished f32 sum, i = 2 m-tile + half being the
// thread's row slot (row 16 (i >> 1) + 8 (i & 1) + lane / 4) and j = 2
// n-tile + e its column slot (column c0 + 32 warp + 8 (j >> 1) + 2 (lane &
// 3) + (j & 1) of pass c0). A is the bf16 buffer `a` of row length lda
// (columns past K are zeroed here) or, with GLOBAL, the block's rows of x.
// Warp w computes columns c0 + 32 w .. of each 256-column pass: 2 x 4
// tiles, A by ldmatrix, B by ldmatrix (.trans from [k][n] rows). On the
// ring route each 16-row step stages a chunk NSTAGE - 1 (or NDEEP - 1)
// steps ahead by cp.async while the current one is multiplied: at BM =
// 32 rows a staged weight is used 64 times, so these products wait on L2
// unless many chunks are in flight. On the resident routes the k loop has
// no barrier.
template <int ROUTE, bool GLOBAL, typename Epi>
__device__ __forceinline__ void mma_mm(bf16* a, int lda, const bf16* __restrict__ x, long long n,
                                       int K, const bf16* __restrict__ W, int OUT,
                                       const Stages& sm, bool deep, Epi&& epi) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int nk = (K + KS - 1) / KS;
  // lane's ldmatrix rows: A row (lane & 15) at column 8 (lane >> 4); B
  // [k][n]: k row (lane & 7) + 8 ((lane >> 3) & 1) at column 8 (lane >> 4);
  // B [n][k]: n row (lane & 7) + 8 (lane >> 4) at k column 8 ((lane >> 3) & 1)
  const int a_off = (lane & 15) * (GLOBAL ? XROW : lda) + (lane >> 4) * 8;
  const int bkn_row = (lane & 7) + ((lane >> 3) & 1) * 8, bkn_col = (lane >> 4) * 8;
  const int bnk_row = (lane & 7) + (lane >> 4) * 8, bnk_col = ((lane >> 3) & 1) * 8;
  for (int c0 = 0; c0 < OUT; c0 += CWB) {
    const int wc = c0 + warp * WN;  // the warp's first column
    float acc[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
    // one 16-deep step: A at column ka of `ab` (row length ald), B rows
    // from kb of `bb` (row length bld; [n][k] with NK), columns from bc
    auto step = [&](const bf16* ab, int ka, const bf16* bb, int bld, int kb, int bc, bool NK) {
      uint32_t af[2][4];
      const int ald = GLOBAL ? XROW : lda;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) ldmatrix_x4(af[mt], ab + a_off + mt * 16 * ald + ka);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        if (wc + np * 16 >= OUT) break;
        uint32_t r[4];
        if (NK)
          ldmatrix_x4(r, bb + (size_t)(bc + np * 16 + bnk_row) * bld + kb + bnk_col);
        else
          ldmatrix_x4_trans(r, bb + (size_t)(kb + bkn_row) * bld + bc + np * 16 + bkn_col);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * np], af[mt], r[0], r[1]);
          mma_bf16(acc[mt][2 * np + 1], af[mt], r[2], r[3]);
        }
      }
    };
    __syncthreads();  // earlier readers of the ring (and writers of `a`) done
    if (!GLOBAL && K % KS && c0 == 0) {
      const int tail = round16(K) - K;
      for (int e = tid; e < BM * tail; e += NT) a[(e / tail) * lda + K + e % tail] = bf16_zero();
      if (ROUTE != RING) __syncthreads();
    }
    if (ROUTE == RING) {
      auto stage = [&](int s, int ks) {
        bf16* st = sm.ring + s * STAGE;
        stage_w(st, W, K, OUT, ks * KS, c0);
        if (GLOBAL) stage_x(st + KS * CROW, x, n, K, ks * KS);
      };
      auto run = [&](int s, int ks) {
        const bf16* st = sm.ring + s * STAGE;
        if (wc >= OUT) return;
        if (GLOBAL)
          step(st + KS * CROW, 0, st, CROW, 0, warp * WN, false);
        else
          step(a, ks * KS, st, CROW, 0, warp * WN, false);
      };
      if (deep)
        ring_loop<NDEEP>(nk, stage, run);
      else
        ring_loop<NSTAGE>(nk, stage, run);
    } else if (wc + WN <= OUT) {
      // all 32 of the warp's columns: the fragments of step ks + 1 are
      // loaded while step ks multiplies
      uint32_t af[2][2][4], bfr[2][2][4];
      auto load = [&](int buf, int ks) {
        const bf16* ab = a + a_off + ks * KS;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) ldmatrix_x4(af[buf][mt], ab + mt * 16 * lda);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          if (ROUTE == RES_NK)
            ldmatrix_x4(bfr[buf][np], sm.w1s + (size_t)(wc + np * 16 + bnk_row) * sm.w1ld +
                                          ks * KS + bnk_col);
          else
            ldmatrix_x4_trans(bfr[buf][np], sm.w1s + (size_t)(ks * KS + bkn_row) * sm.w1ld +
                                                wc + np * 16 + bkn_col);
        }
      };
      auto mul = [&](int buf) {
#pragma unroll
        for (int np = 0; np < 2; ++np)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_bf16(acc[mt][2 * np], af[buf][mt], bfr[buf][np][0], bfr[buf][np][1]);
            mma_bf16(acc[mt][2 * np + 1], af[buf][mt], bfr[buf][np][2], bfr[buf][np][3]);
          }
      };
      load(0, 0);
      for (int ks = 0; ks < nk; ks += 2) {
        if (ks + 1 < nk) load(1, ks + 1);
        mul(0);
        if (ks + 1 < nk) {
          if (ks + 2 < nk) load(0, ks + 2);
          mul(1);
        }
      }
    } else if (wc < OUT) {
      for (int ks = 0; ks < nk; ++ks)
        step(a, ks * KS, sm.w1s, sm.w1ld, ks * KS, wc, ROUTE == RES_NK);
    }
    // column by column (a lambda's per-column loads are then made once for
    // its four rows); no bounds check where all 32 columns are in range
    auto finish = [&](bool all) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = wc + nt * 8 + tg * 2 + e;
          if (all || c < OUT) {
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int h = 0; h < 2; ++h)
                epi(mt * 16 + h * 8 + g, c, acc[mt][nt][2 * h + e], 2 * mt + h, 2 * nt + e);
          }
        }
    };
    if (wc + WN <= OUT)
      finish(true);
    else if (wc < OUT)
      finish(false);
  }
}

// Sum each thread's 4 row-slot partials over the 4 lanes that share its
// rows, then the 8 warps' partials through `red` in a fixed order; thread
// r < BM gets row r's total as the return value.
__device__ __forceinline__ float mma_row_total(float (&part)[4], float* red) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float v = part[i];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    part[i] = v;
  }
  if ((lane & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) red[warp * BM + (i >> 1) * 16 + (i & 1) * 8 + (lane >> 2)] = part[i];
  }
  __syncthreads();
  float total = 0.f;
  if (tid < BM) {
    const float* q = red + tid;
    total = ((q[0] + q[BM]) + (q[2 * BM] + q[3 * BM])) +
            ((q[4 * BM] + q[5 * BM]) + (q[6 * BM] + q[7 * BM]));
  }
  __syncthreads();  // red may be rewritten by the next call
  return total;
}

// The bf16 instance's body (see the header): the products of
// fused_head_kernel<float>, on the tensor cores; the backward runs after
// the passes, so that its gz product finds W1's region free for the deep
// ring.
__device__ __forceinline__ void mma_head(const Params& p) {
  extern __shared__ __align__(16) unsigned char smb[];
  const bool resident = p.resident;
  const Bf16Layout lay = bf16_layout(p.width, p.L, p.H0, p.H1, resident);
  const int lda = lay.lda;
  bf16* bufA = reinterpret_cast<bf16*>(smb + lay.buf_a);
  bf16* bufB = reinterpret_cast<bf16*>(smb + lay.buf_b);
  bf16* hs = reinterpret_cast<bf16*>(smb + lay.hs);
  float* red = reinterpret_cast<float*>(smb + lay.red);
  bf16* w1s = reinterpret_cast<bf16*>(smb + lay.w1);
  const Stages sm{reinterpret_cast<bf16*>(smb + lay.ring), w1s, lay.w1ld};
  const bf16* x = static_cast<const bf16*>(p.x);
  const bf16* w1 = static_cast<const bf16*>(p.w1);
  const bf16* w2 = static_cast<const bf16*>(p.w2);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long n0 = (long long)blockIdx.x * BM;
  const int group = blockIdx.y;

  // encoder: ReLU after every layer but fc_mu (the last); the first layer
  // reads x from device memory, the rest ping-pong bufA / bufB; W1 is not
  // loaded yet, so the deep ring may use its region
  bf16* cur = nullptr;
  for (int l = 0; l < p.n_enc; ++l) {
    const bool last = l == p.n_enc - 1;
    const float* b = p.enc_b[l];
    bf16* out = (l & 1) ? bufB : bufA;
    const bf16* w = static_cast<const bf16*>(p.enc_w[l]);
    auto epi = [&](int r, int c, float v, int, int) {
      const float y = v + __ldg(b + c);
      out[r * lda + c] = __float2bfloat16_rn(last ? y : fmaxf(y, 0.f));
    };
    if (l == 0)
      mma_mm<RING, true>(nullptr, lda, x, p.n, p.enc_dims[0], w, p.enc_dims[1], sm, lay.deep,
                         epi);
    else
      mma_mm<RING, false>(cur, lda, x, p.n, p.enc_dims[l], w, p.enc_dims[l + 1], sm, lay.deep,
                          epi);
    cur = out;
  }
  // W1 into its resident copy, one cp.async group ahead of the W0
  // product's chunks (every warp is past the encoder's deep ring first)
  __syncthreads();
  if (resident) load_resident(w1s, w1, p.H0, p.H1, lay.w1ld);
  // z = cur [BM][L] (x itself without an encoder); h0 = relu(z W0 + b0)
  // is kept twice in bf16: rnd(h0), the forward's operand, in the buffer
  // z does not use, and hs = rnd(h0 * scale), which the passes mask. A
  // unit with h0 > 0 whose h0 * scale rounds to 0 is stored as -0, so that
  // the nonzero bits of hs are exactly the units with a0 > 0 (-0 adds
  // nothing to a product).
  bf16* hb = cur == bufA ? bufB : bufA;
  bf16* gb = hb == bufA ? bufB : bufA;
  auto epi_h0 = [&](int r, int c, float v, int, int) {
    const float h = fmaxf(v + __ldg(p.b0 + c), 0.f);
    const bf16 sv = __float2bfloat16_rn(h * p.scale);
    hb[r * lda + c] = __float2bfloat16_rn(h);
    hs[r * lda + c] = h > 0.f && __bfloat16_as_ushort(sv) == 0
                          ? __ushort_as_bfloat16((unsigned short)0x8000)
                          : sv;
  };
  const bf16* w0 = static_cast<const bf16*>(p.w0);
  if (p.n_enc)
    mma_mm<RING, false>(cur, lda, x, p.n, p.L, w0, p.H0, sm, false, epi_h0);
  else
    mma_mm<RING, true>(nullptr, lda, x, p.n, p.L, w0, p.H0, sm, false, epi_h0);
  cp_async_wait<0>();  // the next product's first barrier publishes W1's copy

  const float b2 = *p.b2;
  float part[4] = {0.f, 0.f, 0.f, 0.f};
  // a1 = rnd(h0) W1 + b1: cost partials, and g1 = 1[a1>0] w2 into gb
  auto epi_a1 = [&](int r, int c, float v, int i, int) {
    const float a1 = v + __ldg(p.b1 + c);
    const bf16 w2c = w2[c];
    part[i] = fmaf(rnd<bf16>(fmaxf(a1, 0.f)), __bfloat162float(w2c), part[i]);
    gb[r * lda + c] = a1 > 0.f ? w2c : bf16_zero();
  };
  if (resident)
    mma_mm<RES_KN, false>(hb, lda, x, p.n, p.H0, w1, p.H1, sm, false, epi_a1);
  else
    mma_mm<RING, false>(hb, lda, x, p.n, p.H0, w1, p.H1, sm, false, epi_a1);
  const float cost = mma_row_total(part, red) + b2;

  // this group's MC-dropout passes on hs; pass t's masked units go into
  // hb, which the forward is done with (g1 waits in gb); thread r < BM
  // accumulates row r. Where H1 is one 256-column pass, b1 and w2 at the
  // thread's columns stay in registers.
  bf16* hd = hb;
  float b1r[8], w2r[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = warp * WN + (j >> 1) * 8 + (lane & 3) * 2 + (j & 1);
    b1r[j] = c < p.H1 ? __ldg(p.b1 + c) : 0.f;
    w2r[j] = c < p.H1 ? __bfloat162float(w2[c]) : 0.f;
  }
  auto epi_mc = [&](int, int, float v, int i, int j) {
    part[i] = fmaf(rnd<bf16>(fmaxf(v + b1r[j], 0.f)), w2r[j], part[i]);
  };
  auto epi_mc_wide = [&](int, int c, float v, int i, int) {
    part[i] =
        fmaf(rnd<bf16>(fmaxf(v + __ldg(p.b1 + c), 0.f)), __bfloat162float(w2[c]), part[i]);
  };
  // the thread's first (row, unit quad) of the Philox masks and its
  // stride, without a division in the loop
  const int quads = (p.H0 + 3) / 4;
  const int r_first = tid / quads, q_first = tid - r_first * quads;
  const int dr = NT / quads, dq = NT - dr * quads;
  float s = 0.f, s2 = 0.f;
  // (the last barrier of the row sums before each pass leaves hd, or
  // rnd(h0), with no reader)
  for (int t = p.t_bound[group]; t < p.t_bound[group + 1]; ++t) {
    // a unit keeps hs where its word is >= thresh
    if (p.bits) {
      for (int e = tid; e < BM * p.H0; e += NT) {
        const int r = e / p.H0, u = e % p.H0;
        const long long n = n0 + r;
        const unsigned bit = n < p.n ? p.bits[((long long)t * p.n + n) * p.H0 + u] : 0u;
        hd[r * lda + u] = bit >= p.thresh ? hs[r * lda + u] : bf16_zero();
      }
    } else {
      const uint2 key = make_uint2((unsigned)p.seed, (unsigned)(p.seed >> 32));
      for (int r = r_first, q4 = q_first; r < BM;) {
        const int u = 4 * q4;
        const unsigned long long n = (unsigned long long)(n0 + r);
        const uint4 b = philox4x32_10(
            make_uint4((unsigned)q4, (unsigned)t, (unsigned)n, (unsigned)(n >> 32)), key);
        const uint2 hv = *reinterpret_cast<const uint2*>(hs + r * lda + u);
        // the two bytes of each unit kept (and below H0) survive
        const unsigned k0 = (u < p.H0 && b.x >= p.thresh ? 0x0000FFFFu : 0u) |
                            (u + 1 < p.H0 && b.y >= p.thresh ? 0xFFFF0000u : 0u);
        const unsigned k1 = (u + 2 < p.H0 && b.z >= p.thresh ? 0x0000FFFFu : 0u) |
                            (u + 3 < p.H0 && b.w >= p.thresh ? 0xFFFF0000u : 0u);
        *reinterpret_cast<uint2*>(hd + r * lda + u) = make_uint2(hv.x & k0, hv.y & k1);
        q4 += dq;
        r += dr;
        if (q4 >= quads) {
          q4 -= quads;
          ++r;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) part[i] = 0.f;
    if (resident && p.H1 <= CWB)
      mma_mm<RES_KN, false>(hd, lda, x, p.n, p.H0, w1, p.H1, sm, false, epi_mc);
    else if (resident)
      mma_mm<RES_KN, false>(hd, lda, x, p.n, p.H0, w1, p.H1, sm, false, epi_mc_wide);
    else
      mma_mm<RING, false>(hd, lda, x, p.n, p.H0, w1, p.H1, sm, false, epi_mc_wide);
    const float dt = (mma_row_total(part, red) + b2) - cost;
    s += dt;
    s2 = fmaf(dt, dt, s2);
  }

  float gnorm = 0.f;
  if (group == 0) {
    // g0 = (g1 W1^T) 1[a0 > 0], into hb (a0 > 0 where hs is nonzero)
    auto epi_g0 = [&](int r, int c, float v, int, int) {
      hb[r * lda + c] =
          __bfloat16_as_ushort(hs[r * lda + c]) ? __float2bfloat16_rn(v) : bf16_zero();
    };
    if (resident)
      mma_mm<RES_NK, false>(gb, lda, x, p.n, p.H1, w1, p.H0, sm, false, epi_g0);
    else
      mma_mm<RING, false>(gb, lda, x, p.n, p.H1, static_cast<const bf16*>(p.w1t), p.H0, sm,
                          false, epi_g0);
    // gz = g0 W0^T; gnorm = |gz|. Where it fits, W0 [L][H0] goes into
    // W1's region in one piece (every warp is done with W1 first) and is
    // read as W0^T [n][k]; else W0^T streams through the ring.
#pragma unroll
    for (int i = 0; i < 4; ++i) part[i] = 0.f;
    auto epi_gz = [&](int, int, float v, int i, int) { part[i] = fmaf(v, v, part[i]); };
    if (lay.w0_resident) {
      __syncthreads();
      load_resident(w1s, static_cast<const bf16*>(p.w0), p.L, p.H0, lay.w0ld);
      cp_async_wait<0>();  // the product's first barrier publishes W0's copy
      mma_mm<RES_NK, false>(hb, lda, x, p.n, p.H0, nullptr, p.L,
                            Stages{sm.ring, w1s, lay.w0ld}, false, epi_gz);
    } else {
      mma_mm<RING, false>(hb, lda, x, p.n, p.H0, static_cast<const bf16*>(p.w0t), p.L, sm,
                          lay.deep, epi_gz);
    }
    gnorm = sqrtf(mma_row_total(part, red));
  }

  if (tid < BM && n0 + tid < p.n) {
    const long long n = n0 + tid;
    if (gridDim.y == 1) {
      const float T_ = (float)p.T;
      p.cost[n] = cost;
      p.gnorm[n] = gnorm;
      p.mean[n] = cost + s / T_;
      p.var[n] = p.T > 1 ? (s2 - s * s / T_) / (T_ - 1.f) : 0.f;
    } else {
      if (group == 0) {
        p.cost[n] = cost;
        p.gnorm[n] = gnorm;
      }
      p.s_part[(long long)group * p.n + n] = s;
      p.s2_part[(long long)group * p.n + n] = s2;
    }
  }
}

// blocks per SM each instance is compiled for: two of the f32 instance's
// 115,200-byte blocks fit an SM, one of the bf16 instance's
template <typename T> struct MinBlocks { static constexpr int value = 2; };
template <> struct MinBlocks<__nv_bfloat16> { static constexpr int value = 1; };

template <typename T>
__global__ void __launch_bounds__(NT, MinBlocks<T>::value) fused_head_kernel(const Params p) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    mma_head(p);
  } else {
  extern __shared__ __align__(16) float sm[];
  const int W = p.width;
  float* bufA = sm;
  float* bufB = bufA + (size_t)W * BM;
  float* h0 = bufB + (size_t)W * BM;
  float* wbuf = h0 + (size_t)W * BM;
  float* red = wbuf + KC * CW;
  const GlobalIn<T> none{nullptr, 0, nullptr};
  // x stages through an activation buffer the first product does not
  // write (an extra buffer would cost the second block per SM)
  const GlobalIn<T> xin{static_cast<const T*>(p.x), p.n, p.n_enc ? bufB : bufA};
  const int tid = threadIdx.x;
  const long long n0 = (long long)blockIdx.x * BM;
  const int group = blockIdx.y;

  // encoder: ReLU after every layer but fc_mu (the last); the first
  // layer reads x from device memory, the rest ping-pong bufA/bufB
  const float* cur = nullptr;
  for (int l = 0; l < p.n_enc; ++l) {
    const bool last = l == p.n_enc - 1;
    const float* b = p.enc_b[l];
    float* out = (l & 1) ? bufB : bufA;
    const T* w = static_cast<const T*>(p.enc_w[l]);
    auto epi = [&](int r, int c, float v, int) {
      const float y = v + b[c];
      out[c * BM + r] = rnd<T>(last ? y : fmaxf(y, 0.f));
    };
    if (l == 0)
      tile_mm<T, false, true>(cur, xin, p.enc_dims[l], w, p.enc_dims[l + 1], wbuf, epi);
    else
      tile_mm<T, false, false>(cur, none, p.enc_dims[l], w, p.enc_dims[l + 1], wbuf, epi);
    cur = out;
  }
  // z = cur [L][BM] (x itself without an encoder); h0 = relu(z W0 + b0)
  auto epi_h0 = [&](int r, int c, float v, int) { h0[c * BM + r] = fmaxf(v + p.b0[c], 0.f); };
  if (p.n_enc)
    tile_mm<T, false, false>(cur, none, p.L, static_cast<const T*>(p.w0), p.H0, wbuf, epi_h0);
  else
    tile_mm<T, false, true>(cur, xin, p.L, static_cast<const T*>(p.w0), p.H0, wbuf, epi_h0);

  const T* w2 = static_cast<const T*>(p.w2);
  const float b2 = *p.b2;
  float part[4] = {0.f, 0.f, 0.f, 0.f};
  // a1 = h0 W1 + b1: cost partials, and g1 = 1[a1>0] w2 (z is dead)
  float* g1 = bufA;
  tile_mm<T, true, false>(h0, none, p.H0, static_cast<const T*>(p.w1), p.H1, wbuf,
             [&](int r, int c, float v, int i) {
               const float a1 = v + p.b1[c];
               const float w2c = to_f<T>(w2[c]);
               part[i] = fmaf(rnd<T>(fmaxf(a1, 0.f)), w2c, part[i]);
               g1[c * BM + r] = a1 > 0.f ? w2c : 0.f;
             });
  const float cost = row_total(part, red) + b2;

  float gnorm = 0.f;
  if (group == 0) {
    // g0 = (g1 W1^T) 1[a0 > 0]
    float* g0 = bufB;
    tile_mm<T, false, false>(g1, none, p.H1, static_cast<const T*>(p.w1t), p.H0, wbuf,
               [&](int r, int c, float v, int) {
                 g0[c * BM + r] = h0[c * BM + r] > 0.f ? rnd<T>(v) : 0.f;
               });
    // gz = g0 W0^T; gnorm = |gz|
#pragma unroll
    for (int i = 0; i < 4; ++i) part[i] = 0.f;
    tile_mm<T, false, false>(g0, none, p.H0, static_cast<const T*>(p.w0t), p.L, wbuf,
               [&](int r, int c, float v, int i) { part[i] = fmaf(v, v, part[i]); });
    gnorm = sqrtf(row_total(part, red));
  }

  // this group's MC-dropout passes on h0; thread r < BM accumulates row r
  float s = 0.f, s2 = 0.f;
  float* hd = bufB;
  const int quads = (p.H0 + 3) / 4;
  for (int t = p.t_bound[group]; t < p.t_bound[group + 1]; ++t) {
    __syncthreads();  // readers of hd (or g0) from before are done
    if (p.bits) {
      for (int e = tid; e < BM * p.H0; e += NT) {
        const int r = e / p.H0, u = e % p.H0;
        const long long n = n0 + r;
        const unsigned bit = n < p.n ? p.bits[((long long)t * p.n + n) * p.H0 + u] : 0u;
        hd[u * BM + r] = bit >= p.thresh ? rnd<T>(h0[u * BM + r] * p.scale) : 0.f;
      }
    } else {
      const uint2 key = make_uint2((unsigned)p.seed, (unsigned)(p.seed >> 32));
      for (int e = tid; e < BM * quads; e += NT) {
        const int r = e % BM, q4 = e / BM;
        const unsigned long long n = (unsigned long long)(n0 + r);
        const uint4 b = philox4x32_10(
            make_uint4((unsigned)q4, (unsigned)t, (unsigned)n, (unsigned)(n >> 32)), key);
        const unsigned bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int u = 4 * q4 + q;
          if (u < p.H0)
            hd[u * BM + r] = bv[q] >= p.thresh ? rnd<T>(h0[u * BM + r] * p.scale) : 0.f;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) part[i] = 0.f;
    tile_mm<T, false, false>(hd, none, p.H0, static_cast<const T*>(p.w1), p.H1, wbuf,
               [&](int r, int c, float v, int i) {
                 part[i] = fmaf(rnd<T>(fmaxf(v + p.b1[c], 0.f)), to_f<T>(w2[c]), part[i]);
               });
    const float dt = (row_total(part, red) + b2) - cost;
    s += dt;
    s2 = fmaf(dt, dt, s2);
  }

  if (tid < BM && n0 + tid < p.n) {
    const long long n = n0 + tid;
    if (gridDim.y == 1) {
      const float T_ = (float)p.T;
      p.cost[n] = cost;
      p.gnorm[n] = gnorm;
      p.mean[n] = cost + s / T_;
      p.var[n] = p.T > 1 ? (s2 - s * s / T_) / (T_ - 1.f) : 0.f;
    } else {
      if (group == 0) {
        p.cost[n] = cost;
        p.gnorm[n] = gnorm;
      }
      p.s_part[(long long)group * p.n + n] = s;
      p.s2_part[(long long)group * p.n + n] = s2;
    }
  }
  }
}

// mean and var of candidate n from the G groups' sums, added in the order
// g = 0 .. G-1 (ops/fused_head.py::mc_finish_plain)
__global__ void mc_finish_kernel(const float* __restrict__ cost,
                                 const float* __restrict__ s_part,
                                 const float* __restrict__ s2_part, long long n, int groups,
                                 int T, float* __restrict__ mean, float* __restrict__ var) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f, s2 = 0.f;
  for (int g = 0; g < groups; ++g) {
    s += s_part[g * n + i];
    s2 += s2_part[g * n + i];
  }
  const float T_ = (float)T;
  mean[i] = cost[i] + s / T_;
  var[i] = T > 1 ? (s2 - s * s / T_) / (T_ - 1.f) : 0.f;
}

size_t smem_bytes(int width) {
  return sizeof(float) * ((size_t)3 * width * BM + KC * CW + 4 * BM);
}

int g_attr_calls = 0;  // cudaFuncSetAttribute calls made

// the most shared memory a launch may ask for (it asks for what it uses),
// and the L1/shared split, set once per instance
template <typename T>
cudaError_t set_attributes_once() {
  static bool done = false;
  if (done) return cudaSuccess;
  g_attr_calls += 2;
  cudaError_t err = cudaFuncSetAttribute(
      fused_head_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fused_head_kernel<T>,
                             cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  done = err == cudaSuccess;
  return err;
}

}  // namespace

// shared memory per block of the f32 instance: three [width][BM]
// activation buffers, the weight chunk and the row-reduction scratch
// (115,200 bytes at width 256: two blocks per SM)
extern "C" size_t fused_head_smem_bytes(int width) { return smem_bytes(width); }

// shared memory per block of the bf16 instance at the largest hidden
// width `width` (rounded up to 4, as the launch rounds it), on the
// resident route (W1 in shared memory) or the streamed one
// (ops/fused_head.py::smem_plan mirrors it)
extern "C" size_t fused_head_bf16_smem_bytes(int width, int H0, int H1, int resident) {
  return bf16_layout(width, 16, H0, H1, resident != 0).total;
}

// whether the bf16 instance reads W0 from shared memory for gz (and so no
// w0t): ops/fused_head.py::w0_resident mirrors it
extern "C" int fused_head_bf16_w0_resident(int L, int H0, int H1, int resident) {
  return bf16_layout(16, L, H0, H1, resident != 0).w0_resident;
}

extern "C" int fused_head_attr_calls() { return g_attr_calls; }

// Launch on `stream`; returns cudaGetLastError() (0 on success). Host
// arrays enc_w/enc_b hold n_enc device pointers, enc_dims n_enc + 1
// widths. The grid has `groups` rows; group g runs passes [t_bound[g],
// t_bound[g + 1]). With groups > 1, s_part and s2_part hold groups * n
// f32 each and mc_finish_kernel writes mean and var after the kernel.
// bf16 takes W1's route from the caller (`resident`: 1 keeps W1 in shared
// memory and reads no w1t, nor w0t where W0 fits W1's region; 0 streams
// W1, w1t and w0t); a route whose shared memory exceeds a block's is
// refused. f32 takes resident = 0.
extern "C" int fused_head_stats_launch(
    int bf16, const void* x, long long n, int d, int n_enc, const void* const* enc_w,
    const void* const* enc_b, const int* enc_dims, const void* w0, const void* b0,
    const void* w1, const void* b1, const void* w2, const void* b2, const void* w0t,
    const void* w1t, int L, int H0, int H1, int T, unsigned int thresh, float scale,
    const void* bits, unsigned long long seed, int groups, const int* t_bound, void* s_part,
    void* s2_part, void* cost, void* gnorm, void* mean, void* var, int resident, void* stream) {
  if (n_enc < 0 || n_enc > MAX_ENC || n <= 0 || groups < 1 || groups > MAX_GROUPS)
    return (int)cudaErrorInvalidValue;
  if (t_bound[0] != 0 || t_bound[groups] != T) return (int)cudaErrorInvalidValue;
  if (groups > 1 && (!s_part || !s2_part)) return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x;
  p.n = n;
  p.n_enc = n_enc;
  int width = L > H0 ? L : H0;
  width = width > H1 ? width : H1;
  for (int i = 0; i < n_enc; ++i) {
    p.enc_w[i] = enc_w[i];
    p.enc_b[i] = static_cast<const float*>(enc_b[i]);
    p.enc_dims[i] = enc_dims[i];
    width = width > enc_dims[i + 1] ? width : enc_dims[i + 1];
  }
  if (n_enc) p.enc_dims[n_enc] = enc_dims[n_enc];
  else if (d != L) return (int)cudaErrorInvalidValue;  // x is z itself
  p.w0 = w0;
  p.w1 = w1;
  p.w2 = w2;
  p.w0t = w0t;
  p.w1t = w1t;
  p.b0 = static_cast<const float*>(b0);
  p.b1 = static_cast<const float*>(b1);
  p.b2 = static_cast<const float*>(b2);
  p.L = L;
  p.H0 = H0;
  p.H1 = H1;
  p.T = T;
  p.thresh = thresh;
  p.scale = scale;
  p.bits = static_cast<const unsigned int*>(bits);
  p.seed = seed;
  p.cost = static_cast<float*>(cost);
  p.gnorm = static_cast<float*>(gnorm);
  p.mean = static_cast<float*>(mean);
  p.var = static_cast<float*>(var);
  p.s_part = static_cast<float*>(s_part);
  p.s2_part = static_cast<float*>(s2_part);
  for (int g = 0; g <= MAX_GROUPS; ++g) p.t_bound[g] = g <= groups ? t_bound[g] : T;
  for (int g = 0; g < groups; ++g)
    if (p.t_bound[g] > p.t_bound[g + 1]) return (int)cudaErrorInvalidValue;
  width = width > KC ? width : KC;  // a buffer also stages KC input features
  p.width = (width + 3) / 4 * 4;
  p.resident = resident;
  if (!bf16 && resident) return (int)cudaErrorInvalidValue;
  if (bf16 && !resident && !w1t) return (int)cudaErrorInvalidValue;
  if (!w0t && !(bf16 && bf16_layout(p.width, L, H0, H1, resident != 0).w0_resident))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      bf16 ? bf16_layout(p.width, L, H0, H1, resident != 0).total : smem_bytes(p.width);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n + BM - 1) / BM), (unsigned)groups);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16) {
    err = set_attributes_once<__nv_bfloat16>();
    if (err != cudaSuccess) return (int)err;
    fused_head_kernel<__nv_bfloat16><<<grid, NT, smem, s>>>(p);
  } else {
    err = set_attributes_once<float>();
    if (err != cudaSuccess) return (int)err;
    fused_head_kernel<float><<<grid, NT, smem, s>>>(p);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || groups == 1) return (int)err;
  mc_finish_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      p.cost, p.s_part, p.s2_part, n, groups, T, p.mean, p.var);
  return (int)cudaGetLastError();
}
