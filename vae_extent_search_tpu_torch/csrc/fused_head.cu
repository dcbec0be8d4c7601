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
// byte of device memory — far right of the ridge. At N = 262,144 that is
// ~0.51 TFLOP per launch: ~7.6 ms at the 67 TFLOP/s f32 CUDA-core peak.
//
// What the design does about it: nothing but the input row and the
// outputs touch device memory. A block owns BM candidates; their hidden
// activations live transposed ([feature][candidate]) in shared memory for
// the whole launch, so the dropout passes reuse h0 without re-running
// the encoder or the first head layer (the input row streams in KC
// features at a time, so any D fits; hidden widths up to ~560 fit, the
// wrapper checks). Every layer is the same register-blocked product:
// weight chunks of KC rows are staged in shared memory once per block and
// each thread accumulates a 4 x 8 tile in registers (two float4 weight
// loads and one float4 activation load per 32 FMAs). The next chunk's
// global loads are issued into registers before the FMAs over the current
// one and stored after them, so their L2 latency hides behind the FMA
// loop even when a block is alone on its SM (a second shared-memory slot
// would cost the second block per SM). The arithmetic is f32 FMA on the
// CUDA cores in both dtypes: bf16 operands are widened (their products
// are exact in f32), which reproduces the reference's bf16-in /
// f32-accumulate numerics.
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

template <typename T>
__global__ void __launch_bounds__(NT, 2) fused_head_kernel(const Params p) {
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

// shared memory per block: three [width][BM] activation buffers, the
// weight chunk and the row-reduction scratch (115,200 bytes at width 256:
// two blocks per SM)
extern "C" size_t fused_head_smem_bytes(int width) { return smem_bytes(width); }

extern "C" int fused_head_attr_calls() { return g_attr_calls; }

// Launch on `stream`; returns cudaGetLastError() (0 on success). Host
// arrays enc_w/enc_b hold n_enc device pointers, enc_dims n_enc + 1
// widths. The grid has `groups` rows; group g runs passes [t_bound[g],
// t_bound[g + 1]). With groups > 1, s_part and s2_part hold groups * n
// f32 each and mc_finish_kernel writes mean and var after the kernel.
extern "C" int fused_head_stats_launch(
    int bf16, const void* x, long long n, int d, int n_enc, const void* const* enc_w,
    const void* const* enc_b, const int* enc_dims, const void* w0, const void* b0,
    const void* w1, const void* b1, const void* w2, const void* b2, const void* w0t,
    const void* w1t, int L, int H0, int H1, int T, unsigned int thresh, float scale,
    const void* bits, unsigned long long seed, int groups, const int* t_bound, void* s_part,
    void* s2_part, void* cost, void* gnorm, void* mean, void* var, void* stream) {
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
  const size_t smem = smem_bytes(p.width);
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
