// Gradient/hessian bin histograms for level-wise GBDT growth, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel vae_extent_search_tpu/ops/hist_pallas.py (_body,
// launched by hist_pallas_packed through pl.pallas_call). For every
// feature f, tree node c and bin b:
//
//   ghist[f, c, b] = sum of grad[r] over rows r with node[r] == c, bins[f, r] == b
//   hhist[f, c, b] = the same sum of hess[r]
//
// Inputs: bins [d, n] uint8 (feature-major, DMatrix._binned as it is),
// node [n] int32 in [0, m), grad and hess [n] f32. Outputs: ghist and
// hhist, [d, m, nb] f32 each. A row whose node lies outside [0, m), or a
// (feature, row) whose bin is >= nb, adds nothing (as in the plain versions,
// ops/hist.py::hist_plain and hist_plain_fixed).
//
// Bound on an H100: bytes. The work is two additions per (row, feature),
// ~0.33 G at 1M rows x 164 features, against ~176 MB of input (1 B per
// row per feature, 12 B per row of node/grad/hess): ~55 us at 3.35 TB/s
// versus ~5 us of f32 additions at 67 TFLOP/s. What the design pays
// instead is the scatter into shared memory: four 32-bit shared atomics
// per (row, feature), ~0.66 G at that shape.
//
// Determinism: every sum is an integer sum. grad and hess are rounded once
// to fixed point, q = rint(v * 2^e) as int64, with one power-of-two scale
// per array chosen from its largest magnitude and n so that no sum of n
// values can overflow (|q| * n < 2^62). Integer addition is associative, so
// the result does not depend on the order in which atomics land and is
// bit-identical from run to run (and to hist_plain_fixed). At n = 1M the
// scale leaves ~42 bits for the largest value, so rounding error is ~2^-42
// of max|v| per row, far below f32's rounding of the final sums. (Float
// atomics add in an order that changes between runs; near-tie split gains
// would then flip tree structure.)
//
// Design. The TPU kernel recast the scatter as one-hot matmuls because TPU
// scatters serialize; here the scatter is the natural form, and its cost is
// the shared-memory atomic. Hopper has no single-instruction 64-bit add on
// shared memory (cuobjdump shows a compare-and-swap loop for it), so each
// int64 cell is two 32-bit words, lo (unsigned) and hi (signed), and a q is
// added exactly as: old = atomicAdd(lo, (uint32)q); hi += (q >> 32) +
// carry, where carry = (old + (uint32)q wraps), added with a second atomic
// only where that sum is non-zero. The hi word only has to hold the cell's
// final (sum - lo) / 2^32, below 2^30 in magnitude, since intermediate
// wraps cancel in two's complement; so a block may cover any number of rows
// before its cells leave shared memory.
//
// A block owns a range of rows and a group of F features; it keeps one
// histogram per feature of its group in shared memory ([F][lo_g, hi_g,
// lo_h, hi_h][m][nb | 1] words), reads each row's node/grad/hess once for all F
// features (four rows per thread, 16-byte loads, where the shape allows),
// and adds with shared atomics. The grid is (row ranges C, feature groups);
// the wrapper (ops/hist.py::launch_plan) sizes F to shared memory and C
// so that the last wave of blocks is nearly full; a block covers many rows,
// so deep levels no longer flush small chunks. With C == 1 a block
// converts its sums to f32 itself. Otherwise each block stores its int64 sums to
// its slot of a partial buffer (plain stores, no device-wide atomics), and
// a third kernel adds the C partials of every cell and writes the f32
// outputs. The first kernel writes per-block maxima of |grad| and |hess|,
// which the others reduce to the two exponents, so no memset is needed.
//
// Exact across cards (hist_launch_fixed): the caller gives the exponent
// pair and gets the int64 sums, [d, m, nb] each, instead of f32. Ranks that
// each hold some of the rows agree on the exponents from the global max|v|
// and the global n, launch on their own rows, sum the integers across ranks
// and round as this kernel rounds, float(ldexp(sum, -e)): the result equals
// one card's launch over all the rows bit for bit. No absmax pass runs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 1024;      // hist_kernel's threads per block
constexpr int NT_MAX = 512;   // absmax_kernel's
constexpr int N_MAX = 256;    // absmax_kernel's blocks: per-block maxima
// dynamic shared memory a block may take: the H100's 227 KB less 1 KB
// for the kernel's static shared variables
constexpr int kMaxDynSmem = 232448 - 1024;

// exponent e for the fixed-point scale 2^e of an array whose largest |v|
// has float bits `bits`: |v| * 2^e < 2^(62 - log2n), so n such values sum
// below 2^62. Zero or non-finite maxima give e = 0.
__device__ __forceinline__ int fixed_exponent(unsigned int bits, int log2n) {
  const float a = __uint_as_float(bits);
  if (!(a > 0.f) || !isfinite(a)) return 0;
  int ex;
  frexpf(a, &ex);  // a < 2^ex
  return 62 - log2n - ex;
}

// bmax[0 .. N_MAX) the block maxima of |g|, bmax[N_MAX ..) those of |h|,
// as float bits (non-negative floats order like their bit patterns)
__global__ void __launch_bounds__(NT_MAX) absmax_kernel(const float* __restrict__ g,
                                                        const float* __restrict__ h,
                                                        long long n,
                                                        unsigned int* __restrict__ bmax) {
  float mg = 0.f, mh = 0.f;
  for (long long r = blockIdx.x * (long long)NT_MAX + threadIdx.x; r < n;
       r += (long long)gridDim.x * NT_MAX) {
    mg = fmaxf(mg, fabsf(g[r]));
    mh = fmaxf(mh, fabsf(h[r]));
  }
  for (int o = 16; o > 0; o >>= 1) {
    mg = fmaxf(mg, __shfl_xor_sync(0xffffffffu, mg, o));
    mh = fmaxf(mh, __shfl_xor_sync(0xffffffffu, mh, o));
  }
  __shared__ float wg[NT_MAX / 32], wh[NT_MAX / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    wg[warp] = mg;
    wh[warp] = mh;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < NT_MAX / 32; ++w) {
      mg = fmaxf(mg, wg[w]);
      mh = fmaxf(mh, wh[w]);
    }
    bmax[blockIdx.x] = __float_as_uint(mg);
    bmax[N_MAX + blockIdx.x] = __float_as_uint(mh);
  }
}

// adds q exactly to the int64 cell held as the words lo (unsigned) and
// lo[hi_off] (signed)
__device__ __forceinline__ void add_fixed(unsigned int* lo, int hi_off, long long q) {
  const unsigned int l = (unsigned int)q;
  const unsigned int old = atomicAdd(lo, l);
  const int hi = (int)(q >> 32) + (old + l < old ? 1 : 0);
  if (hi) atomicAdd(lo + hi_off, (unsigned int)hi);
}

struct Params {
  const uint8_t* bins;
  const int* node;
  const float* g;
  const float* h;
  long long n;
  int d, m, nb, F;
  int nbs;         // words from one node's bins to the next's: nb | 1
  long long rows;  // per block; a multiple of 4 when VEC
  int log2n;
  const unsigned int* bmax;
  long long* part;  // [C][d][2][m * nb] int64 where C = gridDim.x > 1
  float* gout;
  float* hout;
  int fixed;        // 1: exponents eg, eh given; int64 sums to g64, h64
  int eg, eh;
  long long* g64;
  long long* h64;
};

// grid (row ranges, feature groups); dynamic shared memory F * 4 * m * nbs
// words. Node c's bins start nbs = nb | 1 words after node c - 1's: an odd
// stride puts one bin of different nodes in different banks (with nb =
// 256 a feature with few bins would send every node to the same bank)
template <bool VEC>
__global__ void __launch_bounds__(NT) hist_kernel(const Params p) {
  extern __shared__ unsigned int sh[];  // [F][lo_g, hi_g, lo_h, hi_h][m][nbs]
  __shared__ double scale[2];
  __shared__ int expo[2];
  const int f0 = blockIdx.y * p.F;
  const int nf = min(p.F, p.d - f0);
  const int mnb = p.m * p.nb, smn = p.m * p.nbs, fw = 4 * smn;
  const long long r0 = blockIdx.x * p.rows;
  const long long r1 = min(p.n, r0 + p.rows);
  for (int i = threadIdx.x; i < nf * fw; i += NT) sh[i] = 0u;
  if (p.fixed) {
    if (threadIdx.x < 2) {
      expo[threadIdx.x] = threadIdx.x == 0 ? p.eg : p.eh;
      scale[threadIdx.x] = ldexp(1.0, expo[threadIdx.x]);
    }
  } else if (threadIdx.x < 64) {  // warp 0: |grad|, warp 1: |hess|
    const int a = threadIdx.x / 32, lane = threadIdx.x % 32;
    unsigned int mx = 0u;
    for (int i = lane; i < N_MAX; i += 32) mx = max(mx, p.bmax[a * N_MAX + i]);
    for (int o = 16; o > 0; o >>= 1) mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (lane == 0) {
      expo[a] = fixed_exponent(mx, p.log2n);
      scale[a] = ldexp(1.0, expo[a]);
    }
  }
  __syncthreads();
  const double sg = scale[0], shs = scale[1];
  const int m = p.m, nb = p.nb, nbs = p.nbs;

  if (VEC) {
    // four consecutive rows per thread: one 16-byte load each of node,
    // grad and hess, one 4-byte load of the four bins per feature (n and
    // the rows per block are multiples of 4)
    for (long long r = r0 + 4ll * threadIdx.x; r < r1; r += 4ll * NT) {
      const int4 c4 = *reinterpret_cast<const int4*>(p.node + r);
      const float4 g4 = *reinterpret_cast<const float4*>(p.g + r);
      const float4 h4 = *reinterpret_cast<const float4*>(p.h + r);
      const int cc[4] = {c4.x, c4.y, c4.z, c4.w};
      const float gg[4] = {g4.x, g4.y, g4.z, g4.w}, hh[4] = {h4.x, h4.y, h4.z, h4.w};
      long long qg[4], qh[4];
      int base[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        qg[k] = __double2ll_rn((double)gg[k] * sg);
        qh[k] = __double2ll_rn((double)hh[k] * shs);
        // -1: the row adds nothing (node out of range, or inert)
        base[k] = ((unsigned)cc[k] < (unsigned)m && (qg[k] | qh[k])) ? cc[k] * nbs : -1;
      }
      const uint8_t* col = p.bins + (long long)f0 * p.n + r;
      for (int j = 0; j < nf; ++j) {
        const unsigned int b4 =
            *reinterpret_cast<const unsigned int*>(col + (long long)j * p.n);
        unsigned int* fsh = sh + j * fw;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int b = (b4 >> (8 * k)) & 0xff;
          if (base[k] < 0 || b >= nb) continue;
          unsigned int* cell = fsh + base[k] + b;
          add_fixed(cell, smn, qg[k]);
          add_fixed(cell + 2 * smn, smn, qh[k]);
        }
      }
    }
  } else {
    for (long long r = r0 + threadIdx.x; r < r1; r += NT) {
      const int c = p.node[r];
      if ((unsigned)c >= (unsigned)m) continue;
      const long long qg = __double2ll_rn((double)p.g[r] * sg);
      const long long qh = __double2ll_rn((double)p.h[r] * shs);
      if ((qg | qh) == 0) continue;  // inert row (e.g. zero-weight padding)
      const uint8_t* col = p.bins + (long long)f0 * p.n + r;
      for (int j = 0; j < nf; ++j) {
        const int b = col[(long long)j * p.n];
        if (b >= nb) continue;
        unsigned int* cell = sh + j * fw + c * nbs + b;
        add_fixed(cell, smn, qg);
        add_fixed(cell + 2 * smn, smn, qh);
      }
    }
  }
  __syncthreads();

  // the block's int64 sums: cell i of [nf][2][mnb] (g then h per feature)
  auto sum_of = [&](int i) -> long long {
    const int j = i / (2 * mnb), rest = i - j * 2 * mnb;
    const int a = rest / mnb, cb = rest - a * mnb, c = cb / nb;
    const unsigned int* w = sh + j * fw + a * 2 * smn + c * nbs + (cb - c * nb);
    return (long long)((unsigned long long)(unsigned int)w[smn] << 32 | w[0]);
  };
  auto write = [&](int i, long long v) {
    const int j = i / (2 * mnb), rest = i - j * 2 * mnb;
    const int a = rest / mnb, cb = rest - a * mnb;
    const long long o = (long long)(f0 + j) * mnb + cb;
    if (p.fixed)
      (a == 0 ? p.g64 : p.h64)[o] = v;
    else if (a == 0)
      p.gout[o] = (float)ldexp((double)v, -expo[0]);
    else
      p.hout[o] = (float)ldexp((double)v, -expo[1]);
  };
  const int cells = nf * 2 * mnb;
  if (gridDim.x == 1) {
    for (int i = threadIdx.x; i < cells; i += NT) write(i, sum_of(i));
    return;
  }
  long long* mine = p.part + blockIdx.x * (long long)p.d * 2 * mnb + (long long)f0 * 2 * mnb;
  for (int i = threadIdx.x; i < cells; i += NT) mine[i] = sum_of(i);
}

// with C > 1 row ranges: out = the sum of the C partial sums, as f32 (or,
// with fixed, as int64 to g64 / h64)
__global__ void __launch_bounds__(NT_MAX) finish_kernel(const long long* __restrict__ part,
                                                        int C, int d, int mnb, int log2n,
                                                        const unsigned int* __restrict__ bmax,
                                                        float* __restrict__ gout,
                                                        float* __restrict__ hout, int fixed,
                                                        long long* __restrict__ g64,
                                                        long long* __restrict__ h64) {
  __shared__ int expo[2];
  if (!fixed && threadIdx.x < 64) {
    const int a = threadIdx.x / 32, lane = threadIdx.x % 32;
    unsigned int mx = 0u;
    for (int i = lane; i < N_MAX; i += 32) mx = max(mx, bmax[a * N_MAX + i]);
    for (int o = 16; o > 0; o >>= 1) mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (lane == 0) expo[a] = fixed_exponent(mx, log2n);
  }
  __syncthreads();
  const long long cells = (long long)d * 2 * mnb;
  for (long long i = blockIdx.x * (long long)NT_MAX + threadIdx.x; i < cells;
       i += (long long)gridDim.x * NT_MAX) {
    long long v = 0;
    for (int c = 0; c < C; ++c) v += part[c * cells + i];
    const long long f = i / (2 * mnb), rest = i - f * 2 * mnb;
    const int a = (int)(rest / mnb), cb = (int)(rest - a * mnb);
    if (fixed)
      (a == 0 ? g64 : h64)[f * mnb + cb] = v;
    else
      (a == 0 ? gout : hout)[f * mnb + cb] = (float)ldexp((double)v, -expo[a]);
  }
}

int g_attr_calls = 0;  // cudaFuncSetAttribute calls made

template <bool VEC>
cudaError_t set_attributes_once() {
  static bool done = false;
  if (done) return cudaSuccess;
  g_attr_calls += 2;
  // the most a launch may ask for; it asks for what it uses
  cudaError_t err = cudaFuncSetAttribute(
      hist_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynSmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(hist_kernel<VEC>,
                             cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  done = err == cudaSuccess;
  return err;
}

}  // namespace

namespace {

cudaError_t launch(const void* bins, const void* node, const void* grad, const void* hess,
                   long long n, int d, int m, int nb, int F, long long rows_per_block,
                   void* bmax, void* part, void* ghist, void* hhist, int fixed, int eg, int eh,
                   void* g64, void* h64, void* stream) {
  if (n <= 0 || d <= 0 || m <= 0 || nb <= 0 || nb > 256 || F <= 0 || rows_per_block <= 0 ||
      (size_t)F * 16 * m * (nb | 1) > (size_t)kMaxDynSmem)
    return cudaErrorInvalidValue;
  int log2n = 0;
  while ((1ll << log2n) < n) ++log2n;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long C = (n + rows_per_block - 1) / rows_per_block;
  if (C > 1 && part == nullptr) return cudaErrorInvalidValue;
  // four rows per thread: 16-byte node/grad/hess and 4-byte bins loads
  const bool vec = rows_per_block % 4 == 0 && n % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(node) | reinterpret_cast<uintptr_t>(grad) |
                     reinterpret_cast<uintptr_t>(hess)) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(bins) & 3) == 0;
  cudaError_t err = vec ? set_attributes_once<true>() : set_attributes_once<false>();
  if (err != cudaSuccess) return err;

  if (!fixed)
    absmax_kernel<<<N_MAX, NT_MAX, 0, s>>>(static_cast<const float*>(grad),
                                           static_cast<const float*>(hess), n,
                                           static_cast<unsigned int*>(bmax));
  Params p;
  p.bins = static_cast<const uint8_t*>(bins);
  p.node = static_cast<const int*>(node);
  p.g = static_cast<const float*>(grad);
  p.h = static_cast<const float*>(hess);
  p.n = n;
  p.d = d;
  p.m = m;
  p.nb = nb;
  p.nbs = nb | 1;
  p.F = F;
  p.rows = rows_per_block;
  p.log2n = log2n;
  p.bmax = static_cast<const unsigned int*>(bmax);
  p.part = static_cast<long long*>(part);
  p.gout = static_cast<float*>(ghist);
  p.hout = static_cast<float*>(hhist);
  p.fixed = fixed;
  p.eg = eg;
  p.eh = eh;
  p.g64 = static_cast<long long*>(g64);
  p.h64 = static_cast<long long*>(h64);
  const size_t smem = (size_t)F * 16 * m * p.nbs;
  const dim3 grid((unsigned)C, (unsigned)((d + F - 1) / F));
  if (vec)
    hist_kernel<true><<<grid, NT, smem, s>>>(p);
  else
    hist_kernel<false><<<grid, NT, smem, s>>>(p);
  if (C > 1) {
    const long long cells = 2ll * d * m * nb;
    const long long blocks = (cells + NT_MAX - 1) / NT_MAX;
    finish_kernel<<<(unsigned)(blocks < 2048 ? blocks : 2048), NT_MAX, 0, s>>>(
        p.part, (int)C, d, m * nb, log2n, p.bmax, p.gout, p.hout, fixed, p.g64, p.h64);
  }
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// Scratch, written here: bmax holds hist_bmax_words() uint32; with
// C = ceil(n / rows_per_block) > 1 row ranges, part holds C * d * 2 * m * nb
// int64.
extern "C" int hist_launch(const void* bins, const void* node, const void* grad,
                           const void* hess, long long n, int d, int m, int nb, int F,
                           long long rows_per_block, void* bmax, void* part, void* ghist,
                           void* hhist, void* stream) {
  return (int)launch(bins, node, grad, hess, n, d, m, nb, F, rows_per_block, bmax, part, ghist,
                     hhist, 0, 0, 0, nullptr, nullptr, stream);
}

// The same sums with the exponents eg (grad) and eh (hess) given, written as
// int64 to g64 and h64 ([d, m, nb] each); bmax is not used.
extern "C" int hist_launch_fixed(const void* bins, const void* node, const void* grad,
                                 const void* hess, long long n, int d, int m, int nb, int F,
                                 long long rows_per_block, void* part, int eg, int eh, void* g64,
                                 void* h64, void* stream) {
  return (int)launch(bins, node, grad, hess, n, d, m, nb, F, rows_per_block, nullptr, part,
                     nullptr, nullptr, 1, eg, eh, g64, h64, stream);
}

// cudaFuncSetAttribute calls made so far (two per kernel instance, once
// per process)
extern "C" int hist_attr_calls() { return g_attr_calls; }

// uint32 words of the bmax scratch hist_launch writes
extern "C" int hist_bmax_words() { return 2 * N_MAX; }
