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
// (feature, row) whose bin is >= nb, adds nothing (as in the plain version,
// ops/hist.py::hist_plain).
//
// Bound on an H100: bytes. The work is two additions per (row, feature),
// ~0.33 G at 1M rows x 164 features, against ~176 MB of input (1 B per
// row per feature, 12 B per row of node/grad/hess): ~55 us at 3.35 TB/s
// versus ~5 us of f32 additions at 67 TFLOP/s.
//
// Design. The TPU kernel recast the scatter as one-hot matmuls because TPU
// scatters serialize; here the scatter is the natural form. A block owns a
// range of rows and a group of F features; it keeps one private histogram
// per feature of its group in shared memory ([F][g|h][m][nb]), reads each
// row's node/grad/hess once for all F features, adds with shared-memory
// atomics, and then adds its non-zero cells to a device-wide accumulator
// with global atomics. A last pass converts the accumulator to f32.
//
// Determinism: every sum is an integer sum. grad and hess are rounded once
// to fixed point, q = rint(v * 2^e) as int64, with one power-of-two scale
// per array chosen from its largest magnitude and n so that no sum of n
// values can overflow (|q| * n < 2^62); the accumulators are int64 in
// shared and device memory. Integer addition is associative, so the result
// does not depend on the order in which atomics land and is bit-identical
// from run to run. At n = 1M the scale leaves ~42 bits for the largest
// value, so rounding error is ~2^-42 of max|v| per row, far below f32's
// rounding of the final sums. (Float atomics add in an order that changes
// between runs; near-tie split gains would then flip tree structure.)
//
// Shared memory: F * 2 * m * nb * 8 bytes. One feature at m = 32, nb = 256
// takes 128 KB (one block per SM); the wrapper picks F and the rows per
// block from m and nb (ops/hist.py) and raises when one feature does not
// fit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 512;

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

__global__ void __launch_bounds__(NT) absmax_kernel(const float* __restrict__ g,
                                                    const float* __restrict__ h,
                                                    long long n,
                                                    unsigned int* __restrict__ amax) {
  float mg = 0.f, mh = 0.f;
  for (long long r = blockIdx.x * (long long)NT + threadIdx.x; r < n;
       r += (long long)gridDim.x * NT) {
    mg = fmaxf(mg, fabsf(g[r]));
    mh = fmaxf(mh, fabsf(h[r]));
  }
  for (int o = 16; o > 0; o >>= 1) {
    mg = fmaxf(mg, __shfl_xor_sync(0xffffffffu, mg, o));
    mh = fmaxf(mh, __shfl_xor_sync(0xffffffffu, mh, o));
  }
  __shared__ float wg[NT / 32], wh[NT / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    wg[warp] = mg;
    wh[warp] = mh;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < NT / 32; ++w) {
      mg = fmaxf(mg, wg[w]);
      mh = fmaxf(mh, wh[w]);
    }
    // non-negative floats order like their bit patterns
    atomicMax(amax, __float_as_uint(mg));
    atomicMax(amax + 1, __float_as_uint(mh));
  }
}

// grid (row chunks, feature groups); acc is [2][d][m][nb] int64
__global__ void __launch_bounds__(NT) hist_kernel(
    const uint8_t* __restrict__ bins, const int* __restrict__ node,
    const float* __restrict__ g, const float* __restrict__ h, long long n, int d,
    int m, int nb, int F, long long rows_per_block, int log2n,
    const unsigned int* __restrict__ amax, unsigned long long* __restrict__ acc) {
  extern __shared__ unsigned long long sh[];  // [F][2][m][nb]
  const int f0 = blockIdx.y * F;
  const int nf = min(F, d - f0);
  const int mnb = m * nb, cells = 2 * mnb;
  const long long r0 = blockIdx.x * rows_per_block;
  const long long r1 = min(n, r0 + rows_per_block);
  for (int i = threadIdx.x; i < nf * cells; i += NT) sh[i] = 0ull;
  const double sg = ldexp(1.0, fixed_exponent(amax[0], log2n));
  const double sh_ = ldexp(1.0, fixed_exponent(amax[1], log2n));
  __syncthreads();

  for (long long r = r0 + threadIdx.x; r < r1; r += NT) {
    const int c = node[r];
    if ((unsigned)c >= (unsigned)m) continue;
    const long long qg = __double2ll_rn((double)g[r] * sg);
    const long long qh = __double2ll_rn((double)h[r] * sh_);
    if ((qg | qh) == 0) continue;  // inert row (e.g. zero-weight padding)
    const uint8_t* col = bins + (long long)f0 * n + r;
    unsigned long long* base = sh + c * nb;
    for (int j = 0; j < nf; ++j) {
      const int b = col[(long long)j * n];
      if (b >= nb) continue;
      unsigned long long* cell = base + j * cells + b;
      atomicAdd(cell, (unsigned long long)qg);
      atomicAdd(cell + mnb, (unsigned long long)qh);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < nf * cells; i += NT) {
    const unsigned long long v = sh[i];
    if (v == 0ull) continue;
    const int j = i / cells, rest = i - j * cells;
    const int gh = rest / mnb, cb = rest - gh * mnb;
    atomicAdd(acc + ((long long)gh * d + f0 + j) * mnb + cb, v);
  }
}

__global__ void __launch_bounds__(NT) finish_kernel(
    const unsigned long long* __restrict__ acc, long long cells, int log2n,
    const unsigned int* __restrict__ amax, float* __restrict__ gout,
    float* __restrict__ hout) {
  const int eg = fixed_exponent(amax[0], log2n);
  const int eh = fixed_exponent(amax[1], log2n);
  for (long long i = blockIdx.x * (long long)NT + threadIdx.x; i < 2 * cells;
       i += (long long)gridDim.x * NT) {
    const double v = (double)(long long)acc[i];
    if (i < cells)
      gout[i] = (float)ldexp(v, -eg);
    else
      hout[i - cells] = (float)ldexp(v, -eh);
  }
}

size_t hist_smem_bytes(int m, int nb, int F) {
  return (size_t)F * 2 * m * nb * sizeof(unsigned long long);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success). Scratch:
// amax holds 2 uint32, acc 2 * d * m * nb uint64; both are cleared here.
extern "C" int hist_launch(const void* bins, const void* node, const void* grad,
                           const void* hess, long long n, int d, int m, int nb,
                           int F, long long rows_per_block, void* amax, void* acc,
                           void* ghist, void* hhist, void* stream) {
  if (n <= 0 || d <= 0 || m <= 0 || nb <= 0 || nb > 256 || F <= 0 ||
      rows_per_block <= 0)
    return (int)cudaErrorInvalidValue;
  int log2n = 0;
  while ((1ll << log2n) < n) ++log2n;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long cells = (long long)d * m * nb;
  cudaError_t err = cudaMemsetAsync(amax, 0, 2 * sizeof(unsigned int), s);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(acc, 0, 2 * cells * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return (int)err;

  long long blocks = (n + NT - 1) / NT;
  absmax_kernel<<<(unsigned)(blocks < 1024 ? blocks : 1024), NT, 0, s>>>(
      static_cast<const float*>(grad), static_cast<const float*>(hess), n,
      static_cast<unsigned int*>(amax));

  const size_t smem = hist_smem_bytes(m, nb, F);
  err = cudaFuncSetAttribute(hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncSetAttribute(hist_kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  const dim3 grid((unsigned)((n + rows_per_block - 1) / rows_per_block),
                  (unsigned)((d + F - 1) / F));
  hist_kernel<<<grid, NT, smem, s>>>(
      static_cast<const uint8_t*>(bins), static_cast<const int*>(node),
      static_cast<const float*>(grad), static_cast<const float*>(hess), n, d, m, nb,
      F, rows_per_block, log2n, static_cast<const unsigned int*>(amax),
      static_cast<unsigned long long*>(acc));

  blocks = (2 * cells + NT - 1) / NT;
  finish_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), NT, 0, s>>>(
      static_cast<const unsigned long long*>(acc), cells, log2n,
      static_cast<const unsigned int*>(amax), static_cast<float*>(ghist),
      static_cast<float*>(hhist));
  return (int)cudaGetLastError();
}
