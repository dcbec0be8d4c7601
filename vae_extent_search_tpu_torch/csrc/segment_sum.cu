// Ragged per-segment row sum and its gradient, for sm_90a.
//
// Replaces vae_extent_search_tpu/ops/segment_sum_pallas.py::_kernel (the
// TPU kernel behind segment_sum_pallas). Forward:
//
//   out[s, :] = sum over r in [offs[s], offs[s + 1]) of feat[r, :]
//
// for s < n_seg, accumulated in float32 whatever the storage type of feat
// (float32 or bfloat16). Rows outside [offs[0], offs[n_seg]) belong to no
// segment and add nothing; an empty segment gives zeros. Backward is the
// row broadcast
//
//   grad_feat[r, :] = grad_out[s, :]  for r in [offs[s], offs[s + 1])
//   grad_feat[r, :] = 0               for every other row
//
// Bound: bytes. Every input element is read once and every output element
// written once, one addition per element read; the design only has to keep
// the loads coalesced and enough of them in flight. A block takes one
// (segment, chunk of 128 columns): thread t owns column c = chunk * 128 + t,
// so a warp reads 32 neighbouring floats of one row at a time. The rows of
// the segment are walked in row order, four at a time into four partial
// sums that are added in a fixed order at the end: no atomics, no
// reduction across blocks, and so two launches give the same bits. There
// is no limit on a segment's length, no padding of n_seg, R or H, and row
// offsets into feat are 64-bit (R * H may pass 2^31).
//
// The TPU kernel's shape (8 segments per grid step, an aligned DMA of
// 8 * max_rows + 8 rows, a one-hot MXU product, H padded to 128 lanes)
// answers the TPU's tiling and has no counterpart here.
//
// Plain C interface for ctypes; each launch function returns
// cudaGetLastError() as an int.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 128;  // columns (threads) per block

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kCols)
segment_sum_fwd(const T* __restrict__ feat, const int* __restrict__ offs,
                float* __restrict__ out, int H) {
  const int s = blockIdx.x;
  const int c = blockIdx.y * kCols + threadIdx.x;
  if (c >= H) return;
  const long long lo = offs[s], hi = offs[s + 1];
  const T* p = feat + lo * H + c;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  long long r = lo;
  for (; r + 4 <= hi; r += 4, p += 4ll * H) {
    a0 += load_f32(p);
    a1 += load_f32(p + H);
    a2 += load_f32(p + 2ll * H);
    a3 += load_f32(p + 3ll * H);
  }
  for (; r < hi; ++r, p += H) a0 += load_f32(p);
  out[(long long)s * H + c] = (a0 + a1) + (a2 + a3);
}

// blockIdx.x < n_seg: the rows of that segment take its grad_out row.
// blockIdx.x == n_seg: the rows from offs[n_seg] to R take zeros.
// blockIdx.x == n_seg + 1: the rows before offs[0] take zeros.
template <typename T>
__global__ void __launch_bounds__(kCols)
segment_sum_bwd(const float* __restrict__ grad_out,
                const int* __restrict__ offs, T* __restrict__ grad_feat,
                long long R, int H, int n_seg) {
  const int s = blockIdx.x;
  const int c = blockIdx.y * kCols + threadIdx.x;
  if (c >= H) return;
  long long lo, hi;
  float g = 0.f;
  if (s < n_seg) {
    lo = offs[s];
    hi = offs[s + 1];
    g = grad_out[(long long)s * H + c];
  } else if (s == n_seg) {
    lo = offs[n_seg];
    hi = R;
  } else {
    lo = 0;
    hi = offs[0];
  }
  T* p = grad_feat + lo * H + c;
  for (long long r = lo; r < hi; ++r, p += H) store(p, g);
}

}  // namespace

extern "C" int segment_sum_fwd_launch(const void* feat, const void* offs,
                                      void* out, int H, int n_seg,
                                      int is_bf16, void* stream) {
  dim3 grid(n_seg, (H + kCols - 1) / kCols);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* o = static_cast<const int*>(offs);
  float* y = static_cast<float*>(out);
  if (is_bf16) {
    segment_sum_fwd<__nv_bfloat16><<<grid, kCols, 0, st>>>(
        static_cast<const __nv_bfloat16*>(feat), o, y, H);
  } else {
    segment_sum_fwd<float><<<grid, kCols, 0, st>>>(
        static_cast<const float*>(feat), o, y, H);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int segment_sum_bwd_launch(const void* grad_out, const void* offs,
                                      void* grad_feat, long long R, int H,
                                      int n_seg, int is_bf16, void* stream) {
  dim3 grid(n_seg + 2, (H + kCols - 1) / kCols);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* o = static_cast<const int*>(offs);
  const float* g = static_cast<const float*>(grad_out);
  if (is_bf16) {
    segment_sum_bwd<__nv_bfloat16><<<grid, kCols, 0, st>>>(
        g, o, static_cast<__nv_bfloat16*>(grad_feat), R, H, n_seg);
  } else {
    segment_sum_bwd<float><<<grid, kCols, 0, st>>>(
        g, o, static_cast<float*>(grad_feat), R, H, n_seg);
  }
  return static_cast<int>(cudaGetLastError());
}
