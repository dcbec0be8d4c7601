// Blocked matrix product C = A . B with float32 accumulation, for Hopper
// (sm_90a): the self-tuning target kernel, whose block configuration
// (bm, bn, bk) the active search tunes by timing it on the card.
//
// Replaces the TPU kernel vae_extent_search_tpu/ops/matmul_pallas.py
// (_kernel, launched by make_matmul through pl.pallas_call). Inputs A [M, K]
// and B [K, N], both float32 or both bfloat16, row-major; output C [M, N]
// float32. bm | M, bn | N and bk | K (the wrapper, ops/matmul.py, checks
// the configuration against the limits below before it launches).
//
// Bound on an H100 at 1536^3 bf16: operations. 7.25 GFLOP is 7.3 us at the
// tensor cores' 989 TFLOP/s against 18.9 MB of operands and output (5.6 us
// at 3.35 TB/s). This first kernel multiplies on the CUDA cores in f32
// (67 TFLOP/s peak, 108 us at this size) and reads its tiles from shared
// memory, so it sits far from that bound; wgmma and TMA are later work.
//
// Design. The configuration is the kernel's real tiling: one block computes
// one [bm, bn] tile of C and loops over K in steps of bk, staging the A tile
// [bm, bk] and the B tile [bk, bn] in dynamic shared memory in the input
// type (converted to f32 as they are read). The TPU kernel's sequential
// k-grid axis and revisited output block become this in-block loop: Hopper
// blocks run in no order, so nothing is carried between them. Each thread
// owns a TM x TN micro-tile, strided by the thread grid (rows ty + i * bm/TM,
// columns tx + j * bn/TN) so that neighbouring lanes read neighbouring B
// columns and write neighbouring C columns; the wrapper picks (TM, TN) from
// {1, 2, 4, 8}^2 so that the block has at most 256 threads. Every instance
// is compiled with __launch_bounds__(256), so a block never asks for more
// than 255 registers per thread, and 256 such threads fit an SM's 65,536
// registers: a configuration the wrapper accepts cannot fail to launch for
// registers, only for shared memory, which it also checks (227 KB). The
// sum over K runs in a fixed order, so two launches give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, int TM, int TN>
__global__ void __launch_bounds__(kMaxThreads)
matmul_kernel(const T* __restrict__ A, const T* __restrict__ B, float* __restrict__ C,
              int M, int N, int K, int bm, int bn, int bk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);  // [bm][bk]
  T* Bs = As + bm * bk;                    // [bk][bn]
  const int tiles_n = N / bn;
  const int m0 = (blockIdx.x / tiles_n) * bm;
  const int n0 = (blockIdx.x % tiles_n) * bn;
  const int RX = bn / TN, RY = bm / TM;  // the thread grid, RX * RY threads
  const int tid = threadIdx.x, nt = blockDim.x;
  const int tx = tid % RX, ty = tid / RX;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += bk) {
    for (int e = tid; e < bm * bk; e += nt) {
      const int r = e / bk, c = e - r * bk;
      As[e] = A[(size_t)(m0 + r) * K + k0 + c];
    }
    for (int e = tid; e < bk * bn; e += nt) {
      const int r = e / bn, c = e - r * bn;
      Bs[e] = B[(size_t)(k0 + r) * N + n0 + c];
    }
    __syncthreads();
    for (int k = 0; k < bk; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = to_f32(As[(ty + i * RY) * bk + k]);
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = to_f32(Bs[k * bn + tx + j * RX]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
      C[(size_t)(m0 + ty + i * RY) * N + n0 + tx + j * RX] = acc[i][j];
}

template <typename T, int TM, int TN>
cudaError_t launch(const void* A, const void* B, void* C, int M, int N, int K, int bm,
                   int bn, int bk, cudaStream_t s) {
  const size_t smem = (size_t)(bm + bn) * bk * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      matmul_kernel<T, TM, TN>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((M / bm) * (N / bn));
  const int threads = (bm / TM) * (bn / TN);
  matmul_kernel<T, TM, TN><<<blocks, threads, smem, s>>>(
      static_cast<const T*>(A), static_cast<const T*>(B), static_cast<float*>(C), M, N, K,
      bm, bn, bk);
  return cudaGetLastError();
}

template <typename T, int TM>
cudaError_t launch_tn(int tn, const void* A, const void* B, void* C, int M, int N, int K,
                      int bm, int bn, int bk, cudaStream_t s) {
  switch (tn) {
    case 1: return launch<T, TM, 1>(A, B, C, M, N, K, bm, bn, bk, s);
    case 2: return launch<T, TM, 2>(A, B, C, M, N, K, bm, bn, bk, s);
    case 4: return launch<T, TM, 4>(A, B, C, M, N, K, bm, bn, bk, s);
    case 8: return launch<T, TM, 8>(A, B, C, M, N, K, bm, bn, bk, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_tm(int tm, int tn, const void* A, const void* B, void* C, int M, int N,
                      int K, int bm, int bn, int bk, cudaStream_t s) {
  switch (tm) {
    case 1: return launch_tn<T, 1>(tn, A, B, C, M, N, K, bm, bn, bk, s);
    case 2: return launch_tn<T, 2>(tn, A, B, C, M, N, K, bm, bn, bk, s);
    case 4: return launch_tn<T, 4>(tn, A, B, C, M, N, K, bm, bn, bk, s);
    case 8: return launch_tn<T, 8>(tn, A, B, C, M, N, K, bm, bn, bk, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. (tm, tn): the thread micro-tile, each in
// {1, 2, 4, 8}, dividing bm and bn, with (bm / tm) * (bn / tn) <= 256.
// Returns a cudaError_t (0 on success); launches nothing on bad arguments.
extern "C" int matmul_launch(const void* A, const void* B, void* C, int M, int N, int K,
                             int bm, int bn, int bk, int tm, int tn, int dtype,
                             void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || bm <= 0 || bn <= 0 || bk <= 0 || M % bm || N % bn ||
      K % bk || tm <= 0 || tn <= 0 || bm % tm || bn % tn ||
      (bm / tm) * (bn / tn) > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_tm<float>(tm, tn, A, B, C, M, N, K, bm, bn, bk, s);
  if (dtype == 1)
    return (int)launch_tm<__nv_bfloat16>(tm, tn, A, B, C, M, N, K, bm, bn, bk, s);
  return (int)cudaErrorInvalidValue;
}
