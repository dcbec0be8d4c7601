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
// by `pad` zeros on each side of H and W. boh | OH, bco | CO, bci | CI.
//
// Bound on an H100 at 1 x 56 x 56 x 256 -> 256, 3 x 3, bf16: operations.
// 3.70 GFLOP is 3.7 us at the tensor cores' 989 TFLOP/s against ~6.0 MB of
// input, weights and f32 output (1.8 us at 3.35 TB/s). This first kernel
// multiplies on the CUDA cores in f32 (67 TFLOP/s peak), so it sits far
// from that bound; wgmma and TMA are later work.
//
// Design. The configuration is the kernel's real tiling: one block computes
// boh output rows x all OW columns x bco output channels of one image, and
// loops over (kh, ci-block of bci). For each it stages in dynamic shared
// memory, in the input type, the input window [boh][OW + KW - 1][bci] (rows
// oh0 + kh - pad ..., every padded column) and the weight slices
// [KW][bci][bco], then runs kw inside, so a window is read once for all KW
// taps. Zero padding is masked while the window is loaded: no padded copy
// of x is made (the TPU wrapper pads with jnp.pad, and that copy is part of
// its measured work). The bias + ReLU epilogue is fused into the store. The
// TPU kernel's sequential reduction grid axis and revisited output block
// become this in-block loop. As in csrc/matmul.cu, each thread owns a
// TM x TN micro-tile of the [boh * OW, bco] output tile, strided by the
// thread grid; the wrapper (ops/conv2d.py) picks (TM, TN) so that the block
// has at most 256 threads, and __launch_bounds__(256) keeps registers
// within an SM's file, so an accepted configuration cannot fail to launch
// for registers; the wrapper also checks shared memory (227 KB). A block of
// boh = 8 x OW = 56 x bco = 128 (57,344 accumulators) does not fit 256
// threads of 64 and is refused. The sums run in a fixed order, so two
// launches give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

template <typename T, int TM, int TN>
__global__ void __launch_bounds__(kMaxThreads)
conv2d_kernel(const T* __restrict__ x, const T* __restrict__ w,
              const float* __restrict__ bias, float* __restrict__ out, int H, int W,
              int CI, int CO, int KH, int KW, int pad, int OH, int OW, int boh, int bco,
              int bci) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int OWp = OW + KW - 1;                   // padded window width
  T* xs = reinterpret_cast<T*>(smem_raw);        // [boh][OWp][bci]
  T* ws = xs + boh * OWp * bci;                  // [KW][bci][bco]
  const int tiles_co = CO / bco, tiles_oh = OH / boh;
  int b = blockIdx.x;
  const int co0 = (b % tiles_co) * bco;
  b /= tiles_co;
  const int oh0 = (b % tiles_oh) * boh;
  const int n = b / tiles_oh;
  const int P = boh * OW;                        // output positions per block
  const int RX = bco / TN, RY = P / TM;          // the thread grid
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
        T v = zero<T>();
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
          float a[TM], bv[TN];
#pragma unroll
          for (int i = 0; i < TM; ++i) a[i] = to_f32(xs[xoff[i] + kw * bci + c]);
#pragma unroll
          for (int j = 0; j < TN; ++j) bv[j] = to_f32(ws[(kw * bci + c) * bco + tx + j * RX]);
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
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
      out[row * CO + co] = fmaxf(acc[i][j] + bias[co], 0.f);
    }
  }
}

struct Args {
  const void* x;
  const void* w;
  const void* bias;
  void* out;
  int N, H, W, CI, CO, KH, KW, pad, OH, OW, boh, bco, bci;
};

template <typename T, int TM, int TN>
cudaError_t launch(const Args& a, cudaStream_t s) {
  const size_t smem =
      ((size_t)a.boh * (a.OW + a.KW - 1) * a.bci + (size_t)a.KW * a.bci * a.bco) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      conv2d_kernel<T, TM, TN>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)(a.N * (a.OH / a.boh) * (a.CO / a.bco));
  const int threads = (a.boh * a.OW / TM) * (a.bco / TN);
  conv2d_kernel<T, TM, TN><<<blocks, threads, smem, s>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.w),
      static_cast<const float*>(a.bias), static_cast<float*>(a.out), a.H, a.W, a.CI, a.CO,
      a.KH, a.KW, a.pad, a.OH, a.OW, a.boh, a.bco, a.bci);
  return cudaGetLastError();
}

template <typename T, int TM>
cudaError_t launch_tn(int tn, const Args& a, cudaStream_t s) {
  switch (tn) {
    case 1: return launch<T, TM, 1>(a, s);
    case 2: return launch<T, TM, 2>(a, s);
    case 4: return launch<T, TM, 4>(a, s);
    case 8: return launch<T, TM, 8>(a, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_tm(int tm, int tn, const Args& a, cudaStream_t s) {
  switch (tm) {
    case 1: return launch_tn<T, 1>(tn, a, s);
    case 2: return launch_tn<T, 2>(tn, a, s);
    case 4: return launch_tn<T, 4>(tn, a, s);
    case 8: return launch_tn<T, 8>(tn, a, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. (tm, tn): the thread micro-tile, each in
// {1, 2, 4, 8}, dividing boh * OW and bco, with (boh * OW / tm) * (bco / tn)
// <= 256. Returns a cudaError_t (0 on success); launches nothing on bad
// arguments.
extern "C" int conv2d_launch(const void* x, const void* w, const void* bias, void* out,
                             int N, int H, int W, int CI, int CO, int KH, int KW, int pad,
                             int boh, int bco, int bci, int tm, int tn, int dtype,
                             void* stream) {
  const int OH = H + 2 * pad - KH + 1, OW = W + 2 * pad - KW + 1;
  if (N <= 0 || CI <= 0 || CO <= 0 || KH <= 0 || KW <= 0 || pad < 0 || OH <= 0 ||
      OW <= 0 || boh <= 0 || bco <= 0 || bci <= 0 || OH % boh || CO % bco || CI % bci ||
      tm <= 0 || tn <= 0 || (boh * OW) % tm || bco % tn ||
      (boh * OW / tm) * (bco / tn) > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  const Args a{x, w, bias, out, N, H, W, CI, CO, KH, KW, pad, OH, OW, boh, bco, bci};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_tm<float>(tm, tn, a, s);
  if (dtype == 1) return (int)launch_tm<__nv_bfloat16>(tm, tn, a, s);
  return (int)cudaErrorInvalidValue;
}
