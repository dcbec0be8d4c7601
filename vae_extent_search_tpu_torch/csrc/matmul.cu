// Blocked matrix product C = A . B with float32 accumulation, for Hopper
// (sm_90a): the self-tuning target kernel, whose block configuration
// (bm, bn, bk) the active search tunes by timing it on the card.
//
// Replaces the TPU kernel vae_extent_search_tpu/ops/matmul_pallas.py
// (_kernel, launched by make_matmul through pl.pallas_call). Inputs A [M, K]
// and B [K, N], both float32 or both bfloat16, row-major; output C [M, N]
// float32. The wrapper, ops/matmul.py, checks the configuration against the
// lattice of the path its dtype takes before it launches. Two paths, chosen
// by dtype and never one for the other:
//
// bfloat16: tensor cores. Bound on an H100 at 1536^3: operations, 7.25 GFLOP
// is 7.3 us at 989 TFLOP/s against 18.9 MB of operands and output (5.6 us
// at 3.35 TB/s). One block computes one [bm, bn] tile of C with
// wgmma.mma_async m64nBNk16 (f32 accumulators in registers). A warp-
// specialised pipeline feeds it: one thread of a producer warpgroup issues
// TMA loads of the A tile [bm, bk] (K-major, swizzled to its bk * 2-byte
// rows) and of the B tile [bk, bn] (N-contiguous, MN-major, loaded in
// chunks of 16, 32 or 64 columns each swizzled to its own width) into a
// ring of `stages` buffers in dynamic shared memory, each with a full and an
// empty mbarrier; wgmma reads B through its transpose bit, so B is never
// transposed. One or two consumer warpgroups (bm = 64 x warpgroups x
// atoms) each own `atoms` 64-row blocks of the tile; they keep one wgmma
// group in flight and free a stage when the group that read it retires.
// setmaxnreg moves registers from the producer to the consumers. TMA fills
// out-of-range rows and columns with zeros, and the epilogue masks its
// stores, so bm, bn and bk need not divide M, N and K (the row strides, K
// and N elements, must be multiples of 16 bytes for TMA). The tensor maps
// are built on the host once per (pointers, shape, tile) and passed as
// __grid_constant__ parameters. Sums over K run in a fixed order, so two
// launches give the same bits.
//
// float32: the CUDA cores (tensor cores in f32 would be TF32, which changes
// the numbers). Bound 67 TFLOP/s. The [bm, bn] tile, an in-block loop over
// K in steps of bk, both tiles staged in shared memory; each thread owns a
// TM x TN micro-tile strided by the thread grid, (TM, TN) from {1, 2, 4,
// 8}^2 with at most 256 threads; bm | M, bn | N, bk | K.
//
// Each instance's shared-memory limit is raised once, on its first launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include "wgmma_ops.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxSmem = 232448;  // an H100 block's 227 KB
constexpr int kMaxStages = 6;
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

// ---------------------------------------------------------------------------
// float32 on the CUDA cores
// ---------------------------------------------------------------------------

template <int TM, int TN>
__global__ void __launch_bounds__(kMaxThreads)
mm_f32(const float* __restrict__ A, const float* __restrict__ B, float* __restrict__ C, int M,
       int N, int K, int bm, int bn, int bk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* As = reinterpret_cast<float*>(smem_raw);  // [bm][bk]
  float* Bs = As + bm * bk;                        // [bk][bn]
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
      for (int i = 0; i < TM; ++i) a[i] = As[(ty + i * RY) * bk + k];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[k * bn + tx + j * RX];
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

template <int TM, int TN>
cudaError_t launch_f32(const float* A, const float* B, float* C, int M, int N, int K, int bm,
                       int bn, int bk, cudaStream_t s) {
  static bool attr_done = false;
  cudaError_t err = raise_smem_once(mm_f32<TM, TN>, attr_done);
  if (err != cudaSuccess) return err;
  const size_t smem = (size_t)(bm + bn) * bk * sizeof(float);
  const unsigned blocks = (unsigned)((M / bm) * (N / bn));
  const int threads = (bm / TM) * (bn / TN);
  mm_f32<TM, TN><<<blocks, threads, smem, s>>>(A, B, C, M, N, K, bm, bn, bk);
  return cudaGetLastError();
}

template <int TM>
cudaError_t launch_f32_tn(int tn, const float* A, const float* B, float* C, int M, int N,
                          int K, int bm, int bn, int bk, cudaStream_t s) {
  switch (tn) {
    case 1: return launch_f32<TM, 1>(A, B, C, M, N, K, bm, bn, bk, s);
    case 2: return launch_f32<TM, 2>(A, B, C, M, N, K, bm, bn, bk, s);
    case 4: return launch_f32<TM, 4>(A, B, C, M, N, K, bm, bn, bk, s);
    case 8: return launch_f32<TM, 8>(A, B, C, M, N, K, bm, bn, bk, s);
  }
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores: TMA + mbarrier ring + wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Waits for the phase of parity `parity` to complete. A wait that lasts
// ~10 s of clock cycles traps, so a pipeline fault ends the launch with an
// error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > 20000000000LL) __trap();
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle layout (1: 128 B, 2: 64 B, 3: 32 B).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint32_t swizzle_bytes) {
  const uint64_t layout = swizzle_bytes == 128 ? 1 : swizzle_bytes == 64 ? 2 : 3;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

template <int BN, int WG, int ATOMS>
struct Bf16Shape {
  static constexpr int kBM = 64 * WG * ATOMS;
  static constexpr int kThreads = 128 * (WG + 1);  // consumers + one producer warpgroup
  static constexpr int kProducerRegs = 40;
  static constexpr int kConsumerRegs = 232;
};

// grid: one block per [BM, BN] tile, n fastest. smem: 1 KB of alignment
// slack, `stages` x (A tile BM x bk, B tile bk x BN) at 1 KB boundaries,
// then the full and empty barriers.
template <int BN, int WG, int ATOMS>
__global__ void __launch_bounds__(Bf16Shape<BN, WG, ATOMS>::kThreads, 1)
mm_bf16(const __grid_constant__ CUtensorMap tmA, const __grid_constant__ CUtensorMap tmB,
        float* __restrict__ C, int M, int N, int K, int bk, int cw, int stages) {
  using S = Bf16Shape<BN, WG, ATOMS>;
  constexpr int BM = S::kBM;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t a_bytes = BM * bk * 2, b_bytes = bk * BN * 2;
  const uint32_t stage_bytes = (a_bytes + b_bytes + 1023u) & ~1023u;
  const uint32_t bars = base + stages * stage_bytes;  // full[s], then empty[s]
  const int tiles_n = (N + BN - 1) / BN;
  const int m0 = (blockIdx.x / tiles_n) * BM, n0 = (blockIdx.x % tiles_n) * BN;
  const int KT = (K + bk - 1) / bk;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(bars + 8 * s, 1);                    // the producer's expect_tx
      mbar_init(bars + 8 * (stages + s), 4 * WG);    // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == WG) {
    // producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(S::kProducerRegs));
    if (threadIdx.x == WG * 128) {
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % stages, round = kt / stages;
        if (round > 0) mbar_wait(bars + 8 * (stages + s), (round - 1) & 1);
        const uint32_t full = bars + 8 * s, a_dst = base + s * stage_bytes;
        mbar_expect_tx(full, a_bytes + b_bytes);
        tma_load(a_dst, &tmA, full, kt * bk, m0);
        for (int j = 0; j < BN / cw; ++j)
          tma_load(a_dst + a_bytes + j * bk * cw * 2, &tmB, full, n0 + j * cw, kt * bk);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(S::kConsumerRegs));
    float acc[ATOMS][BN / 2];
#pragma unroll
    for (int a = 0; a < ATOMS; ++a)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[a][i] = 0.f;
    const uint32_t a_row = bk * 2;                  // bytes per A row = its swizzle
    const uint32_t b_row = cw * 2;                  // bytes per B chunk row = its swizzle
    const int lane = threadIdx.x % 32;
    int prev = -1;
    for (int kt = 0; kt < KT; ++kt) {
      const int s = kt % stages;
      mbar_wait(bars + 8 * s, (kt / stages) & 1);
      const uint32_t a_base = base + s * stage_bytes + wg * ATOMS * 64 * a_row;
      const uint32_t b_base = base + s * stage_bytes + a_bytes;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      for (int k16 = 0; k16 < bk / 16; ++k16) {
        // B: 16 more K rows of every chunk; chunks lie bk rows apart
        const uint64_t db = make_desc(b_base + k16 * 16 * b_row, bk * b_row, 8 * b_row, b_row);
#pragma unroll
        for (int a = 0; a < ATOMS; ++a) {
          // A: 64 rows further per atom, 32 bytes further per k16 step
          const uint64_t da =
              make_desc(a_base + a * 64 * a_row + k16 * 32, 16, 8 * a_row, a_row);
          Wgmma<BN>::mma(acc[a], da, db);
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (prev >= 0 && lane == 0) mbar_arrive(bars + 8 * (stages + prev));
      prev = s;
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");

    const int t = threadIdx.x % 128;
    const int row0 = 16 * (t / 32) + (t % 32) / 4, col0 = 2 * (t % 4);
#pragma unroll
    for (int a = 0; a < ATOMS; ++a) {
      const int r = m0 + (wg * ATOMS + a) * 64 + row0;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const int c = n0 + 8 * i + col0;
        if (c < N) {  // N is even, so c + 1 < N too
          if (r < M)
            *reinterpret_cast<float2*>(C + (size_t)r * N + c) =
                make_float2(acc[a][4 * i], acc[a][4 * i + 1]);
          if (r + 8 < M)
            *reinterpret_cast<float2*>(C + (size_t)(r + 8) * N + c) =
                make_float2(acc[a][4 * i + 2], acc[a][4 * i + 3]);
        }
      }
    }
  }
}

size_t bf16_smem(int bm, int bn, int bk, int stages) {
  const size_t stage = ((size_t)(bm + bn) * bk * 2 + 1023) / 1024 * 1024;
  return 1024 + stages * stage + 16 * (size_t)stages;
}

template <int BN, int WG, int ATOMS>
cudaError_t launch_bf16(const CUtensorMap* maps, float* C, int M, int N, int K, int bk,
                        int cw, int stages, cudaStream_t s) {
  using S = Bf16Shape<BN, WG, ATOMS>;
  static bool attr_done = false;
  if (!attr_done) {
    // the registers the block holds at launch must cover setmaxnreg's split
    cudaFuncAttributes fa;
    cudaError_t err = cudaFuncGetAttributes(&fa, mm_bf16<BN, WG, ATOMS>);
    if (err != cudaSuccess) return err;
    if (fa.numRegs * S::kThreads < 128 * (S::kProducerRegs + WG * S::kConsumerRegs))
      return cudaErrorInvalidConfiguration;
  }
  cudaError_t err = raise_smem_once(mm_bf16<BN, WG, ATOMS>, attr_done);
  if (err != cudaSuccess) return err;
  const unsigned blocks =
      (unsigned)(((M + S::kBM - 1) / S::kBM) * ((N + BN - 1) / BN));
  mm_bf16<BN, WG, ATOMS><<<blocks, S::kThreads, bf16_smem(S::kBM, BN, bk, stages), s>>>(
      maps[0], maps[1], C, M, N, K, bk, cw, stages);
  return cudaGetLastError();
}

// The (bm, bn) instances: bm 64 and 128 (one and two consumer warpgroups of
// one 64-row atom) at every width, bm 256 (two warpgroups of two atoms) up
// to bn 128, where its accumulators fill 128 registers per thread.
#define MM_WIDE(X) X(16) X(32) X(64) X(96) X(128) X(160) X(192) X(224) X(256)
#define MM_NARROW(X) X(16) X(32) X(64) X(96) X(128)

cudaError_t launch_bf16_any(int bm, int bn, const CUtensorMap* maps, float* C, int M, int N,
                            int K, int bk, int cw, int stages, cudaStream_t s) {
#define CASE(WG, AT, BNV) \
  if (bn == BNV) return launch_bf16<BNV, WG, AT>(maps, C, M, N, K, bk, cw, stages, s);
#define CASE64(BNV) CASE(1, 1, BNV)
#define CASE128(BNV) CASE(2, 1, BNV)
#define CASE256(BNV) CASE(2, 2, BNV)
  if (bm == 64) { MM_WIDE(CASE64) }
  if (bm == 128) { MM_WIDE(CASE128) }
  if (bm == 256) { MM_NARROW(CASE256) }
#undef CASE
#undef CASE64
#undef CASE128
#undef CASE256
  return cudaErrorInvalidValue;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver library the CUDA runtime has
// already loaded (no link against libcuda).
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!h) h = dlopen("libcuda.so.1", RTLD_NOW);
    if (h) fn = reinterpret_cast<EncodeTiled>(dlsym(h, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

CUtensorMapSwizzle swizzle_of(int bytes) {
  return bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
         : bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                       : CU_TENSOR_MAP_SWIZZLE_32B;
}

// A 2-D bf16 tensor map over a row-major [rows, cols] array, box [box_r,
// box_c], swizzled to box_c * 2 bytes, zeros outside the array.
int encode(CUtensorMap* map, const void* ptr, int rows, int cols, int box_r, int box_c) {
  EncodeTiled fn = encode_fn();
  if (!fn) return (int)cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_c, (cuuint32_t)box_r};
  const cuuint32_t elem[2] = {1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                  strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_of(box_c * 2),
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

int chunk_of(int bn) { return bn % 64 == 0 ? 64 : bn % 32 == 0 ? 32 : 16; }

bool bf16_args_ok(int M, int N, int K, int bm, int bn, int bk) {
  return M > 0 && N > 0 && K > 0 && (bm == 64 || bm == 128 || bm == 256) && bn >= 16 &&
         bn <= 256 && bn % 16 == 0 && (bm < 256 || bn <= 128) &&
         (bk == 16 || bk == 32 || bk == 64) && N % 8 == 0 && K % 8 == 0;
}

}  // namespace

// float32: (tm, tn) the thread micro-tile, each in {1, 2, 4, 8}, dividing bm
// and bn, with (bm / tm) * (bn / tn) <= 256; bm | M, bn | N, bk | K.
// Returns a cudaError_t (0 on success); launches nothing on bad arguments.
extern "C" int matmul_f32_launch(const void* A, const void* B, void* C, int M, int N, int K,
                                 int bm, int bn, int bk, int tm, int tn, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || bm <= 0 || bn <= 0 || bk <= 0 || M % bm || N % bn ||
      K % bk || tm <= 0 || tn <= 0 || bm % tm || bn % tn ||
      (bm / tm) * (bn / tn) > kMaxThreads || (size_t)(bm + bn) * bk * 4 > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const float *a = static_cast<const float*>(A), *b = static_cast<const float*>(B);
  float* c = static_cast<float*>(C);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tm) {
    case 1: return (int)launch_f32_tn<1>(tn, a, b, c, M, N, K, bm, bn, bk, s);
    case 2: return (int)launch_f32_tn<2>(tn, a, b, c, M, N, K, bm, bn, bk, s);
    case 4: return (int)launch_f32_tn<4>(tn, a, b, c, M, N, K, bm, bn, bk, s);
    case 8: return (int)launch_f32_tn<8>(tn, a, b, c, M, N, K, bm, bn, bk, s);
  }
  return (int)cudaErrorInvalidValue;
}

// bfloat16: writes the tensor maps of A [M, K] (box bm x bk) and B [K, N]
// (box bk x the chunk width) into maps[0..1] (2 x 128 bytes). A and B must
// be 16-byte aligned.
extern "C" int matmul_bf16_maps(const void* A, const void* B, int M, int N, int K, int bm,
                                int bn, int bk, void* maps) {
  if (!bf16_args_ok(M, N, K, bm, bn, bk) || (reinterpret_cast<uintptr_t>(A) & 15) ||
      (reinterpret_cast<uintptr_t>(B) & 15))
    return (int)cudaErrorInvalidValue;
  CUtensorMap* m = static_cast<CUtensorMap*>(maps);
  int err = encode(&m[0], A, M, K, bm, bk);
  return err ? err : encode(&m[1], B, K, N, bk, chunk_of(bn));
}

// bfloat16: C [M, N] = A . B through the tensor maps from matmul_bf16_maps,
// with `stages` ring buffers (2 .. 6, within 227 KB). Returns a cudaError_t.
extern "C" int matmul_bf16_launch(const void* maps, void* C, int M, int N, int K, int bm,
                                  int bn, int bk, int stages, void* stream) {
  if (!bf16_args_ok(M, N, K, bm, bn, bk) || stages < 2 || stages > kMaxStages ||
      bf16_smem(bm, bn, bk, stages) > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  return (int)launch_bf16_any(bm, bn, static_cast<const CUtensorMap*>(maps),
                              static_cast<float*>(C), M, N, K, bk, chunk_of(bn), stages,
                              static_cast<cudaStream_t>(stream));
}

// The template instances this library holds, as (dtype, p, q) triples into
// out[0 .. 3 * cap): dtype 0 float32 with p, q = (TM, TN); dtype 1 bfloat16
// with p, q = (bm, bn). Returns their number.
extern "C" int matmul_instances(int* out, int cap) {
  int n = 0;
  auto add = [&](int d, int p, int q) {
    if (n < cap) { out[3 * n] = d; out[3 * n + 1] = p; out[3 * n + 2] = q; }
    ++n;
  };
  const int micro[4] = {1, 2, 4, 8};
  for (int tm : micro)
    for (int tn : micro) add(0, tm, tn);
#define ADD64(BNV) add(1, 64, BNV);
#define ADD128(BNV) add(1, 128, BNV);
#define ADD256(BNV) add(1, 256, BNV);
  MM_WIDE(ADD64) MM_WIDE(ADD128) MM_NARROW(ADD256)
#undef ADD64
#undef ADD128
#undef ADD256
  return n;
}

// cudaFuncSetAttribute calls made so far (one per instance launched).
extern "C" int matmul_attr_calls() { return g_attr_calls; }
