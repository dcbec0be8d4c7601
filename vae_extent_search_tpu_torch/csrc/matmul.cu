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
// the numbers), exact FFMA. Bound on an H100 at 1536^3: operations, 7.25
// GFLOP is 0.108 ms at 67 TFLOP/s. One instance per (BM, BN) of the lattice
// F32_BM x F32_BN; bk (8, 16 or 32) and the ring's depth are arguments. A
// block of BM * BN / (8 * TN) threads computes one [BM, BN] tile of C; each
// thread holds an 8 x TN accumulator tile (TN = 8, or 4 where 8 x 8 would
// leave a part of a warp: 32x32, 32x96, 96x32, 96x96) as 2 x TN/4 blocks of
// 4 x 4, its two row blocks WM/2 apart and its two column blocks WN/2 apart
// in a warp tile of 32 x 64, 64 x 32 (8 x 8) or 32 x 32 (8 x 4) whose lanes
// form a 4 x 8 or 8 x 4 grid. Both tiles reach shared memory by cp.async
// (LDGSTS, 16 bytes, cached in L2 only) into a ring of 2-4 stages with one
// barrier per k-step, so the copies for step s + stages - 1 run under the
// FMAs of step s. A is kept as it lies in memory, [BM][bk + 4] (k
// contiguous; the pad puts rows four apart in other banks), not transposed
// to K-major: a transpose would take the copy through registers (LDG, then
// four STS per float4), registers that 64 accumulators at two blocks per SM
// cannot spare, and would keep A out of the asynchronous ring. Its fragment
// is read along k instead: one LDS.128 per thread row gives that row's next
// four k values, so four k-steps read 8 float4 of A (the lanes of a row
// broadcast) and 4 x TN/4 float4 of B ([bk][BN], conflict-free), the 4
// LDS.128 per 64 FFMAs of a K-major layout; B's fragment for step k + 1 is
// loaded before the FMAs of step k. Ragged edges: a 16-byte chunk past M, N
// or K is copied with src-size 0 (zero fill) and the stores are masked, so
// the tile need not divide the axes; the wrapper stages K and N up to
// multiples of 4 (16-byte rows). Each output adds its k terms in increasing
// order in one register, so two launches give the same bits.
// __launch_bounds__ asks for two blocks per SM, which leaves 168 registers
// a thread at up to 192 threads and 96 at 288 (a register file of 16K per
// SM quarter), except at 256 threads of 8 x 8 (128 x 128), where 128
// registers spill and one block is asked for; no instance spills. The
// wrapper gives the ring the most stages, up to 4, that leave room for
// two blocks in an SM's 228 KB. Each thread's copies start from its own
// row and 16-byte column and step by whole rows, so a k-step's copies cost
// a few integer operations each. The tiling and the copies live in
// f32_tile.cuh, which conv2d.cu's f32 kernel shares.
//
// Each instance's shared-memory limit is raised once, on its first launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include "f32_tile.cuh"
#include "wgmma_ops.cuh"

namespace {

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

// The lattice (ops/matmul.py: F32_BM, F32_BN), one instance per pair.
#define F32_BM(X) X(32) X(64) X(96) X(128)
#define F32_BN(X) X(32) X(64) X(96) X(128)

// grid: one block per [BM, BN] tile of C, n fastest. smem: `stages` x (A
// tile [BM][bk + 4], B tile [bk][BN]) floats.
template <int BM, int BN>
__global__ void __launch_bounds__(F32Tile<BM, BN>::kThreads, F32Tile<BM, BN>::kMinBlocks)
mm_f32(const float* __restrict__ A, const float* __restrict__ B, float* __restrict__ C, int M,
       int N, int K, int bk, int stages) {
  using T = F32Tile<BM, BN>;
  constexpr int TN = T::kTN, FN = TN / 4, WM = T::kWM, WN = T::kWN;
  extern __shared__ __align__(16) float smem_f32[];
  const int lda = bk + kF32Pad;
  const int a_size = BM * lda, stage_size = a_size + bk * BN;
  const int tiles_n = (N + BN - 1) / BN;
  const int m0 = (blockIdx.x / tiles_n) * BM, n0 = (blockIdx.x % tiles_n) * BN;
  const int KT = (K + bk - 1) / bk;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // this thread's rows are row0 + h * WM/2 + i, its columns col0 + g * WN/2 + j
  const int row0 = (warp / (BN / WN)) * WM + (lane / T::kLN) * 4;
  const int col0 = (warp % (BN / WN)) * WN + (lane % T::kLN) * 4;
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem_f32));
  // this thread's copies in each k-step: A rows a_r, a_r + a_step, ... at
  // column a_k, and B rows b_r, b_r + b_step, ... at column b_n (the thread
  // count is a multiple of both tiles' 16-byte chunks per row)
  constexpr int NC = BN / 4;
  static_assert(T::kThreads % NC == 0 && T::kThreads % 8 == 0, "copy layout");
  const int kc = bk / 4, a_step = T::kThreads / kc, a_r = tid / kc, a_k = (tid % kc) * 4;
  constexpr int b_step = T::kThreads / NC;
  const int b_r = tid / NC, b_n = (tid % NC) * 4;
  const bool b_in = n0 + b_n < N;

  // k-step kt of A and B into stage s; zeros past M, N and K
  auto load = [&](int kt, int s) {
    const int k0 = kt * bk;
    const uint32_t as = sbase + 4u * (uint32_t)(s * stage_size);
    const uint32_t bs = as + 4u * (uint32_t)a_size;
    const bool a_in = k0 + a_k < K;
    for (int r = a_r; r < BM; r += a_step) {
      const bool ok = a_in && m0 + r < M;
      cp_async16(as + 4u * (uint32_t)(r * lda + a_k),
                 ok ? A + (size_t)(m0 + r) * K + k0 + a_k : A, ok);
    }
    for (int r = b_r; r < bk; r += b_step) {
      const bool ok = b_in && k0 + r < K;
      cp_async16(bs + 4u * (uint32_t)(r * BN + b_n), ok ? B + (size_t)(k0 + r) * N + n0 + b_n : B,
                 ok);
    }
  };

  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int s = 0; s < stages - 1; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait(stages - 2);
    // step kt has landed in every thread's view, and every thread is done
    // with step kt - 1, whose stage the next copy refills
    __syncthreads();
    if (kt + stages - 1 < KT) load(kt + stages - 1, (kt + stages - 1) % stages);
    cp_async_commit();
    const float* as = smem_f32 + (kt % stages) * stage_size + row0 * lda;
    const float* bs = smem_f32 + (kt % stages) * stage_size + a_size + col0;
#pragma unroll 2
    for (int k = 0; k < bk; k += 4) {
      float4 a[8], b[2][FN];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(as + ((i / 4) * (WM / 2) + i % 4) * lda + k);
#pragma unroll
      for (int g = 0; g < FN; ++g)
        b[0][g] = *reinterpret_cast<const float4*>(bs + k * BN + g * (WN / 2));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk < 3) {
#pragma unroll
          for (int g = 0; g < FN; ++g)
            b[(kk + 1) & 1][g] =
                *reinterpret_cast<const float4*>(bs + (k + kk + 1) * BN + g * (WN / 2));
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
  }
  cp_async_wait(0);

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + row0 + (i / 4) * (WM / 2) + i % 4;
    if (r >= M) continue;
#pragma unroll
    for (int g = 0; g < FN; ++g) {
      const int c = n0 + col0 + g * (WN / 2);
      if (c < N)  // N is a multiple of 4, so c + 3 < N too
        *reinterpret_cast<float4*>(C + (size_t)r * N + c) =
            make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2], acc[i][4 * g + 3]);
    }
  }
}

size_t f32_smem(int bm, int bn, int bk, int stages) {
  return (size_t)stages * ((size_t)bm * (bk + kF32Pad) + (size_t)bk * bn) * sizeof(float);
}

template <int BM, int BN>
cudaError_t launch_f32(const float* A, const float* B, float* C, int M, int N, int K, int bk,
                       int stages, cudaStream_t s) {
  static bool attr_done = false;
  if (!attr_done) {
    // two blocks per SM need the largest shared-memory share of the SM's L1
    cudaError_t err = cudaFuncSetAttribute(mm_f32<BM, BN>,
                                           cudaFuncAttributePreferredSharedMemoryCarveout,
                                           (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
  }
  cudaError_t err = raise_smem_once(mm_f32<BM, BN>, attr_done);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  mm_f32<BM, BN><<<(unsigned)blocks, F32Tile<BM, BN>::kThreads, f32_smem(BM, BN, bk, stages),
                   s>>>(A, B, C, M, N, K, bk, stages);
  return cudaGetLastError();
}

template <int BM>
cudaError_t launch_f32_bn(int bn, const float* A, const float* B, float* C, int M, int N, int K,
                          int bk, int stages, cudaStream_t s) {
#define CASE(BNV) \
  if (bn == BNV) return launch_f32<BM, BNV>(A, B, C, M, N, K, bk, stages, s);
  F32_BN(CASE)
#undef CASE
  return cudaErrorInvalidValue;
}

cudaError_t launch_f32_any(int bm, int bn, const float* A, const float* B, float* C, int M,
                           int N, int K, int bk, int stages, cudaStream_t s) {
#define CASE(BMV) \
  if (bm == BMV) return launch_f32_bn<BMV>(bn, A, B, C, M, N, K, bk, stages, s);
  F32_BM(CASE)
#undef CASE
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

// float32: C [M, N] = A [M, K] . B [K, N] at tile (bm, bn) of the lattice,
// bk 8, 16 or 32, through `stages` (2 .. 4) ring buffers within 227 KB. K and
// N must be multiples of 4 and A, B and C 16-byte aligned (16-byte copies and
// stores). Returns a cudaError_t (0 on success); launches nothing on bad
// arguments.
extern "C" int matmul_f32_launch(const void* A, const void* B, void* C, int M, int N, int K,
                                 int bm, int bn, int bk, int stages, void* stream) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(B) |
                         reinterpret_cast<uintptr_t>(C);
  if (M <= 0 || N <= 0 || K <= 0 || N % 4 || K % 4 || (ptrs & 15) ||
      (bk != 8 && bk != 16 && bk != 32) || stages < 2 || stages > kF32MaxStages ||
      f32_smem(bm, bn, bk, stages) > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  return (int)launch_f32_any(bm, bn, static_cast<const float*>(A), static_cast<const float*>(B),
                             static_cast<float*>(C), M, N, K, bk, stages,
                             static_cast<cudaStream_t>(stream));
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
// out[0 .. 3 * cap): dtype 0 float32 and dtype 1 bfloat16, each with p, q =
// (bm, bn). Returns their number.
extern "C" int matmul_instances(int* out, int cap) {
  int n = 0;
  auto add = [&](int d, int p, int q) {
    if (n < cap) { out[3 * n] = d; out[3 * n + 1] = p; out[3 * n + 2] = q; }
    ++n;
  };
#define ELEM(V) V,
  const int f32_bm[] = {F32_BM(ELEM)}, f32_bn[] = {F32_BN(ELEM)};
#undef ELEM
  for (int bm : f32_bm)
    for (int bn : f32_bn) add(0, bm, bn);
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
