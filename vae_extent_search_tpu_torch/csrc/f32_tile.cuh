// The float32 CUDA-core machinery that the f32 matmul (matmul.cu) and the
// f32 conv2d (conv2d.cu) share: the thread tiling of a [BM, BN] output tile
// and the cp.async copies of their shared-memory rings. All of it sits in
// an anonymous namespace: each source that includes it gets its own copy
// and exports none of it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kF32Pad = 4;        // floats of padding per A row in shared memory
constexpr int kF32MaxStages = 4;

// A (BM, BN) instance's thread tile 8 x TN, warp tile WM x WN and lane grid
// LM x LN (LM * LN = 32, each lane two 4-row blocks and TN/4 4-column ones).
template <int BM, int BN>
struct F32Tile {
  static constexpr int kTN = (BM * BN / 64) % 32 == 0 ? 8 : 4;
  static constexpr int kWM = kTN == 4 || BN % 64 == 0 ? 32 : 64;
  static constexpr int kWN = kTN == 4 ? 32 : 2048 / kWM;
  static constexpr int kLM = kWM / 8, kLN = 32 / kLM;
  static constexpr int kThreads = BM * BN / (8 * kTN);
  // blocks per SM asked of ptxas: two, unless the registers that leaves
  // (168 at up to 192 threads, 96 at 288) are too few for 8 x 8
  // accumulators and their fragments (then one block of 256 threads)
  static constexpr int kMinBlocks = kTN == 8 && kThreads > 192 ? 1 : 2;
  static_assert(BM % kWM == 0 && BN % kWN == 0 && kLN * kTN == kWN, "warp tiling");
};

// 16 bytes from global to shared memory, or 16 zero bytes where !full
// (src-size 0: nothing is read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most `pending` (0, 1 or 2) of this thread's groups are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending >= 2)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else if (pending == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

}  // namespace
