"""Write ``wgmma_ops.cuh``: one ``Wgmma<N>::mma`` per tile width N of the
bf16 matmul's lattice (``ops/matmul.py::BF16_BN``).

A ``wgmma.mma_async`` instruction names each of its N / 2 accumulator
registers per thread as an operand, so every width needs its own asm
statement; this script spells them out. Run it after changing the list:

    python vae_extent_search_tpu_torch/csrc/gen_wgmma.py
"""

from pathlib import Path

WIDTHS = (16, 32, 64, 96, 128, 160, 192, 224, 256)
HEADER = Path(__file__).resolve().parent / "wgmma_ops.cuh"


def op(n: int) -> str:
    regs = n // 2
    outs = ", ".join(f"%{i}" for i in range(regs))
    cons = ",\n          ".join(
        ", ".join(f'"+f"(d[{i}])' for i in range(j, min(j + 4, regs)))
        for j in range(0, regs, 4))
    return f"""template <>
struct Wgmma<{n}> {{
  static __device__ __forceinline__ void mma(float* d, uint64_t a, uint64_t b) {{
    asm volatile(
        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{regs + 2}, 0;\\n"
        "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
        "{{{outs}}}, %{regs}, %{regs + 1}, p, 1, 1, 0, 1;\\n}}\\n"
        : {cons}
        : "l"(a), "l"(b), "r"(1));
  }}
}};
"""


def render() -> str:
    body = "\n".join(op(n) for n in WIDTHS)
    return f"""// Generated by gen_wgmma.py (do not edit): wgmma.mma_async.m64nNk16,
// D (f32, registers) += A (bf16, K-major, shared memory) . B (bf16,
// MN-major through the transpose bit, shared memory), A and B read through
// matrix descriptors, for each N of the bf16 matmul's lattice. Thread t of
// the warpgroup holds d[4i + 0..1] at row 16 (t / 32) + (t % 32) / 4,
// columns 8i + 2 (t % 4) + 0..1, and d[4i + 2..3] eight rows below.
#pragma once
#include <stdint.h>

template <int N>
struct Wgmma;

{body}"""


if __name__ == "__main__":
    HEADER.write_text(render())
