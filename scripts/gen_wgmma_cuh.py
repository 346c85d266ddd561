#!/usr/bin/env python3
"""Writes `pcm_tpu_torch/csrc/wgmma_ops.cuh`: inline-PTX wrappers of Hopper's
``wgmma.mma_async`` m64nNk16 (bf16 in, fp32 accumulate) and m64nNk32 (s8 in,
exact s32 accumulate) for the widths N the port's kernels use. Each wrapper
lists its N/2 accumulator registers one by one, which the preprocessor cannot
generate, hence this script.

    python scripts/gen_wgmma_cuh.py

- ``mma_ss(float (&d)[N/2], desc_a, desc_b, scale_d)``: A and B from shared
  memory, both K-major.
- ``mma_rs(float (&d)[N/2], const uint32_t (&a)[4], desc_b, scale_d)``: A from
  registers (the mma.m16n8k16 A fragment of each warp's 16 rows), B from
  shared memory MN-major (the transpose flag for 16-bit types).
- ``mma_ss(int (&d)[N/2], desc_a, desc_b, scale_d)``: s8 x s8 -> s32, A and B
  K-major in shared memory (8-bit wgmma takes no other layout).
``scale_d == 0`` overwrites the accumulator, 1 adds to it.
"""

from pathlib import Path

SS_WIDTHS = (32, 64, 128)
RS_WIDTHS = (16, 32, 48, 64, 80, 96, 128, 160, 256)
S8_SS_WIDTHS = (128,)
OUT = Path(__file__).resolve().parents[1] / "pcm_tpu_torch" / "csrc" / "wgmma_ops.cuh"


def _regs(n: int) -> str:
    return ", ".join(f"%{i}" for i in range(n))


def _outs(n: int, reg: str = "+f") -> str:
    return ", ".join(f'"{reg}"(d[{i}])' for i in range(n))


def ss(n: int) -> str:
    r = n // 2
    return f'''__device__ __forceinline__ void mma_ss(float (&d)[{r}], uint64_t da, uint64_t db,
                                       int scale_d) {{
  asm volatile(
      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 2}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
      "{{{_regs(r)}}}, %{r}, %{r + 1}, p, 1, 1, 0, 0;\\n}}\\n"
      : {_outs(r)}
      : "l"(da), "l"(db), "r"(scale_d));
}}
'''


def ss_s8(n: int) -> str:
    r = n // 2
    return f'''__device__ __forceinline__ void mma_ss(int (&d)[{r}], uint64_t da, uint64_t db,
                                       int scale_d) {{
  asm volatile(
      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 2}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k32.s32.s8.s8 "
      "{{{_regs(r)}}}, %{r}, %{r + 1}, p;\\n}}\\n"
      : {_outs(r, "+r")}
      : "l"(da), "l"(db), "r"(scale_d));
}}
'''


def rs(n: int) -> str:
    r = n // 2
    return f'''__device__ __forceinline__ void mma_rs(float (&d)[{r}], const uint32_t (&a)[4],
                                       uint64_t db, int scale_d) {{
  asm volatile(
      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 5}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
      "{{{_regs(r)}}}, {{%{r}, %{r + 1}, %{r + 2}, %{r + 3}}}, %{r + 4}, p, 1, 1, 1;\\n}}\\n"
      : {_outs(r)}
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}}
'''


def main() -> None:
    parts = [
        "// Generated by scripts/gen_wgmma_cuh.py: do not edit by hand.\n"
        "// wgmma.mma_async m64nNk16, bf16 x bf16 -> fp32. mma_ss: A and B K-major in\n"
        "// shared memory; mma_rs: A in registers, B MN-major in shared memory.\n"
        "// mma_ss on an int accumulator: m64nNk32, s8 x s8 -> s32, both K-major.\n"
        "// The accumulator array's length (N / 2) selects the width N.\n"
        "#pragma once\n\n#include <stdint.h>\n\nnamespace pcm {\nnamespace wg {\n"
    ]
    parts += [ss(n) for n in SS_WIDTHS]
    parts += [rs(n) for n in RS_WIDTHS]
    parts += [ss_s8(n) for n in S8_SS_WIDTHS]
    parts.append("}  // namespace wg\n}  // namespace pcm\n")
    OUT.write_text("\n".join(parts))


if __name__ == "__main__":
    main()
