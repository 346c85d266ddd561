#!/usr/bin/env python3
"""Times of the fused int8 matmul K6 of one checkout of the port, at every
shape of `chip_smoke.py`'s ``K6_SHAPES`` and at the SDXL-1024 step's heaviest
int8 products.

    python scripts/bench_int8_matmul.py [--root DIR] [--tag NAME] [--out FILE]

``--root`` is the checkout whose ``pcm_tpu_torch`` (and ``chip_smoke``'s
shape list) are imported (default: the one holding this script), so that two
trees, e.g. a parent commit unpacked with ``git archive`` into
``build/parent``, are timed on one card in turns (parent, change, change,
parent: one process each). Per shape (M, K, N): the CUDA-event time per call
(median over 9 batches of 10 back-to-back calls, after 3 warm-ups) and K6's
device time per call from ``torch.profiler`` (every kernel whose name holds
``int8_matmul``: the quantize pass and the product; the quantize pass alone
in ``quantize_device_ms``), the bound (the larger
of the bytes over the memory rate and the int8 operations over the int8
peak), and two yardsticks that do not compute K6's function: cuBLAS's bf16
``F.linear`` on the dequantized weight, and ``torch._int_mm`` on activation
codes quantized beforehand (int8 x int8 -> int32, no scales; needs M > 16).
Prints, and appends to ``--out``, one JSON object per shape with the card's
name and power limit, then one with ptxas' registers, spills and performance
notes (C75xx) of each K6 instance from the build's ``build.log``. Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from bench_attention_bwd import cuda_ms, device_ms, ptxas_report

# the SDXL-1024 step's heaviest int8 products at batch 4 under CFG: the
# feed-forward at 32x32 (in, out) and at 64x64 (in, out)
SDXL_SHAPES = [(8192, 1280, 10240), (8192, 5120, 1280), (32768, 640, 5120), (32768, 2560, 640)]
K6_KERNELS = r"int8_matmul(?:_gemm|_quantize)?_kernel"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--tag", default="change")
    ap.add_argument("--out", default=None, help="JSON-lines file to append to")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_int8_matmul: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve()))
    from chip_smoke import K6_SHAPES, bound
    from pcm_tpu_torch.ops import common
    from pcm_tpu_torch.ops.int8_matmul import fused_quantized_dot_fwd, quantize_rows
    from pcm_tpu_torch.utils.quant import quantize

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    common.lib()
    gen = torch.Generator("cuda").manual_seed(0)
    rows = []
    for shp in [*K6_SHAPES, *SDXL_SHAPES]:
        m, k, n = shp
        x = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
        qt = quantize(torch.randn((n, k), generator=gen, device="cuda") * k ** -0.5)
        values, scale = qt.values, qt.scale.reshape(-1)
        w = (values.float() * scale[:, None]).bfloat16()
        fwd = lambda: fused_quantized_dot_fwd(x, values, scale)  # noqa: E731
        row = {"tag": args.tag, "root": args.root, "kernel": "int8_matmul", "shape": shp,
               "ms": cuda_ms(fwd), "device_ms": device_ms(fwd, ("int8_matmul",)),
               "quantize_device_ms": device_ms(fwd, ("int8_matmul_quantize",)),
               **bound(2.0 * m * k * n, "int8", 2.0 * m * k + n * k + 4.0 * n + 2.0 * m * n),
               "bf16_linear_ms": cuda_ms(lambda: F.linear(x, w))}
        if m > 16:
            xq = quantize_rows(x.float())[0].to(torch.int8)
            row["int_mm_ms"] = cuda_ms(lambda: torch._int_mm(xq, values.t()))
            del xq
        else:
            row["int_mm_ms"] = None  # torch._int_mm takes more than 16 rows
        row.update(card=smi, build_s=common.build_seconds)
        print(json.dumps(row), flush=True)
        rows.append(row)
        del x, qt, values, scale, w
    rows.append({"tag": args.tag, **ptxas_report(
        (common.library_path().parent / "build.log").read_text(), K6_KERNELS)})
    print(json.dumps(rows[-1]), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
