#!/usr/bin/env python3
"""Times of the forward kernels K1 (flash attention) and K5 (GEGLU) of one
checkout of the port, at every shape of `chip_smoke.py`'s ``ATTN_SHAPES`` and
``GEGLU_SHAPES`` (SD1.5 at 512 px and SDXL at 1024 px, batch 4; K1 also at
the VAE mid-blocks' single 512-wide head, the SDXL VAE's at 1024 px over
16384 tokens at batch 1 and 4).

    python scripts/bench_forward_kernels.py [--root DIR] [--tag NAME] [--out FILE]

``--root`` is the checkout whose ``pcm_tpu_torch`` (and ``chip_smoke``'s
shape lists) are imported (default: the one holding this script), so that two
trees, e.g. a parent commit unpacked with ``git archive`` into
``build/parent``, are timed on one card in turns (parent, change, change,
parent: one process each). Per shape: the CUDA-event time per call (median
over 9 batches of 10 back-to-back launches, after 3 warm-ups) and the
kernel's device time per call from ``torch.profiler`` (``*_device_ms``),
beside the same card's yardsticks: `scaled_dot_product_attention`'s forward
on (b, h, s, d) copies for K1, and the bare product ``F.linear(x, w)`` (the
cuBLAS GEMM of x against both weight halves, without bias or gate) for K5.
Prints, and appends to ``--out``, one JSON object per shape with the card's
name and power limit, then one with ptxas' registers, spills and
performance notes (C75xx) of each K1 / K5 instance from the build's
``build.log``. Needs a CUDA card.
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

FWD_KERNELS = r"flash_fwd_(?:mma_|d512_)?kernel|geglu_kernel"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--tag", default="change")
    ap.add_argument("--out", default=None, help="JSON-lines file to append to")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_forward_kernels: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve()))
    from chip_smoke import ATTN_SHAPES, GEGLU_SHAPES
    from pcm_tpu_torch.ops import common
    from pcm_tpu_torch.ops.flash_attention import flash_attention_fwd
    from pcm_tpu_torch.ops.geglu import geglu

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    common.lib()
    gen = torch.Generator("cuda").manual_seed(0)
    rows = []

    def emit(row):
        row.update(tag=args.tag, root=args.root, card=smi, build_s=common.build_seconds)
        print(json.dumps(row), flush=True)
        rows.append(row)

    for shp in ATTN_SHAPES:
        b, sq, sk, h, d = shp
        q = torch.randn((b, sq, h, d), generator=gen, device="cuda").bfloat16()
        k, v = (torch.randn((b, sk, h, d), generator=gen, device="cuda").bfloat16() for _ in "kv")
        fwd = lambda: flash_attention_fwd(q, k, v)  # noqa: E731
        qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt)  # noqa: E731
        emit({"kernel": "flash_attention_fwd", "shape": shp, "ms": cuda_ms(fwd),
              "device_ms": device_ms(fwd, ("flash_fwd",)), "sdpa_ms": cuda_ms(sdpa)})
        del q, k, v, qt, kt, vt
    for shp in GEGLU_SHAPES:
        m, kk, f = shp
        x = torch.randn((m, kk), generator=gen, device="cuda").bfloat16()
        w = (torch.randn((2 * f, kk), generator=gen, device="cuda") * kk ** -0.5).bfloat16()
        bias = (torch.randn((2 * f,), generator=gen, device="cuda") * 0.1).bfloat16()
        fwd = lambda: geglu(x, w, bias)  # noqa: E731
        emit({"kernel": "geglu", "shape": shp, "ms": cuda_ms(fwd),
              "device_ms": device_ms(fwd, ("geglu_kernel",)),
              "product_ms": cuda_ms(lambda: F.linear(x, w))})
        del x, w, bias
    rows.append({"tag": args.tag, **ptxas_report(
        (common.library_path().parent / "build.log").read_text(), FWD_KERNELS)})
    print(json.dumps(rows[-1]), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
