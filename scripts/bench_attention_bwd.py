#!/usr/bin/env python3
"""CUDA-event times of the flash-attention backward kernels K2 (dK/dV) and
K3 (dQ) of one checkout of the port, at the training shapes of
`chip_smoke.py` (SD1.5 at 512 px and SDXL at 1024 px, batch 4).

    python scripts/bench_attention_bwd.py [--root DIR] [--tag NAME] [--out FILE]

``--root`` is the checkout whose ``pcm_tpu_torch`` is imported (default: the
one holding this script), so that two trees, e.g. a parent commit unpacked
with ``git archive`` into ``build/parent``, are timed on one card in turns
(parent, change, change, parent: one process each). Each kernel is timed
from the same saved o / lse / delta: the median over 9 batches of 10
back-to-back launches, after 3 warm-ups (`chip_smoke.py` times lone launches,
which at the small shapes carry tens of microseconds of host jitter); and the
kernels' device time per call from ``torch.profiler`` (``*_device_ms``),
which the host's launch time, the bound of the small shapes, leaves out. Prints, and appends to ``--out``, one JSON object per shape with
the card's name and power limit, then one with ptxas' registers, spills and
performance notes (C75xx) of each backward kernel instance from the build's
``build.log``. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

# (b, sq, sk, h, d), as chip_smoke.BWD_SHAPES
SHAPES = [
    (4, 4096, 4096, 8, 40), (4, 4096, 77, 8, 40), (4, 1024, 1024, 8, 80),
    (4, 1024, 77, 8, 80), (4, 256, 256, 8, 160), (4, 256, 77, 8, 160),
    (4, 64, 64, 8, 160), (4, 64, 77, 8, 160),
    (4, 4096, 4096, 10, 64), (4, 4096, 77, 10, 64), (4, 1024, 1024, 20, 64),
    (4, 1024, 77, 20, 64),
]


def cuda_ms(fn, reps: int = 9, batch: int = 10, warmup: int = 3) -> float:
    """Median over ``reps`` of the CUDA-event time of ``batch`` back-to-back
    calls, per call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def device_ms(fn, names, calls: int = 10) -> float:
    """Device time per call of the kernels whose names contain one of
    ``names`` (``torch.profiler``), over ``calls`` calls: the kernels alone,
    without the host's launch time that bounds a small shape."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA and any(n in e.key for n in names))
    return us / calls / 1e3


BWD_KERNELS = r"flash_bwd_(?:dkv|dq)_kernel"


def ptxas_report(build_log: str, kernels: str = BWD_KERNELS) -> dict:
    """Registers and spill bytes of each instance of the kernels whose names
    match ``kernels`` (name and template arguments as the key, e.g.
    ``flash_bwd_dq_kernel<64,64>``), and ptxas' C75xx notes, from an nvcc
    ``-Xptxas -v`` log."""
    def key(name):
        m = re.search(r"(" + kernels + r")((?:ILi\d+E)?(?:Li\d+E)*)", name)
        if not m:
            return None
        args = re.findall(r"Li(\d+)E", m.group(2))
        return m.group(1) + (f"<{','.join(args)}>" if args else "")

    found, notes = {}, []
    for m in re.finditer(r"Compiling entry function '(\S+)' for 'sm_90a'\n(?:.*\n){0,3}?.*?"
                         r"(\d+) bytes spill stores.*\n.*Used (\d+) registers", build_log):
        if key(m.group(1)):
            found[key(m.group(1))] = {"registers": int(m.group(3)), "spill_bytes": int(m.group(2))}
    for m in re.finditer(r"\((C75\d+)\)[^']*'(\S+)'", build_log):
        if key(m.group(2)):
            notes.append(f"{m.group(1)} {key(m.group(2))}")
    return {"ptxas": found, "notes": sorted(set(notes))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--tag", default="change")
    ap.add_argument("--out", default=None, help="JSON-lines file to append to")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_attention_bwd: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve()))
    from pcm_tpu_torch.ops import common
    from pcm_tpu_torch.ops.flash_attention import (attention_delta, flash_attention_bwd_dkv,
                                                   flash_attention_bwd_dq, flash_attention_fwd)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    common.lib()
    gen = torch.Generator("cuda").manual_seed(0)
    rows = []
    for shp in SHAPES:
        b, sq, sk, h, d = shp
        q, do = (torch.randn((b, sq, h, d), generator=gen, device="cuda").bfloat16() for _ in "ab")
        k, v = (torch.randn((b, sk, h, d), generator=gen, device="cuda").bfloat16() for _ in "ab")
        scale = d ** -0.5
        o, lse = flash_attention_fwd(q, k, v)
        delta = attention_delta(o, do)
        dkv = lambda: flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale)  # noqa: E731
        dq = lambda: flash_attention_bwd_dq(q, k, v, do, lse, delta, scale)  # noqa: E731
        row = {"tag": args.tag, "root": args.root, "shape": shp,
               "dkv_ms": cuda_ms(dkv), "dq_ms": cuda_ms(dq),
               "dkv_device_ms": device_ms(dkv, ("flash_bwd_dkv", "dkv_reduce")),
               "dq_device_ms": device_ms(dq, ("flash_bwd_dq",)),
               "card": smi, "build_s": common.build_seconds}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del q, k, v, do, o, lse, delta
    rows.append({"tag": args.tag, **ptxas_report(
        (common.library_path().parent / "build.log").read_text())})
    print(json.dumps(rows[-1]), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
