#!/usr/bin/env python3
"""Times of the GroupNorm(+SiLU) kernel K4 of one checkout of the port, at
every shape of `chip_smoke.py`'s ``GN_SHAPES``.

    python scripts/bench_group_norm.py [--root DIR] [--tag NAME] [--out FILE]

``--root`` is the checkout whose ``pcm_tpu_torch`` (and ``chip_smoke``'s
shape list) are imported (default: the one holding this script), so that two
trees, e.g. a parent commit unpacked with ``git archive`` into
``build/parent``, are timed on one card in turns (parent, change, change,
parent: one process each). Per shape ((N, H, W, C), eps, act): the error
against the plain version in fp32 (max |diff| and max |diff| / max |ref|), the
CUDA-event time per call (median over 9 batches of 10 back-to-back calls on
the same input, after 3 warm-ups), K4's device time per call from
``torch.profiler`` (every kernel whose name holds ``gn_``) and each of its
kernels' share, the bound (bytes: x read once, y written once), the
achieved rate of those bytes, and the yardstick ``F.group_norm`` on the NCHW
channels-last view of x (one PyTorch call computing K4's function where act
is None; ``F.silu`` of it, two calls, where act is "silu"), CUDA-event and
device ms. Prints, and appends to ``--out``, one JSON object per shape with
the card's name and power limit, then one with ptxas' registers and spills
of each K4 kernel from the build's ``build.log``. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from bench_attention_bwd import cuda_ms, ptxas_report

K4_KERNELS = r"gn_(?:stats|finalize|norm)_kernel(?:ILb[01]E)?"


def device_ms_by_kernel(fn, calls: int = 10) -> dict:
    """Device ms per call of each kernel ``fn`` launches (``torch.profiler``)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / calls / 1e3 for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--tag", default="change")
    ap.add_argument("--out", default=None, help="JSON-lines file to append to")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_group_norm: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve()))
    from chip_smoke import GN_SHAPES, bound
    from pcm_tpu_torch.ops import common
    from pcm_tpu_torch.ops.groupnorm import group_norm_silu_fwd, group_norm_silu_reference

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    common.lib()
    gen = torch.Generator("cuda").manual_seed(0)
    rows = []
    for shp, eps, act in GN_SHAPES:
        c = shp[-1]
        x = torch.randn(shp, generator=gen, device="cuda").bfloat16()
        gamma = (torch.randn((c,), generator=gen, device="cuda") * 0.5 + 1.0).bfloat16()
        beta = (torch.randn((c,), generator=gen, device="cuda") * 0.5).bfloat16()
        fwd = lambda: group_norm_silu_fwd(x, gamma, beta, 32, eps, act)  # noqa: E731
        xv = x.permute(0, 3, 1, 2)  # NCHW view, channels-last memory
        lib_fn = ((lambda: F.silu(F.group_norm(xv, 32, gamma, beta, eps))) if act
                  else (lambda: F.group_norm(xv, 32, gamma, beta, eps)))
        out = fwd().float()
        ref = group_norm_silu_reference(x.float(), gamma.float(), beta.float(), 32, eps, act)
        err = float((out - ref).abs().max())
        rel = err / float(ref.abs().max())
        del out, ref
        for _ in range(3):  # a trace now and then holds no kernel of the call: retake it
            per_kernel = {m.group(0): v for k, v in device_ms_by_kernel(fwd).items()
                          if (m := re.search(r"gn_\w+_kernel(?:<\w+>)?", k))}
            if per_kernel:
                break
        else:
            raise RuntimeError(f"torch.profiler recorded no K4 kernel at {shp}")
        dev = sum(per_kernel.values())
        b = bound(8.0 * x.numel(), "fp32", 4.0 * x.numel())
        row = {"tag": args.tag, "root": args.root, "kernel": "group_norm_silu",
               "shape": shp, "eps": eps, "act": act, "max_abs_err": err, "rel_max": rel,
               "ms": cuda_ms(fwd), "device_ms": dev,
               "kernels_ms": per_kernel, **b,
               "bound_share": b["bound_ms"] / dev,
               "tb_s": 4.0 * x.numel() / dev / 1e9,  # the bound's bytes over device time
               "library": "F.silu(F.group_norm)" if act else "F.group_norm",
               "library_ms": cuda_ms(lib_fn),
               "library_device_ms": sum(device_ms_by_kernel(lib_fn).values()),
               "card": smi, "build_s": common.build_seconds}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del x, xv, gamma, beta
    rows.append({"tag": args.tag, **ptxas_report(
        (common.library_path().parent / "build.log").read_text(), K4_KERNELS)})
    print(json.dumps(rows[-1]), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
