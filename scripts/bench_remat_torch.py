#!/usr/bin/env python3
"""The remat policies of the port on a card: what ``F.linear`` dispatches
under a policy, each setting's step, and the host cost of K1's op and of
keeping the RNG state a region.

    python scripts/bench_remat_torch.py ops [--device cpu|cuda]
    python scripts/bench_remat_torch.py step [--family sdxl,sd3] [--runs 3] [--out FILE]

``ops`` prints, one JSON line each, the aten ops that ``F.linear`` and the
port's ``LoRALinear`` reach under the selective-checkpoint mode of a
``dots`` policy (`pcm_tpu_torch/ops/common.py:RematPolicy`), with the
policy's decision for each product: a 3-D input contiguous, sliced along
the sequence (the MMDiT's image and context halves of the joint attention's
output) and permuted, with and without a bias, the weight frozen or not; in
bf16 on the card, fp32 on the CPU.

``step`` runs `chip_smoke.py`'s phase ``remat`` alone (no other work on the
card): the SDXL-1024 cached step at batch 4 (bf16, full width, weights from
``--seed``) and SD3's at batch 2 under each setting of `chip_smoke.REMAT_SDXL`
/ `REMAT_SD3`, ``--runs`` times each, and prints one JSON line a setting:
the step ms of each run (host clock from a synchronized start to the loss
readback), the peak of the last (``max_memory_allocated``), K1's forward
launches a step and the largest difference of the loss and LoRA gradients
from the reference's first run. Then, on the SDXL step under ``full`` at
``module`` and at ``block`` granularity, three variants in turns, ``--runs``
steps a turn, each turn's median step ms (`variant_turns`): as the port runs,
K1 called directly and not through its op (`ops/flash_attention.py:
flash_fwd`), and each region keeping the RNG state for its recompute (torch's
default). Needs a card.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _emit(row: dict, out) -> None:
    line = json.dumps(row)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def ops(device: str, out) -> None:
    import torch.nn.functional as F
    from torch.utils.checkpoint import create_selective_checkpoint_contexts

    from pcm_tpu_torch.lora.layers import LoRALinear
    from pcm_tpu_torch.ops.common import resolve_remat_policy

    policy = resolve_remat_policy("dots")
    dev = torch.device(device)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    seen = []

    def recording(ctx, func, *args, **kwargs):
        decision = policy(ctx, func, *args, **kwargs)
        if not ctx.is_recompute:
            seen.append(f"{func}{'*' if policy.saves(func, *args) else ''}")
        return decision

    base = torch.randn(2, 24, 64, device=dev, dtype=dtype)
    inputs = {"contiguous": base[:, :16], "sliced": base[:, 8:],
              "permuted": base[:, :16].transpose(0, 1).contiguous().transpose(0, 1)}
    inputs["contiguous"] = inputs["contiguous"].contiguous()
    for layout, x in inputs.items():
        for bias in (False, True):
            for trainable in (False, True):
                w = torch.randn(32, 64, device=dev, dtype=dtype, requires_grad=trainable)
                b = torch.randn(32, device=dev, dtype=dtype) if bias else None
                seen.clear()
                fwd, _ = create_selective_checkpoint_contexts(recording)
                with fwd:
                    F.linear(x, w, b)
                _emit({"what": "F.linear", "device": torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu", "torch": torch.__version__,
                       "input": layout, "bias": bias, "weight_requires_grad": trainable,
                       "ops": list(seen), "kept": "ops marked * (a dots policy keeps them)"},
                      out)
    layer = LoRALinear(64, 32).to(dev, dtype).requires_grad_(False)
    layer.lora_key = "l"
    lora = {"l.lora_a": torch.randn(4, 64, device=dev, requires_grad=True),
            "l.lora_b": torch.randn(32, 4, device=dev, requires_grad=True)}
    for layout, x in inputs.items():
        seen.clear()
        fwd, _ = create_selective_checkpoint_contexts(recording)
        with fwd:
            layer(x, lora)
        _emit({"what": "LoRALinear", "input": layout, "ops": list(seen)}, out)


def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()


def step(families, runs: int, seed: int, out) -> None:
    import chip_smoke as cs
    from pcm_tpu_torch.configs.families import sd3_bundle, sdxl_bundle
    from pcm_tpu_torch.ops import common

    common.lib()
    card = {"card": _smi(), "torch": torch.__version__}
    gen = torch.Generator("cuda").manual_seed(seed)
    for family in families:
        sd3 = family == "sd3"
        bundle = sd3_bundle(remat=True) if sd3 else sdxl_bundle(remat=True)
        frozen, template = bundle.init(gen, torch.device("cuda"),
                                       modules=("mmdit",) if sd3 else ("unet",))
        module = frozen["mmdit" if sd3 else "unet"]
        r = cs.remat_runs(bundle, frozen, template, gen, cs.REMAT_SD3 if sd3 else cs.REMAT_SDXL,
                          runs=runs)
        for i in range(0, len(r["rows"]), runs):
            rows = r["rows"][i:i + runs]
            _emit({"family": family, "batch": 2 if sd3 else 4, "setting": rows[0]["setting"],
                   "step_ms": [round(x["step_ms"], 1) for x in rows],
                   "peak_gib": round(rows[-1]["peak_gib"], 3), "k1_launches": rows[-1]["k1"],
                   "max_diff": max(max(x["diff"].values()) for x in rows),
                   "attentions_a_forward": cs.attentions(module), **card}, out)
        if not sd3:
            for setting in ("full/module", "full/block"):
                _emit(variant_turns(bundle, frozen, template, gen, setting, runs, cs) | card, out)
        del frozen, template, module
        torch.cuda.empty_cache()


def variant_turns(bundle, frozen, template, gen, setting: str, runs: int, cs) -> dict:
    """The SDXL step under ``setting`` in turns (``op``, ``direct``,
    ``rng_kept``, ``rng_kept``, ``direct``, ``op``), each turn's median step
    ms: ``op`` as the port runs, ``direct`` with K1 called directly and not
    through its op, ``rng_kept`` with each region keeping the RNG state for
    its recompute (torch's default, the port's remat before it stopped)."""
    import torch.utils.checkpoint as tuc

    fa = importlib.import_module("pcm_tpu_torch.ops.flash_attention")
    op, real = fa.flash_fwd, tuc.checkpoint
    turns = {"op": [], "direct": [], "rng_kept": []}
    try:
        for name in ("op", "direct", "rng_kept", "rng_kept", "direct", "op"):
            fa.flash_fwd = fa.flash_attention_fwd if name == "direct" else op
            tuc.checkpoint = real if name != "rng_kept" else (
                lambda fn, *a, **kw: real(fn, *a, **(kw | {"preserve_rng_state": True})))
            r = cs.remat_runs(bundle, frozen, template, gen, (setting,), runs=runs)
            turns[name].append(round(statistics.median(x["step_ms"] for x in r["rows"]), 1))
    finally:
        fa.flash_fwd, tuc.checkpoint = op, real
    return {"family": "sdxl", "batch": 4, "setting": setting,
            **{f"{k}_ms": v for k, v in turns.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=["ops", "step"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--family", default="sdxl,sd3")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="append the JSON lines to this file too")
    args = ap.parse_args(argv)
    if args.what == "ops":
        ops(args.device, args.out)
        return 0
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the steps are timed on a card")
    t0 = time.perf_counter()
    step(args.family.split(","), args.runs, args.seed, args.out)
    print(f"# {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
