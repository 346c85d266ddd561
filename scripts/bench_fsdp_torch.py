#!/usr/bin/env python3
"""FSDP of the port's frozen weights on cards: the training steps of SD1.5
and SD3 on every rank of a ``data x fsdp`` layout, or in one process.

    python scripts/bench_fsdp_torch.py --family sd15,sd3 --out DIR [--cache DIR]
    python -m torch.distributed.run --nproc-per-node N scripts/bench_fsdp_torch.py \\
        --family sd15,sd3 --fsdp F --out DIR [--cache DIR]

Without the launcher the steps run in one process with no process group and
whole frozen weights (the reference); under it the ranks form a ``N/F x F``
layout (`parallel/mesh.py:make_mesh`; NCCL with a card a rank, gloo when
ranks share a card) and the frozen weights are sharded over ``fsdp``
(`parallel/fsdp.py:shard_fsdp`, the default ``min_size`` 2**16). The steps
are the dry run's (`pcm_tpu_torch/dryrun.py:step_runner`, its Adam rate and
epsilon) at full published widths, weights from ``--seed``, remat on
(``--no-remat``: off). The global batch holds 2 rows a data index (bs 2 a
rank), the same on every rank, and every rank takes its data index's rows
of it and of the global draws.

``sd15``: on a cached batch at 512 px (the first rows of ``--cache``'s
first shard, or seeded 64 x 64 x 4 latents and (77, 768) embeds), zero
uncond: the ``sd15_4phase`` consistency step (``ddim``), the
``sd15_2phase_adv`` G step then D step on the SD1.5 heads (``adv_g_d``), the
fused pair (``adv_fused``), and the consistency step on int8 frozen weights
under ``--int8-matmul fused`` (``ddim_int8``). ``sd3``: the flow step of
``SD3_CACHED_STEP`` on ``SD3_ADV_LORA_TARGETS`` from 1024-px pixels and
token ids, so the VAE encoder, CLIP-L, CLIP-bigG and T5-XXL run on sharded
weights too (``flow``);
``--mmdit-layers`` / ``--t5-layers`` cut its depth, widths stay.

The consistency steps (``ddim``, ``flow``) run ``--repeats`` times from
the same state (the first result is kept), the others once. Each run is
timed: host ms from a synchronized start to the loss readback, the peak
(``max_memory_allocated``), the all-gathers and the bytes they rebuilt, the
most gathered bytes alive, and the TMA maps the kernels encoded
(`ops/common.py:tma_encodes`). Each rank writes ``<out>/rank<r>.pt``: the
losses, the SHA-256 of each new LoRA factor and head parameter, the frozen
bytes it holds at rest beside the unsharded bytes, its layout, backend and
card, the kernels' launches of all its jobs, and whether gloo's all-gather
took CUDA tensors. Needs a card.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _host(tree: dict) -> dict:
    return {k: v.detach().cpu() for k, v in tree.items()}


def digest(tree: dict) -> dict:
    """SHA-256 of each tensor's bytes: equal digests, equal bits (the SD1.5
    heads hold 2.65 GB of fp32, too much to write a job)."""
    return {k: hashlib.sha256(v.detach().reshape(-1).view(torch.uint8).cpu().numpy()).hexdigest()
            for k, v in tree.items()}


def gloo_takes_cuda(layout) -> str:
    """Whether gloo's all-gather takes CUDA tensors ("yes" or its error)."""
    from pcm_tpu_torch.parallel.fsdp import all_gather

    t = torch.ones(4, dtype=torch.uint8, device="cuda")
    out = torch.empty(4 * layout.fsdp, dtype=torch.uint8, device="cuda")
    try:
        all_gather(out, t, layout.fsdp_group)
        return "yes"
    except Exception as e:  # the answer is the point
        return f"no: {type(e).__name__}: {str(e)[:200]}"


def sd15_batch(args, n: int, dev: torch.device) -> dict:
    if args.cache:
        with np.load(os.path.join(args.cache, "shard_00000.npz")) as z:
            lat, emb = z["latents"][:n], z["prompt_embeds"][:n]
    else:
        rng = np.random.default_rng(args.seed + 1)
        lat = rng.standard_normal((n, 64, 64, 4)).astype(np.float16)
        emb = rng.standard_normal((n, 77, 768)).astype(np.float16)
    batch = {"latents": torch.from_numpy(lat).to(dev, torch.bfloat16),
             "prompt_embeds": torch.from_numpy(emb).to(dev, torch.bfloat16)}
    batch["uncond_embeds"] = torch.zeros_like(batch["prompt_embeds"])
    return batch


def sd3_batch(args, n: int, dev: torch.device) -> dict:
    g = torch.Generator().manual_seed(args.seed + 1)
    return {"pixel_values": (torch.rand(n, 1024, 1024, 3, generator=g) * 2 - 1).to(dev),
            "input_ids": torch.randint(0, 49408, (n, 77), generator=g).to(dev),
            "input_ids_2": torch.randint(0, 49408, (n, 77), generator=g).to(dev),
            "input_ids_3": torch.randint(0, 32128, (n, 77), generator=g).to(dev),
            "uncond_embeds": torch.zeros(n, 154, 4096, dtype=torch.bfloat16, device=dev),
            "uncond_pooled": torch.zeros(n, 2048, dtype=torch.bfloat16, device=dev)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--family", required=True, help="sd15, sd3 or both: sd15,sd3")
    ap.add_argument("--fsdp", type=int, default=1, help="ranks a frozen weight is split over")
    ap.add_argument("--out", required=True, help="directory of the rank<r>.pt files")
    ap.add_argument("--cache", default=None, help="sd15: a cached-latents directory")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeats", type=int, default=2, help="runs of ddim / flow")
    ap.add_argument("--mmdit-layers", type=int, default=None)
    ap.add_argument("--t5-layers", type=int, default=None)
    ap.add_argument("--no-remat", action="store_true",
                    help="no checkpointing: the student's gathered weights live to the backward")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_fsdp_torch: needs a CUDA device", file=sys.stderr)
        return 2

    from pcm_tpu_torch import dryrun
    from pcm_tpu_torch.ops import common, launch_counts, reset_launch_counts
    from pcm_tpu_torch.parallel import fsdp, mesh

    launched = os.environ.get("RANK") is not None
    dev = mesh.init_distributed() if launched else torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    layout = mesh.make_mesh(mesh.world() // args.fsdp, args.fsdp)
    common.lib()
    n = 2 * layout.data
    gloo_cuda = gloo_takes_cuda(layout) if mesh.backend() == "gloo" and layout.fsdp > 1 else None
    sizes = dryrun.Sizes(tiny=False, dtype=torch.bfloat16, remat=not args.no_remat,
                         min_size=2 ** 16, int8_min_size=2 ** 16,
                         mmdit_layers=args.mmdit_layers, t5_layers=args.t5_layers)

    def timed(job: str, run, frozen) -> dict:
        """``run`` (`dryrun.step_runner`) on ``frozen``, ``--repeats`` times
        for the consistency steps, else once; the first result kept."""
        rec = {"ms": [], "peak_bytes": [], "gathers": [], "gathered_bytes": [],
               "peak_gathered_bytes": [], "tma_encodes": []}
        for i in range(args.repeats if job in ("ddim", "flow") else 1):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            fsdp.reset_gather_stats()
            tma0 = common.tma_encodes()
            t0 = time.perf_counter()
            m, g, d = run(frozen)
            losses = {k: float(v) for k, v in m.items()}  # the readback: the step has run
            rec["ms"].append((time.perf_counter() - t0) * 1000)
            s = fsdp.gather_stats()
            rec["peak_bytes"].append(torch.cuda.max_memory_allocated(dev))
            rec["gathers"].append(s["gathers"])
            rec["gathered_bytes"].append(s["gathered_bytes"])
            rec["peak_gathered_bytes"].append(s["peak_live_bytes"])
            rec["tma_encodes"].append(common.tma_encodes() - tma0)
            if i == 0:
                rec.update(losses=losses, metrics=_host(m), params=digest(g.params),
                           d_params=digest(d.params) if d is not None else None)
        if mesh.is_main():
            print(f"# {job}: losses {rec['losses']} ms {[round(x, 1) for x in rec['ms']]}",
                  flush=True)
        return rec

    out = {"layout": (layout.data, layout.fsdp, layout.data_index, layout.fsdp_index),
           "backend": mesh.backend(), "card": torch.cuda.get_device_name(dev),
           "gloo_cuda_gather": gloo_cuda, "jobs": {}, "held_bytes": {}}
    reset_launch_counts()
    for family in args.family.split(","):
        bundle = dryrun.family_bundle(family, sizes)
        glob = (sd3_batch if family == "sd3" else sd15_batch)(args, n, dev)
        frozen = None
        for job in dryrun.FAMILY_STEPS[family]:
            int8 = job == "ddim_int8"
            if frozen is None or int8:
                frozen = template = None
                torch.cuda.empty_cache()
                frozen, template, whole = dryrun.sharded_frozen(bundle, sizes, layout, dev,
                                                                args.seed, int8)
                torch.cuda.synchronize()
                out["held_bytes"][f"{family}_{'int8' if int8 else 'bf16'}"] = (
                    fsdp.held_bytes(frozen), whole)
            run = dryrun.step_runner(job, bundle, layout, glob, template, args.seed, tiny=False)
            out["jobs"][job] = timed(job, run, frozen)
            del run
        del frozen, template
        torch.cuda.empty_cache()
    out["launches"] = launch_counts()
    os.makedirs(args.out, exist_ok=True)
    torch.save(out, os.path.join(args.out, f"rank{mesh.rank()}.pt"))
    if launched:
        mesh.barrier("fsdp bench done")
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
