#!/usr/bin/env python3
"""Data parallelism of the port on N cards: the SDXL cached step per rank and
the sharded serving engine against one card.

    python -m torch.distributed.run --nproc-per-node N scripts/bench_ddp_torch.py step
    python scripts/bench_ddp_torch.py serve --cards N

``step`` (under the launcher; NCCL, a card a rank): ``SDXL_CACHED_STEP`` on
the full-width SDXL-1024 UNet (bf16 frozen weights from ``--seed``) at
``--batch-size`` (4) per card, each rank's rows of the global draws; warm-up
steps, then ``--steps`` timed steps, each to its loss readback. Rank 0 prints
one JSON line: each rank's step ms, the bytes the step all-reduces (the
losses and LoRA gradients as one fp32 buffer), the CUDA-event ms of that
all-reduce alone (`all_reduce_mean` on a tree shaped like the gradients, and
the bare ``all_reduce`` of its buffer), each rank's peak and the launches of
rank 0's timed steps.

``serve``: ``python -m pcm_tpu_torch.serving --family sdxl``'s engine
(`build_engine`, 2 steps, 1024 px) at batch 4 on one card and at batch 4 x N
with ``--data-parallel N``, every card's chunk the same four requests; one
JSON line of each one's batch ms (host clock around a full batch, images on
the host), whether every chunk's images are the one card's bit for bit, and
the launches of the sharded one's timed batches.

Every number needs the card; with none the script exits 2.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def cuda_event_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def step_bench(args) -> None:
    import torch.distributed as dist

    from pcm_tpu_torch.configs.families import SDXL_CACHED_STEP, sdxl_bundle
    from pcm_tpu_torch.core.schedule import make_ddpm_schedule
    from pcm_tpu_torch.ops import launch_counts, reset_launch_counts
    from pcm_tpu_torch.parallel import mesh
    from pcm_tpu_torch.train.distill import build_ddim_distill_step, sample_draws
    from pcm_tpu_torch.train.state import TrainState, make_optimizer

    device = mesh.init_distributed()
    rank, world = mesh.rank(), mesh.world()
    bundle = sdxl_bundle(remat=True)
    frozen, template = bundle.init(torch.Generator(device).manual_seed(args.seed), device,
                                   modules=("unet",))
    cfg = SDXL_CACHED_STEP.distill
    tx = make_optimizer(SDXL_CACHED_STEP.lr)
    step = build_ddim_distill_step(bundle, make_ddpm_schedule(), cfg, tx)
    state = TrainState.create(template, tx)
    n = args.batch_size
    data = torch.Generator(device).manual_seed(args.seed + 1 + rank)  # each rank its rows
    batch = {"latents": torch.randn((n, 128, 128, 4), generator=data, device=device),
             "prompt_embeds": torch.randn((n, 77, 2048), generator=data,
                                          device=device).to(torch.bfloat16),
             "pooled_embeds": torch.randn((n, 1280), generator=data,
                                          device=device).to(torch.bfloat16),
             "time_ids": torch.tensor([SDXL_CACHED_STEP.time_ids] * n, device=device)}
    draws_gen = torch.Generator(device).manual_seed(args.seed + 100)  # the same on every rank
    glob = batch["latents"][:1].expand(n * world, *batch["latents"].shape[1:])

    def one_step():
        nonlocal state
        draws = mesh.local_rows(sample_draws(cfg, draws_gen, glob), rank, world)
        state, metrics = step(state, frozen, batch, [draws])
        return float(metrics["loss"])  # a readback: the step has run

    for _ in range(args.warmup):
        one_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    times, losses = [], []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        losses.append(one_step())
        times.append((time.perf_counter() - t0) * 1000)
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    grads = (torch.zeros((), device=device),
             {k: torch.zeros_like(p) for k, p in state.params.items()})
    nbytes = 4 * (1 + sum(p.numel() for p in state.params.values()))
    flat = torch.zeros(nbytes // 4, device=device)
    reduce_ms = cuda_event_ms(lambda: mesh.all_reduce_mean(grads))
    bare_ms = cuda_event_ms(lambda: dist.all_reduce(flat))
    mine = {"rank": rank, "device": torch.cuda.get_device_name(device),
            "step_ms": times, "median_ms": statistics.median(times), "peak_gib": peak / 2 ** 30,
            "losses": losses}
    gathered = [None] * world
    dist.all_gather_object(gathered, mine)
    if rank == 0:
        print(json.dumps({"world": world, "backend": mesh.backend(), "batch_per_card": n,
                          "allreduce_bytes": nbytes, "allreduce_mean_ms": reduce_ms,
                          "allreduce_bare_ms": bare_ms, "ranks": gathered,
                          "launches": counts}), flush=True)
    dist.destroy_process_group()


def serve_bench(args) -> None:
    from pcm_tpu_torch.ops import launch_counts, reset_launch_counts
    from pcm_tpu_torch.serving.__main__ import build_engine, build_parser, check_args

    out = {"cards": args.cards}
    first = None
    for dp in (1, args.cards):
        ap = build_parser()
        sargs = ap.parse_args(["--family", "sdxl", "--batch-size", str(4 * dp), "--steps", "2",
                               "--seed", str(args.seed), "--data-parallel", str(dp)])
        check_args(ap, sargs)
        engine = build_engine(sargs)
        prompts = [f"a photo of subject {i}" for i in range(4)] * dp
        seeds = list(range(4)) * dp
        engine.generate_batch(prompts, seeds)  # warm-up
        reset_launch_counts()
        ms = []
        for _ in range(args.batches):
            t0 = time.perf_counter()
            images = engine.generate_batch(prompts, seeds)
            ms.append((time.perf_counter() - t0) * 1000)
        first = images if first is None else first
        out[f"dp{dp}"] = {"batch": 4 * dp, "batch_ms": ms, "median_ms": statistics.median(ms),
                          "images": list(images.shape), "launches": launch_counts(),
                          "same_as_one_card": all(bool((images[i:i + 4] == first).all())
                                                  for i in range(0, 4 * dp, 4))}
        del engine
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=["step", "serve"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch-size", type=int, default=4, help="step: per card")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--cards", type=int, default=torch.cuda.device_count(), help="serve")
    ap.add_argument("--batches", type=int, default=3, help="serve: timed batches")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_ddp_torch: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    (step_bench if args.mode == "step" else serve_bench)(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
