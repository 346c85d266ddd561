#!/usr/bin/env python
"""Where the device time of the port's distillation step goes (CUDA only).

  python scripts/profile_train_torch.py [--family sd15|sdxl] [--batch-size 4]
      [--remat full] [--steps 6] [--use-8bit-adam] [--frozen-weights bf16|int8]
      [--int8-matmul scoped|dense|fused] [--seed 0]

Builds the full-width bundle with random weights and its consistency step
(AdamW): SD1.5 with the `sd15_4phase` recipe at 512 px, or the SDXL-1024
cached step (40 solver steps, 4 phases, w in [6, 7), as `bench.py` runs it
for ``--family sdxl``). With ``--frozen-weights int8`` the frozen weights are
int8 and ``--int8-matmul`` picks the int8 path, as in `python -m
pcm_tpu_torch.train`. It feeds the step a seeded batch of latents and text
embeddings made on the card and times ``--steps`` steps on the host clock
(each ends in a loss readback, a device sync): per-step ms, the median of all
but the first two, and the peak memory. Then it traces one more step with
``torch.profiler``: host wall time, summed kernel time by category (the
port's kernels, GEMMs, convolutions, the rest), the device idle share and
the top kernels, as `profile_serve_torch.py` prints them for serving.
"""

import argparse
import contextlib
import dataclasses
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch  # noqa: E402
from profile_serve_torch import trace  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--family", default="sd15", choices=["sd15", "sdxl"])
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--remat", default="full", choices=["full", "none"])
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--use-8bit-adam", action="store_true")
    ap.add_argument("--frozen-weights", default="bf16", choices=["bf16", "int8"])
    ap.add_argument("--int8-matmul", default=None, choices=["scoped", "dense", "fused"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    if args.int8_matmul and args.frozen_weights != "int8":
        raise SystemExit("--int8-matmul needs --frozen-weights int8")

    from pcm_tpu_torch.configs.families import (RECIPES, SDXL_CACHED_STEP, sd15_bundle,
                                                sdxl_bundle)
    from pcm_tpu_torch.core.schedule import make_ddpm_schedule
    from pcm_tpu_torch.train.distill import build_ddim_distill_step, sample_draws
    from pcm_tpu_torch.train.state import TrainState, make_optimizer
    from pcm_tpu_torch.utils.quant import int8_matmul, quantize_frozen

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(args.seed)
    b = args.batch_size
    remat = args.remat == "full"
    if args.family == "sd15":
        recipe = RECIPES["sd15_4phase"]
        bundle, cfg, lr = sd15_bundle(recipe.lora_rank, remat=remat), recipe.distill, recipe.lr
        batch = {"latents": torch.randn((b, 64, 64, 4), generator=gen, device=dev),
                 "prompt_embeds": torch.randn((b, 77, 768), generator=gen, device=dev).bfloat16(),
                 "uncond_embeds": torch.randn((b, 77, 768), generator=gen, device=dev).bfloat16()}
        label = f"sd15_4phase step, batch {b} x 512px"
    else:
        bundle = sdxl_bundle(64, remat=remat)
        cfg, lr = SDXL_CACHED_STEP.distill, SDXL_CACHED_STEP.lr
        batch = {"latents": torch.randn((b, 128, 128, 4), generator=gen, device=dev),
                 "prompt_embeds": torch.randn((b, 77, 2048), generator=gen,
                                              device=dev).bfloat16(),
                 "pooled_embeds": torch.randn((b, 1280), generator=gen, device=dev).bfloat16(),
                 "time_ids": torch.tensor([SDXL_CACHED_STEP.time_ids] * b, device=dev)}
        label = f"SDXL-1024 cached step, batch {b}"
    frozen, lora = bundle.init(gen, dev)
    if args.frozen_weights == "int8":
        quantize_frozen(frozen)
    if args.int8_matmul == "scoped":
        cfg = dataclasses.replace(cfg, int8_no_grad_fwd=True)
    tx = make_optimizer(lr, use_8bit=args.use_8bit_adam)
    step = build_ddim_distill_step(bundle, make_ddpm_schedule(), cfg, tx)
    box = {"state": TrainState.create(lora, tx)}
    run_ctx = (int8_matmul(args.int8_matmul) if args.int8_matmul in ("dense", "fused")
               else contextlib.nullcontext())

    def one_step():
        draws = [sample_draws(cfg, gen, batch["latents"])]
        box["state"], metrics = step(box["state"], frozen, batch, draws)
        float(metrics["loss"])

    label += (f", remat {args.remat}, {args.frozen_weights} frozen weights"
              + (f", int8 matmul {args.int8_matmul}" if args.int8_matmul else "")
              + f", {'8-bit ' if args.use_8bit_adam else ''}AdamW")
    times = []
    with run_ctx:
        for _ in range(max(args.steps, 3)):
            t0 = time.perf_counter()
            one_step()
            times.append((time.perf_counter() - t0) * 1000)
        print(f"== {label}: step ms {[round(t, 1) for t in times]}, steady median "
              f"{statistics.median(times[2:]):.1f} ms, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        trace(one_step, label)
    print(torch.cuda.get_device_name(0))


if __name__ == "__main__":
    main()
