#!/usr/bin/env python
"""Where the device time of the port's SD1.5 distillation step goes (CUDA only).

  python scripts/profile_train_torch.py [--batch-size 4] [--remat full] [--steps 6]
                                        [--use-8bit-adam] [--seed 0]

Builds the full-width SD1.5 bundle with random weights and the `sd15_4phase`
step (AdamW), feeds it a seeded batch of latents and prompt embeds made on
the card, and times ``--steps`` steps on the host clock (each ends in a
loss readback, a device sync): per-step ms, the median of all but the first
two, and the peak memory. Then it traces one more step with
``torch.profiler``: host wall time, summed kernel time by category (the
port's kernels, GEMMs, convolutions, the rest), the device idle share and
the top kernels, as `profile_serve_torch.py` prints them for serving.
"""

import argparse
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch  # noqa: E402
from profile_serve_torch import trace  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--remat", default="full", choices=["full", "none"])
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--use-8bit-adam", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")

    from pcm_tpu_torch.configs.families import RECIPES, sd15_bundle
    from pcm_tpu_torch.core.schedule import make_ddpm_schedule
    from pcm_tpu_torch.train.distill import build_ddim_distill_step, sample_draws
    from pcm_tpu_torch.train.state import TrainState, make_optimizer

    dev = torch.device("cuda")
    recipe = RECIPES["sd15_4phase"]
    bundle = sd15_bundle(recipe.lora_rank, remat=args.remat == "full")
    gen = torch.Generator(dev).manual_seed(args.seed)
    frozen, lora = bundle.init(gen, dev)
    tx = make_optimizer(recipe.lr, use_8bit=args.use_8bit_adam)
    step = build_ddim_distill_step(bundle, make_ddpm_schedule(), recipe.distill, tx)
    b = args.batch_size
    batch = {"latents": torch.randn((b, 64, 64, 4), generator=gen, device=dev),
             "prompt_embeds": torch.randn((b, 77, 768), generator=gen, device=dev).bfloat16(),
             "uncond_embeds": torch.randn((b, 77, 768), generator=gen, device=dev).bfloat16()}
    box = {"state": TrainState.create(lora, tx)}

    def one_step():
        draws = [sample_draws(recipe.distill, gen, batch["latents"])]
        box["state"], metrics = step(box["state"], frozen, batch, draws)
        float(metrics["loss"])

    label = (f"sd15_4phase step, batch {b} x 512px, remat {args.remat}, "
             f"{'8-bit ' if args.use_8bit_adam else ''}AdamW")
    times = []
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
