#!/usr/bin/env python
"""Where the device time of the port's distillation step goes (CUDA only).

  python scripts/profile_train_torch.py [--family sd15|sdxl|sd3] [--batch-size 4]
      [--remat full] [--steps 6] [--use-8bit-adam] [--frozen-weights bf16|int8]
      [--int8-matmul scoped|dense|fused] [--adv fresh|fused] [--pixels] [--seed 0]

Builds the full-width bundle with random weights and its consistency step
(AdamW): SD1.5 with the `sd15_4phase` recipe at 512 px, or the SDXL-1024
cached step (40 solver steps, 4 phases, w in [6, 7), as `bench.py` runs it
for ``--family sdxl``), or the SD3 cached step (`SD3_CACHED_STEP`: 100 Euler
solver steps, 4 phases, fixed w = 3, rank-32 LoRA, zero uncond; its recipes'
batch is 2). With ``--frozen-weights int8`` the frozen weights are
int8 and ``--int8-matmul`` picks the int8 path, as in `python -m
pcm_tpu_torch.train`. With ``--adv`` it takes the adversarial recipe's
updates instead (``sd15_2phase_adv`` or ``sdxl_4phase_adv``, the heads
drawn from the seed): one "step" is then a pair, a D step and a G step on
their own draws (``fresh``) or one fused pair (``fused``), two global steps
of the trainer. It feeds the step a seeded batch of latents and text
embeddings made on the card, or with ``--pixels`` a seeded batch of pixels
and hashed caption ids (SD1.5 at 512 px; SDXL at 1024 px with ``--adv``, its
only recipe, and uncropped ``time_ids``), which every step (each D and G
step) encodes with the VAE encoder (a posterior sample, in the CLI's chunks:
32, or 1 at 1024 px) and the text towers as ``--train-data-dir`` runs do;
and times ``--steps`` steps on the host clock
(each ends in a loss readback, a device sync): per-step ms, the median of all
but the first two, and the peak memory. Then it traces one more step with
``torch.profiler``: host wall time, summed kernel time by category (the
port's kernels, GEMMs, convolutions, the rest), the device idle share and
the top kernels, as `profile_serve_torch.py` prints them for serving, and
the device time of the kernels that GroupNorm's backward (autograd of its
plain version, no kernel of its own) launches, under a
``torch.profiler.record_function`` scope put around
`GroupNormSiLUFn.backward` for this step only. Last,
one more step with every kernel wrapper wrapped (`bound_tally`) prints the
step's launches and least time by kernel: the sum over its launches of
`chip_smoke.bound` at each call's own shapes; with ``--pixels`` also those of
one encode alone.
"""

import argparse
import collections
import contextlib
import dataclasses
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch  # noqa: E402
from profile_serve_torch import trace  # noqa: E402


def bound_tally():
    """Wraps each kernel's wrapper so that every launch adds the least time
    the card could take for its call (`chip_smoke.bound`: each input read
    once and each output written once over the memory rate, or the
    operations over the peak rate of their type, whichever is larger) to a
    tally by kernel. Returns the tally and a function that unwraps them."""
    import importlib

    import chip_smoke as cs
    from pcm_tpu_torch.ops import common

    # the modules (the package exports functions of the same names)
    fa, gg, gn, i8 = (importlib.import_module(f"pcm_tpu_torch.ops.{m}")
                      for m in ("flash_attention", "geglu", "groupnorm", "int8_matmul"))

    tally = collections.Counter()

    def attn(products, outputs):
        return lambda q, k, *_: cs.attn_bound(
            (q.shape[0], q.shape[1], k.shape[1], q.shape[2], q.shape[3]), products, outputs)

    def geglu(x, w, *_):
        k, f = x.shape[-1], w.shape[0] // 2
        m = x.numel() // k
        return cs.bound(4.0 * m * k * f, "bf16", 2.0 * (m * k + 2 * f * k + 2 * f + m * f))

    def group_norm(x, *_):  # read x, write y (bf16 or fp32); ~8 fp32 ops an element
        return cs.bound(8.0 * x.numel(), "fp32", 2.0 * x.element_size() * x.numel())

    def int8(x, values, *_):
        k, n = x.shape[-1], values.shape[0]
        m = x.numel() // k
        return cs.bound(2.0 * m * k * n, "int8", 2.0 * m * k + n * k + 4.0 * n + 2.0 * m * n)

    def wrap(fn, kernel, cost):
        def counted(*a, **kw):
            name = kernel
            if kernel == "group_norm_silu" and a[0].dtype == torch.float32:
                name = "group_norm_silu_fp32"  # K4's fp32 instance counts apart
            before = common.launch_counts()[name]
            out = fn(*a, **kw)
            launched = common.launch_counts()[name] - before
            if launched:
                tally[name + " launches"] += launched
                tally[name] += launched * cost(*a)["bound_ms"]
            return out
        return counted

    patches = [(fa, "flash_attention_fwd", attn(2, 1)),
               (fa, "flash_attention_bwd_dkv", attn(4, 2)),
               (fa, "flash_attention_bwd_dq", attn(3, 1)),
               (gn, "group_norm_silu_fwd", group_norm), (gg, "geglu_fwd", geglu)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    kernel = {"group_norm_silu_fwd": "group_norm_silu", "geglu_fwd": "geglu"}
    for mod, name, cost in patches:
        setattr(mod, name, wrap(getattr(mod, name), kernel.get(name, name), cost))
    int8_defaults = i8.Int8MatmulFn.forward.__defaults__  # K6 is its forward's default
    i8.Int8MatmulFn.forward.__defaults__ = (wrap(int8_defaults[0], "int8_matmul", int8),)

    def unwrap():
        for mod, name, fn in saved:
            setattr(mod, name, fn)
        i8.Int8MatmulFn.forward.__defaults__ = int8_defaults
    return tally, unwrap


GN_BWD_SCOPE = "K4 group norm backward (plain autograd)"


@contextlib.contextmanager
def gn_backward_scope():
    """`GroupNormSiLUFn.backward` inside a profiler scope named
    `GN_BWD_SCOPE` within the context."""
    from pcm_tpu_torch.ops.groupnorm import GroupNormSiLUFn

    plain = GroupNormSiLUFn.backward

    def scoped(ctx, g):
        with torch.profiler.record_function(GN_BWD_SCOPE):
            return plain(ctx, g)

    GroupNormSiLUFn.backward = staticmethod(scoped)
    try:
        yield
    finally:
        GroupNormSiLUFn.backward = staticmethod(plain)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--family", default="sd15", choices=["sd15", "sdxl", "sd3"])
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--remat", default="full", choices=["full", "none"])
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--use-8bit-adam", action="store_true")
    ap.add_argument("--frozen-weights", default="bf16", choices=["bf16", "int8"])
    ap.add_argument("--int8-matmul", default=None, choices=["scoped", "dense", "fused"])
    ap.add_argument("--adv", default=None, choices=["fresh", "fused"],
                    help="the adversarial recipe's D and G updates, a pair a step")
    ap.add_argument("--pixels", action="store_true",
                    help="from pixels and caption ids (the VAE encoder and the text towers "
                         "every step)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if args.pixels and args.family == "sdxl" and not args.adv:
        raise SystemExit("--pixels with --family sdxl needs --adv (sdxl_4phase_adv)")
    if args.family == "sd3" and (args.pixels or args.adv or args.frozen_weights == "int8"):
        raise SystemExit("--family sd3 profiles the bf16 consistency step on cached latents")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    if args.int8_matmul and args.frozen_weights != "int8":
        raise SystemExit("--int8-matmul needs --frozen-weights int8")

    from pcm_tpu_torch.configs.families import (RECIPES, SD3_CACHED_STEP,
                                                SDXL_CACHED_STEP, disc_config, sd3_bundle,
                                                sd15_bundle, sdxl_bundle)
    from pcm_tpu_torch.core.schedule import make_ddpm_schedule, make_flow_schedule
    from pcm_tpu_torch.train import adv
    from pcm_tpu_torch.train.distill import (build_ddim_distill_step, build_flow_distill_step,
                                             sample_draws)
    from pcm_tpu_torch.train.state import TrainState, make_optimizer
    from pcm_tpu_torch.utils.quant import int8_matmul, quantize_frozen

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(args.seed)
    b = args.batch_size
    remat = args.remat == "full"
    if args.family == "sd15":
        recipe = RECIPES["sd15_2phase_adv" if args.adv else "sd15_4phase"]
        bundle, cfg, lr = sd15_bundle(recipe.lora_rank, remat=remat), recipe.distill, recipe.lr
        batch = {"latents": torch.randn((b, 64, 64, 4), generator=gen, device=dev),
                 "prompt_embeds": torch.randn((b, 77, 768), generator=gen, device=dev).bfloat16(),
                 "uncond_embeds": torch.randn((b, 77, 768), generator=gen, device=dev).bfloat16()}
        label = f"{recipe.name} step, batch {b} x 512px"
        if args.pixels:
            from pcm_tpu_torch.data.tokenizer import HashTokenizer

            bundle = dataclasses.replace(bundle, vae_encode_chunk=32)
            ids = HashTokenizer()([f"a photo of subject {i}" for i in range(b)])
            pixels = torch.rand((b, 512, 512, 3), generator=gen, device=dev) * 2 - 1
            batch = {"pixel_values": pixels,
                     "input_ids": torch.from_numpy(ids).long().to(dev),
                     "uncond_embeds": batch["uncond_embeds"]}
            label += " from pixels (VAE encode + CLIP-L)"
    elif args.family == "sd3":
        bundle = sd3_bundle(remat=remat)
        cfg, lr = SD3_CACHED_STEP.distill, SD3_CACHED_STEP.lr
        embeds = torch.randn((b, 154, 4096), generator=gen, device=dev).bfloat16()
        pooled = torch.randn((b, 2048), generator=gen, device=dev).bfloat16()
        batch = {"latents": torch.randn((b, 128, 128, 16), generator=gen, device=dev),
                 "prompt_embeds": embeds, "pooled_embeds": pooled,
                 "uncond_embeds": torch.zeros_like(embeds),
                 "uncond_pooled": torch.zeros_like(pooled)}
        label = f"SD3-1024 cached step, batch {b}"
    else:
        bundle = sdxl_bundle(64, remat=remat)
        cfg, lr = SDXL_CACHED_STEP.distill, SDXL_CACHED_STEP.lr
        batch = {"latents": torch.randn((b, 128, 128, 4), generator=gen, device=dev),
                 "prompt_embeds": torch.randn((b, 77, 2048), generator=gen,
                                              device=dev).bfloat16(),
                 "pooled_embeds": torch.randn((b, 1280), generator=gen, device=dev).bfloat16(),
                 "time_ids": torch.tensor([SDXL_CACHED_STEP.time_ids] * b, device=dev)}
        label = f"SDXL-1024 cached step, batch {b}"
        if args.pixels:
            from pcm_tpu_torch.data.tokenizer import HashTokenizer

            bundle = dataclasses.replace(bundle, vae_encode_chunk=1 if b > 1 else None)
            ids = torch.from_numpy(HashTokenizer()([f"a photo of subject {i}" for i in range(b)]))
            batch = {"pixel_values": torch.rand((b, 1024, 1024, 3), generator=gen,
                                                device=dev) * 2 - 1,
                     "input_ids": ids.long().to(dev), "input_ids_2": ids.long().to(dev),
                     "time_ids": batch["time_ids"]}
            label = f"SDXL-1024 from pixels (VAE encode + CLIP-L + bigG), batch {b}"
    # SDXL and SD3 on caches need the backbone alone (the other modules draw
    # their own streams)
    backbone = {"sdxl": ("unet",), "sd3": ("mmdit",)}.get(args.family)
    frozen, lora = (bundle.init(gen, dev, modules=backbone) if backbone and not args.pixels
                    else bundle.init(gen, dev))
    if args.frozen_weights == "int8":
        quantize_frozen(frozen)
    if args.int8_matmul == "scoped":
        cfg = dataclasses.replace(cfg, int8_no_grad_fwd=True)
    tx = make_optimizer(lr, use_8bit=args.use_8bit_adam)
    step = (build_flow_distill_step(bundle, make_flow_schedule(), cfg, tx)
            if args.family == "sd3" else build_ddim_distill_step(bundle, make_ddpm_schedule(),
                                                                 cfg, tx))
    box = {"state": TrainState.create(lora, tx)}
    run_ctx = (int8_matmul(args.int8_matmul) if args.int8_matmul in ("dense", "fused")
               else contextlib.nullcontext())

    def one_step():
        draws = [sample_draws(cfg, gen, bundle.latents_like(batch) if args.pixels
                              else batch["latents"], posterior=args.pixels)]
        box["state"], metrics = step(box["state"], frozen, batch, draws)
        float(metrics["loss"])

    if args.adv:  # the adversarial recipe's pair of updates (`python -m pcm_tpu_torch.train`)
        recipe = RECIPES[{"sd15": "sd15_2phase_adv", "sdxl": "sdxl_4phase_adv"}[args.family]]
        disc, heads = adv.init_discriminator(disc_config(args.family),
                                             bundle.unet_cfg.tap_channels(), gen, dev)
        tx_d = make_optimizer(recipe.adv_lr, b1=0.0, max_grad_norm=1.0)
        box["d"] = TrainState.create(heads, tx_d)
        schedule = make_ddpm_schedule()
        parts = (bundle, schedule, cfg, adv.AdvConfig(recipe.adv_weight), disc, tx, tx_d)
        g_step, d_step = adv.build_ddim_adv_steps(*parts)
        pair = adv.build_ddim_adv_fused_pair(*parts)

        def one_step():  # noqa: F811
            def draws():
                return [sample_draws(cfg, gen, bundle.latents_like(batch), adv_schedule=schedule,
                                     posterior=args.pixels)]

            if args.adv == "fused":
                box["state"], box["d"], m = pair(box["state"], box["d"], frozen, batch, draws())
            else:
                box["d"], m = d_step(box["state"], box["d"], frozen, batch, draws())
                float(m["d_loss"])
                box["state"], m = g_step(box["state"], box["d"], frozen, batch, draws())
            float(m["loss"])

        label += f", {args.adv} adversarial pair ({recipe.name}; D then G)"

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
        with gn_backward_scope():
            prof = trace(one_step, label)
        # the scope's host-side event sums its kernels' device time; its
        # device-side span runs from its first kernel's start to its last one's end
        scope = {e.device_type: e for e in prof.key_averages() if e.key == GN_BWD_SCOPE}
        cpu, gpu = (scope.get(d) for d in (torch.autograd.DeviceType.CPU,
                                           torch.autograd.DeviceType.CUDA))
        print(f"   {GN_BWD_SCOPE}: " + (f"x{cpu.count}, device time of its kernels "
                                       f"{cpu.device_time_total / 1000:.2f} ms, spans "
                                       f"{gpu.self_device_time_total / 1000 if gpu else 0:.2f} ms"
                                       if cpu else "not reached"))
        tally, unwrap = bound_tally()
        one_step()
        unwrap()
        if args.pixels:
            enc_tally, unwrap = bound_tally()
            bundle.encode_pixels(frozen, batch["pixel_values"],
                                 sample_draws(cfg, gen, bundle.latents_like(batch),
                                              posterior=True)["vae_noise"])
            unwrap()
    print(f"== {label}: launches and bound ms a step by kernel "
          + json.dumps({k: round(v, 4) for k, v in sorted(tally.items())}))
    if args.pixels:
        print(f"== {label}: launches and bound ms of one VAE encode by kernel "
              + json.dumps({k: round(v, 4) for k, v in sorted(enc_tally.items())}))
    print(torch.cuda.get_device_name(0))


if __name__ == "__main__":
    main()
