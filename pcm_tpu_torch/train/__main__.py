"""Distill an SD1.5 or SDXL teacher into a PCM LoRA student on a CUDA card.

  python -m pcm_tpu_torch.train --recipe sd15_4phase --cached-latents-dir cache/ \\
      --output-dir runs/sd15_4phase
  python -m pcm_tpu_torch.train --recipe sdxl_4phase_adv --cached-latents-dir xl_cache/ \\
      --output-dir runs/sdxl_adv [--adv-pairing fresh|fused]
  python -m pcm_tpu_torch.train --recipe sd15_4phase --tiny --device cpu \\
      --cached-latents-dir tiny_cache/ --output-dir runs/tiny --max-train-steps 2

The flags are those of `scripts/train.py` for this path: the sd15 recipes
(consistency-only and ``sd15_2phase_adv``) on cached latents (``shard_*.npz``
with ``latents`` and ``prompt_embeds``) and ``sdxl_4phase_adv`` on cached
latents and embeddings (also ``pooled_embeds`` and ``time_ids``). Without
``--teacher-checkpoint`` the weights are drawn on the device from
``--seed``, the discriminator heads of the adversarial recipes from
``--seed + 1``. The SD1.5 uncond embeddings are encoded once, from empty
prompts; SDXL's are zeros inside the step. ``--adv-pairing fresh`` (the
default) alternates a D update (even global steps) and a G update (odd),
each on its own batch; ``fused`` trains both on one batch and counts the
pair as two global steps, so ``--max-train-steps``, ``--log-every`` and
``--checkpointing-steps`` are best even. ``--tiny --device cpu`` runs the
tiny configuration on the CPU through the kernels' plain versions (a smoke
mode). A run resumes from the newest checkpoint in ``--output-dir`` unless
``--no-resume``.

``--frozen-weights int8`` stores the frozen UNet and text weights as int8
codes with per-channel scales (`utils/quant.py`); ``--int8-matmul`` then
computes their products on an int8 path: ``scoped`` in the teacher and
target forwards only, ``dense`` everywhere (whole-row activation scales),
``fused`` everywhere through the K6 kernel (pointwise convs included). With
``--tiny`` every Linear and conv weight is quantized (all but a few TINY
weights are under the 65536-element threshold).
"""

from __future__ import annotations

import argparse

import torch

NOT_PORTED = "not yet ported to pcm_tpu_torch"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m pcm_tpu_torch.train")
    ap.add_argument("--recipe", required=True)
    ap.add_argument("--output-dir", required=True)
    ap.add_argument("--cached-latents-dir", default=None,
                    help="dir of shard_*.npz (latents, prompt_embeds; SDXL also "
                         "pooled_embeds, time_ids)")
    ap.add_argument("--train-data-dir", default=None, help="image folder (" + NOT_PORTED + ")")
    ap.add_argument("--teacher-checkpoint", default=None,
                    help="torch.save'd {'unet': sd, 'vae': sd, 'text': sd} state dicts")
    ap.add_argument("--max-train-steps", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=None, help="per-card batch")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--learning-rate", type=float, default=None,
                    help="override the recipe learning rate")
    ap.add_argument("--lr-scheduler", default="constant", choices=["constant", "cosine"])
    ap.add_argument("--lr-warmup-steps", type=int, default=0)
    ap.add_argument("--gradient-accumulation-steps", type=int, default=1)
    ap.add_argument("--use-8bit-adam", action="store_true",
                    help="blockwise int8 Adam moments")
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "prodigy"])
    ap.add_argument("--checkpointing-steps", type=int, default=500)
    ap.add_argument("--checkpoints-total-limit", type=int, default=5)
    ap.add_argument("--log-every", type=int, default=10,
                    help="metrics cadence (each log reads the device back)")
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--remat", default="full",
                    help="full = checkpoint every UNet block (least memory), none = keep "
                         "all activations")
    ap.add_argument("--frozen-weights", default="bf16", choices=["bf16", "int8"],
                    help="int8 = frozen UNet/text weights as per-channel int8 (the VAE "
                         "stays bf16)")
    ap.add_argument("--int8-matmul", default=None, choices=["scoped", "dense", "fused"],
                    help="int8 products of the int8 weights (needs --frozen-weights int8): "
                         "scoped = teacher and target forwards only, dense = every Linear, "
                         "fused = every Linear and 1x1 conv through the fused kernel")
    ap.add_argument("--adv-pairing", default="fresh", choices=["fresh", "fused"],
                    help="adversarial recipes: fresh = D and G each on its own batch, "
                         "alternating; fused = one batch feeds one D and one G update "
                         "(counts as 2 steps)")
    ap.add_argument("--split-d", action="store_true", help="(" + NOT_PORTED + ")")
    ap.add_argument("--validation-steps", type=int, default=0,
                    help="validation image grids (" + NOT_PORTED + ")")
    ap.add_argument("--validation-prompts", nargs="*", default=None,
                    help="(" + NOT_PORTED + ")")
    ap.add_argument("--tiny", action="store_true", help="tiny-model smoke mode")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    """Parse ``argv``, build the run and train it; returns the Trainer."""
    ap = build_parser()
    args = ap.parse_args(argv)

    from ..configs.families import RECIPES, disc_config, sd15_bundle, sdxl_bundle

    if args.recipe not in RECIPES:
        ap.error(f"unknown recipe {args.recipe!r} (one of {sorted(RECIPES)})")
    recipe = RECIPES[args.recipe]
    if recipe.family not in ("sd15", "sdxl"):
        ap.error(f"recipe {args.recipe} ({recipe.family}) is {NOT_PORTED}: the sd15 recipes "
                 "and sdxl_4phase_adv are")
    if args.split_d:
        ap.error(f"--split-d is {NOT_PORTED} (the D step is one step here)")
    if recipe.adversarial and args.frozen_weights == "int8":
        ap.error(f"--frozen-weights int8 with an adversarial recipe is {NOT_PORTED}")
    if args.optimizer == "prodigy":
        ap.error(f"--optimizer prodigy is {NOT_PORTED}")
    if args.int8_matmul and args.frozen_weights != "int8":
        ap.error(f"--int8-matmul {args.int8_matmul} requires --frozen-weights int8 (it "
                 "quantizes activations against int8 weights)")
    if args.validation_steps or args.validation_prompts:
        ap.error(f"validation grids are {NOT_PORTED}")
    if not args.cached_latents_dir:
        ap.error(f"training from --train-data-dir (VAE-encoding images) is {NOT_PORTED}: "
                 "pass --cached-latents-dir")
    if args.remat not in ("full", "none"):
        ap.error(f"--remat {args.remat} is {NOT_PORTED} (full|none)")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu (with --tiny) to smoke-test on the CPU")

    import contextlib
    import dataclasses

    from ..core.schedule import make_ddpm_schedule
    from ..data.cached import CachedLatentsDataset, batches
    from ..data.tokenizer import HashTokenizer
    from ..utils.quant import int8_matmul, quantize_frozen
    from .adv import AdvConfig, build_ddim_adv_train_step, init_discriminator
    from .distill import build_ddim_distill_step
    from .loop import LoopConfig, Trainer
    from .state import TrainState, make_optimizer

    ds = CachedLatentsDataset(args.cached_latents_dir)
    needed = ("prompt_embeds", "pooled_embeds", "time_ids") if recipe.family == "sdxl" \
        else ("prompt_embeds",)
    missing = [k for k in needed if k not in ds.get(0)]
    if missing:
        ap.error(f"cached shards without {missing} (captions through the text towers) are "
                 f"{NOT_PORTED}")
    batch = args.batch_size or recipe.batch_per_chip
    accum = args.gradient_accumulation_steps
    max_steps = args.max_train_steps or recipe.max_steps
    lr = args.learning_rate if args.learning_rate is not None else recipe.lr

    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    make_bundle = sd15_bundle if recipe.family == "sd15" else sdxl_bundle
    bundle = make_bundle(recipe.lora_rank, dtype=dtype, tiny=args.tiny,
                         remat=args.remat == "full")
    gen = torch.Generator(device).manual_seed(args.seed)
    frozen, lora = bundle.init(gen, device)
    if args.teacher_checkpoint:
        frozen = bundle.from_states(torch.load(args.teacher_checkpoint, weights_only=True), device)
    if args.frozen_weights == "int8":  # --tiny: quantize the small TINY weights too
        frozen = quantize_frozen(frozen, min_size=0 if args.tiny else 65536)
    distill_cfg = recipe.distill
    if args.int8_matmul == "scoped":
        distill_cfg = dataclasses.replace(distill_cfg, int8_no_grad_fwd=True)

    tx = make_optimizer(lr, max_grad_norm=1.0, use_8bit=args.use_8bit_adam,
                        warmup_steps=args.lr_warmup_steps, schedule=args.lr_scheduler,
                        total_steps=max_steps)
    state = TrainState.create(lora, tx)

    proc_batch = batch * accum
    extra = {}
    if recipe.family == "sd15":  # uncond embeds from empty prompts (scripts/train.py:348-352)
        ids = torch.from_numpy(HashTokenizer()([""] * proc_batch)).long().to(device)
        with torch.no_grad():
            extra["uncond_embeds"] = bundle.encode_prompts(frozen, ids)["prompt_embeds"]

    loop_cfg = LoopConfig(output_dir=args.output_dir, max_train_steps=max_steps,
                          checkpointing_steps=args.checkpointing_steps,
                          checkpoints_total_limit=args.checkpoints_total_limit,
                          log_every=args.log_every, seed=args.seed, resume=not args.no_resume)
    schedule = make_ddpm_schedule()
    if recipe.adversarial:
        disc, d_params = init_discriminator(
            disc_config(recipe.family, args.tiny), bundle.unet_cfg.tap_channels(),
            torch.Generator(device).manual_seed(args.seed + 1), device)
        tx_d = make_optimizer(recipe.adv_lr, b1=0.0, max_grad_norm=1.0)  # scripts/train.py:399
        step = build_ddim_adv_train_step(bundle, schedule, distill_cfg,
                                         AdvConfig(recipe.adv_weight), disc, tx, tx_d,
                                         args.adv_pairing, accum)
        trainer = Trainer(loop_cfg, frozen, state, step, distill_cfg, schedule, device, accum,
                          d_state=TrainState.create(d_params, tx_d))
    else:
        distill_step = build_ddim_distill_step(bundle, schedule, distill_cfg, tx,
                                               grad_accum_steps=accum)

        def step(state, d_state, frozen, batch, draws, global_step):
            state, metrics = distill_step(state, frozen, batch, draws)
            return state, d_state, metrics, 1

        trainer = Trainer(loop_cfg, frozen, state, step, distill_cfg, schedule, device, accum)
    print(f"# {args.recipe}: batch {batch} x accum {accum}, {max_steps} steps on {device}, "
          f"{args.frozen_weights} frozen weights"
          + (f", {args.adv_pairing} adversarial pairing" if recipe.adversarial else "")
          + (f", int8 matmul {args.int8_matmul}" if args.int8_matmul else "")
          + (f", resumed at step {trainer.resumed_from}" if trainer.resumed_from else ""),
          flush=True)
    # dense/fused: every int8 product of the run (the scoped mode is in the step)
    run_ctx = (int8_matmul(args.int8_matmul) if args.int8_matmul in ("dense", "fused")
               else contextlib.nullcontext())
    with run_ctx:
        trainer.run(batches(ds, proc_batch, args.seed), extra)
    return trainer


if __name__ == "__main__":
    main()
