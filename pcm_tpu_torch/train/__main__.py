"""Distill an SD1.5, SDXL or SD3 teacher into a PCM LoRA student on a CUDA card.

  python -m pcm_tpu_torch.train --recipe sd15_4phase --cached-latents-dir cache/ \\
      --output-dir runs/sd15_4phase
  python -m pcm_tpu_torch.train --recipe sd15_4phase --train-data-dir imgs/ \\
      --output-dir runs/sd15_4phase [--tokenizer-dir tok/ | --allow-hash-tokenizer]
  python -m pcm_tpu_torch.train --recipe sdxl_4phase_adv --cached-latents-dir xl_cache/ \\
      --output-dir runs/sdxl_adv [--adv-pairing fresh|fused]
  python -m pcm_tpu_torch.train --recipe sdxl_4phase_adv --train-data-dir imgs/ \\
      --output-dir runs/sdxl_adv [--tokenizer-dir tok/ | --allow-hash-tokenizer]
  python -m pcm_tpu_torch.train --recipe sd3_4phase_adv --cached-latents-dir sd3_cache/ \\
      --output-dir runs/sd3_adv [--adv-pairing fresh|fused]
  python -m pcm_tpu_torch.train --recipe sd15_4phase --tiny --device cpu \\
      --cached-latents-dir tiny_cache/ --output-dir runs/tiny --max-train-steps 2
  python -m torch.distributed.run --nproc-per-node 4 -m pcm_tpu_torch.train \\
      --recipe sd15_4phase --cached-latents-dir cache/ --output-dir runs/sd15_dp4

The flags are those of `scripts/train.py`: the sd15 recipes
(consistency-only and ``sd15_2phase_adv``) on cached latents (``shard_*.npz``
with ``latents`` and ``prompt_embeds``), ``sdxl_4phase_adv`` on cached
latents and embeddings (also ``pooled_embeds`` and ``time_ids``) and the
four SD3 recipes (``sd3_1phase_adv``, ``sd3_2phase_adv``, ``sd3_4phase_adv``,
``sd3_adv_stochastic``, all adversarial, on the flow schedule at shift 3)
on cached latents, ``prompt_embeds`` (N, 154, 4096) and ``pooled_embeds``
(N, 2048). Every one of them also trains from a folder of images with
sidecar ``.txt`` captions (``--train-data-dir``): each step (each D and each
G step of an adversarial recipe) encodes the batch's pixels with the VAE
encoder (a posterior sample of its own, in chunks of ``--vae-encode-chunk``)
and its captions with the text towers (CLIP-L; SDXL also CLIP-bigG; SD3
CLIP-L, CLIP-bigG and T5-XXL), as the reference does; the images are cropped
at ``--resolution`` (the recipe's by default), center for SD1.5 and SD3, at
random for SDXL (whose ``time_ids`` carry each image's size and crop), and
loaded by ``--dataloader-workers`` workers (`data/dataset.py`). Captions
take the tokenizer of ``--tokenizer-dir``, or hashed ids with
``--allow-hash-tokenizer`` (or ``--tiny``); cached runs hash the empty
uncond prompt unless ``--tokenizer-dir`` is given. Without
``--teacher-checkpoint`` the weights are drawn on the device from
``--seed``, the discriminator heads of the adversarial recipes from
``--seed + 1``. The SD1.5 and SD3 uncond embeddings are encoded once, from
empty prompts; SDXL's are zeros inside the step. SDXL on caches draws the
UNet alone; SD3 on caches draws the MMDiT and the three towers, encodes the
uncond prompt and frees the towers; from pixels every module is kept.
``--adv-pairing fresh`` (the
default) alternates a D update (even global steps) and a G update (odd),
each on its own batch; ``fused`` trains both on one batch and counts the
pair as two global steps, so ``--max-train-steps``, ``--log-every`` and
``--checkpointing-steps`` are best even. ``--tiny --device cpu`` runs the
tiny configuration on the CPU through the kernels' plain versions (a smoke
mode). A run resumes from the newest checkpoint in ``--output-dir`` unless
``--no-resume``. Each save writes a checkpoint and the LoRA as a kohya file,
``<output-dir>/pcm_lora_<step>.safetensors`` (SD3's keys under
``lora_transformer``, the others' under ``lora_unet``); SIGTERM or SIGINT
ends the run after the step in flight with both, and a rerun resumes there.
Each run appends the kernels' launch counts of its process to
``<output-dir>/launches.jsonl``. Saves are written by a thread of their own
(`train/loop.py`).

Under ``python -m torch.distributed.run`` (or with ``--multihost`` and that
launcher's environment) each process is a rank of a data-parallel run
(`parallel/mesh.py`): rank r trains on ``cuda:LOCAL_RANK`` (NCCL; gloo when
ranks share a card, or with ``--device cpu``), reads every N-th shard file or
image from its index (`shard_for_process`; each rank needs one) and takes a
block of the global batch of ``--batch-size`` x N rows (``--batch-size``,
``--vae-encode-chunk`` and ``--dataloader-workers`` count per rank); the
gradients are averaged over the ranks every step, so N ranks compute what
one process computes on the global batch. Rank 0 alone prints the banner
and the log rows and writes ``metrics.jsonl``, checkpoints, kohya files,
validation grids and ``launches.jsonl``; a SIGTERM to any rank stops every
rank after the same step.

Every ``--validation-steps`` global steps (500; 0: none) the student
samples 4 images of each ``--validation-prompts`` prompt (the reference's
four by default) at the recipe's ``multiphase`` steps, with DDIM at
guidance 1 and 7.5 for SD1.5 and SDXL, or PCM-FM on the flow schedule at
shift 3 and the recipe's solver grid at 1.5 for SD3 (uncond: the empty
prompt, used above guidance 1), each prompt's noise from a generator of its
own seeded from (``--seed``, the prompt's index); the grids go to
``<output-dir>/images/validation/cfg<g>_<step>.png``, at the cache's latent
size on cached latents, decoded a sample a call at >= 1024 px. A run in
which no validation step falls (``--validation-steps`` above
``--max-train-steps``) sets none up. The prompts are encoded once at set-up;
on cached latents SDXL and SD3 then free their towers (SDXL builds its
towers and VAE, SD3 its VAE, only for validation), and
``--offload-encoders`` also drops the VAE (and SD1.5's tower) from the
card, keeping a host copy of the VAE that each validation call moves to
the card and back. ``--optimizer prodigy`` trains the LoRA with Prodigy
(`train/prodigy.py`; lr about 1.0, no schedule; ``prodigy_d`` in the
metrics).

``--frozen-weights int8`` stores the frozen UNet or MMDiT and text weights
as int8 codes with per-channel scales (`utils/quant.py`), with every
recipe, before the discriminator heads are drawn (`scripts/train.py:280-283`);
the VAE, the embeddings and the heads stay in float. ``--int8-matmul`` then
computes their products on an int8 path: ``scoped`` in the teacher and
target forwards only (the adversarial recipes' taps keep the dequantized
weights), ``dense`` everywhere (whole-row activation scales), ``fused``
everywhere through the K6 kernel (pointwise convs included), the taps and
validation sampling included. The JAX package's bisection modes ``conv``
and ``both`` are not choices here, as there: `utils.quant.int8_matmul` or
``PCM_INT8_MATMUL`` reach them. With ``--tiny`` every Linear and conv
weight is quantized (all but a few TINY weights are under the 65536-element
threshold). ``--int8-no-grad-fwd`` is the JAX CLI's alias of ``--int8-matmul
scoped``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

NOT_PORTED = "not yet ported to pcm_tpu_torch"
# the reference's validation prompts (`scripts/train.py:153-158`)
VALIDATION_PROMPTS = [
    "portrait photo of a girl, photograph, highly detailed face, depth of field",
    "Self-portrait oil painting, a beautiful cyborg with golden hair, 8k",
    "Astronaut in a jungle, cold color palette, muted colors, detailed, 8k",
    "A photo of beautiful mountain with realistic sunset and blue lake, highly detailed, "
    "masterpiece",
]
VALIDATION_IMAGES = 4  # a prompt (`scripts/train.py:469`)


def validation_setup(bundle, recipe, frozen, toks, prompts, latent_hw: int, device) -> dict:
    """What each validation call needs, encoded once at set-up
    (`scripts/train.py:459-520`): the sampler (DDIM at the recipe's
    ``multiphase`` steps; SD3: PCM-FM on the flow schedule at shift 3 and the
    recipe's solver grid), the guidance scales, each prompt's cond and the
    empty prompt's uncond, tiled to `VALIDATION_IMAGES` rows."""
    from ..core.schedule import make_ddpm_schedule, make_flow_schedule
    from ..sampling.ddim import DDIMSampler
    from ..sampling.pcm_fm import PCMFMSampler
    from ..configs.families import decode_chunk
    from ..serving.engine import make_prompt_encoder

    k, n = recipe.distill.multiphase, VALIDATION_IMAGES
    if recipe.family == "sd3":
        sampler = PCMFMSampler.create(make_flow_schedule(shift=3.0), k,
                                      recipe.distill.num_solver_steps)
        scales = (1.5,)
    else:
        sampler = DDIMSampler.create(make_ddpm_schedule(), k)
        scales = (1.0, 7.5)
    res = latent_hw * bundle.vae_scale
    encode = make_prompt_encoder(bundle, toks, frozen, device, res)
    return {"sampler": sampler, "scales": scales, "conds": [encode([p] * n) for p in prompts],
            "uncond": encode([""] * n), "latents": (n, latent_hw, latent_hw,
                                                    bundle.latent_channels),
            "decode_chunk": decode_chunk(res)}


def validation_seed(seed: int, prompt_index: int) -> int:
    """The seed of a prompt's validation noise: (``--seed``, its index)."""
    return (seed * 1000003 + 1000 * prompt_index) % 2 ** 63


def validation_fn(bundle, setup: dict, seed: int, device, vae_host=None):
    """``validation_fn(frozen, lora, step) -> {"cfg<g>": images}``: each
    prompt's `VALIDATION_IMAGES` samples at each guidance scale, concatenated
    in prompt order. ``vae_host``: the offloaded VAE, moved to the card for
    the call and back."""
    from ..sampling.pipeline import TextToImagePipeline

    pipe = TextToImagePipeline(bundle, setup["sampler"])

    def validate(frozen, lora, step):
        modules = dict(frozen)
        if vae_host is not None:
            modules["vae"] = vae_host.to(device)
        try:
            out = {}
            for g in setup["scales"]:
                images = []
                for i, cond in enumerate(setup["conds"]):
                    gen = torch.Generator(device).manual_seed(validation_seed(seed, i))
                    init = torch.randn(setup["latents"], generator=gen, device=device)
                    images.append(pipe.generate(
                        modules, lora, cond, setup["uncond"] if g > 1 else None, init, g,
                        setup["decode_chunk"]).float().cpu())
                out[f"cfg{g:g}"] = torch.cat(images)
            return out
        finally:
            if vae_host is not None:
                vae_host.to("cpu")

    return validate


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m pcm_tpu_torch.train")
    ap.add_argument("--recipe", required=True)
    ap.add_argument("--output-dir", required=True)
    ap.add_argument("--cached-latents-dir", default=None,
                    help="dir of shard_*.npz (latents, prompt_embeds; SDXL also "
                         "pooled_embeds, time_ids; SD3 also pooled_embeds)")
    ap.add_argument("--train-data-dir", default=None,
                    help="image folder with sidecar .txt captions")
    ap.add_argument("--resolution", type=int, default=None,
                    help="image side of --train-data-dir (default: the recipe's)")
    ap.add_argument("--dataloader-workers", type=int, default=16,
                    help="threads (processes with the numpy decoder) that load a batch's "
                         "images")
    ap.add_argument("--tokenizer-dir", default=None,
                    help="tokenizer dir (vocab.json + merges.txt for the native CLIP BPE, or "
                         "a transformers dir)")
    ap.add_argument("--allow-hash-tokenizer", action="store_true",
                    help="hash captions to ids without --tokenizer-dir (smoke runs only: the "
                         "text conditioning is garbage)")
    ap.add_argument("--vae-encode-chunk", type=int, default=None,
                    help="samples a VAE encode call with --train-data-dir (default: 1 at >= "
                         "1024 px with a batch above 1, as the reference; else the whole "
                         "batch, up to 32)")
    ap.add_argument("--teacher-checkpoint", default=None,
                    help="torch.save'd {'unet': sd, 'vae': sd, 'text': sd} state dicts "
                         "(SDXL: also 'text2'; SD3: 'mmdit', 'vae', 'text', 'text2', 't5')")
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
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "prodigy"],
                    help="student optimizer; prodigy is parameter-free: pair it with "
                         "--learning-rate 1.0")
    ap.add_argument("--checkpointing-steps", type=int, default=500)
    ap.add_argument("--checkpoints-total-limit", type=int, default=5)
    ap.add_argument("--log-every", type=int, default=10,
                    help="metrics cadence (each log reads the device back)")
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--remat", default="full",
                    help="full = checkpoint every UNet or MMDiT block and keep nothing (least "
                         "memory); none = keep all activations; nothing, dots, dots_small, "
                         "dots<N>m = checkpoint and keep the unbatched matmul outputs (of at "
                         "most 16 / N MiB), each with +fa keeping flash attention's output "
                         "and lse too (ops/common.py:resolve_remat_policy)")
    ap.add_argument("--remat-gran", default="block", choices=["module", "block"],
                    help="UNet checkpoint region: block = each BasicTransformerBlock (the "
                         "backward holds one block's recompute), module = each whole "
                         "Transformer2D; resnets are regions of their own either way")
    ap.add_argument("--frozen-weights", default="bf16", choices=["bf16", "int8"],
                    help="int8 = frozen UNet or MMDiT and text weights as per-channel int8 "
                         "(the VAE stays bf16)")
    ap.add_argument("--int8-no-grad-fwd", action="store_true",
                    help="alias for --int8-matmul scoped")
    ap.add_argument("--int8-matmul", default=None, choices=["scoped", "dense", "fused"],
                    help="int8 products of the int8 weights (needs --frozen-weights int8): "
                         "scoped = teacher and target forwards only, dense = every Linear, "
                         "fused = every Linear and 1x1 conv through the fused kernel")
    ap.add_argument("--adv-pairing", default="fresh", choices=["fresh", "fused"],
                    help="adversarial recipes: fresh = D and G each on its own batch, "
                         "alternating; fused = one batch feeds one D and one G update "
                         "(counts as 2 steps)")
    ap.add_argument("--split-d", action="store_true", help="(" + NOT_PORTED + ")")
    ap.add_argument("--validation-steps", type=int, default=500,
                    help="validation image grids every N global steps (0: none)")
    ap.add_argument("--validation-prompts", nargs="*", default=VALIDATION_PROMPTS)
    ap.add_argument("--offload-encoders", action="store_true",
                    help="(cached latents) after the set-up encodes, drop the VAE and the text "
                         "towers from the card; validation moves a host copy of the VAE to the "
                         "card for each call")
    ap.add_argument("--tiny", action="store_true", help="tiny-model smoke mode")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--multihost", action="store_true",
                    help="join the process group of python -m torch.distributed.run (also "
                         "implied by its WORLD_SIZE in the environment)")
    return ap


def main(argv=None):
    """Parse ``argv``, build the run and train it; returns the Trainer."""
    ap = build_parser()
    args = ap.parse_args(argv)

    from ..configs.families import RECIPES, disc_config, sd3_bundle, sd15_bundle, sdxl_bundle
    from ..ops.common import resolve_remat_policy

    if args.recipe not in RECIPES:
        ap.error(f"unknown recipe {args.recipe!r} (one of {sorted(RECIPES)})")
    recipe = RECIPES[args.recipe]
    if args.split_d:
        ap.error(f"--split-d is {NOT_PORTED} (the D step is one step here)")
    if args.optimizer == "prodigy" and (args.lr_scheduler != "constant" or args.lr_warmup_steps):
        ap.error("--optimizer prodigy takes no learning-rate schedule (it adapts its own step, "
                 "as `pcm_tpu/train/state.py:make_optimizer` builds it)")
    if args.int8_no_grad_fwd:
        if args.int8_matmul not in (None, "scoped"):
            ap.error(f"--int8-no-grad-fwd is --int8-matmul scoped, not {args.int8_matmul}")
        args.int8_matmul = "scoped"
    if args.int8_matmul and args.frozen_weights != "int8":
        ap.error(f"--int8-matmul {args.int8_matmul} requires --frozen-weights int8 (it "
                 "quantizes activations against int8 weights)")
    if bool(args.cached_latents_dir) == bool(args.train_data_dir):
        ap.error("pass one of --train-data-dir / --cached-latents-dir")
    if args.offload_encoders and not args.cached_latents_dir:
        ap.error("--offload-encoders requires --cached-latents-dir (the train step must not "
                 "need the encoder towers)")
    if args.train_data_dir and not (args.tokenizer_dir or args.allow_hash_tokenizer
                                    or args.tiny):
        ap.error("no tokenizer for the captions: pass --tokenizer-dir, or "
                 "--allow-hash-tokenizer for smoke runs (prompts hashed to pseudo-random ids)")
    remat_policy = None if args.remat in ("full", "none") else args.remat
    try:
        resolve_remat_policy(remat_policy)
    except ValueError as e:
        ap.error(f"--remat: {e}, full or none")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu (with --tiny) to smoke-test on the CPU")
    from ..parallel import mesh

    multihost = args.multihost or "WORLD_SIZE" in os.environ
    if multihost:
        try:
            device = mesh.init_distributed(device=device.type)
        except RuntimeError as e:
            ap.error(str(e))
    rank, world = mesh.rank(), mesh.world()

    import contextlib
    import dataclasses

    from ..core.schedule import make_ddpm_schedule, make_flow_schedule
    from ..data.cached import CachedLatentsDataset, batches
    from ..data.tokenizer import resolve_tokenizers
    from ..ops import launch_counts, reset_launch_counts
    from ..utils.quant import int8_matmul, quantize_frozen
    from .adv import AdvConfig, adv_offset_span, build_adv_train_step, init_discriminator
    from .bundles import BACKBONES
    from .distill import build_ddim_distill_step
    from .loop import LoopConfig, Trainer
    from .state import TrainState, make_optimizer

    family = recipe.family
    sdxl, sd3 = family == "sdxl", family == "sd3"
    if args.cached_latents_dir:
        try:
            ds = CachedLatentsDataset(args.cached_latents_dir, process_index=rank,
                                      process_count=world)
        except ValueError as e:
            ap.error(str(e))
        needed = {"sd15": ("prompt_embeds",), "sdxl": ("prompt_embeds", "pooled_embeds",
                                                       "time_ids"),
                  "sd3": ("prompt_embeds", "pooled_embeds")}[family]
        missing = [k for k in needed if k not in ds.get(0)]
        if missing:
            ap.error(f"cached shards without {missing} (captions through the text towers) "
                     f"are {NOT_PORTED}")
    else:
        from ..data.dataset import DataLoader, ImageFolderDataset, make_collate, shard_for_process

        res = args.resolution or recipe.resolution
        try:
            images = ImageFolderDataset(args.train_data_dir, resolution=res,
                                        proportion_empty_prompts=recipe.proportion_empty_prompts,
                                        seed=args.seed, crop="random" if sdxl else "center")
        except (FileNotFoundError, ValueError) as e:
            ap.error(str(e))
        if len(images.files) < world:
            ap.error(f"{len(images.files)} images under {args.train_data_dir} for {world} "
                     "ranks: each rank needs one")
        images.files = shard_for_process(images.files, rank, world)
    batch = args.batch_size or recipe.batch_per_chip
    accum = args.gradient_accumulation_steps
    max_steps = args.max_train_steps or recipe.max_steps
    lr = args.learning_rate if args.learning_rate is not None else recipe.lr
    # validation runs on rank 0 alone: the other ranks build nothing for it
    validate = (bool(args.validation_prompts) and 0 < args.validation_steps <= max_steps
                and rank == 0)
    # SD3 encodes the empty prompt through its three towers on caches too
    tok_keys = (["input_ids", "input_ids_2", "input_ids_3"] if sd3
                else ["input_ids", "input_ids_2"] if sdxl and (args.train_data_dir or validate)
                else ["input_ids"])
    try:
        toks = resolve_tokenizers(args.tokenizer_dir, tok_keys)
    except (FileNotFoundError, OSError) as e:
        ap.error(str(e))
    if args.optimizer == "prodigy":  # the reference's warnings (`scripts/train.py:293-298`)
        if args.use_8bit_adam:
            print("warning: --use-8bit-adam is ignored with --optimizer prodigy", file=sys.stderr)
        if lr <= 0.1:
            print("warning: with prodigy set the learning rate around 1.0", file=sys.stderr)

    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    kw = dict(dtype=dtype, tiny=args.tiny, remat=args.remat != "none", remat_policy=remat_policy)
    if sd3:  # the adversarial recipes' LoRA targets (`scripts/train.py:238-244`)
        bundle = sd3_bundle(recipe.lora_rank, adv_targets=recipe.adversarial,
                            stochastic=recipe.stochastic, **kw)
    else:
        bundle = (sd15_bundle if family == "sd15" else sdxl_bundle)(
            recipe.lora_rank, remat_granularity=args.remat_gran, **kw)
    # what runs: the MMDiT's region is a joint block whatever --remat-gran says
    remat_gran = None if args.remat == "none" else "block" if sd3 else args.remat_gran
    if args.train_data_dir:  # the reference's rule (`scripts/train.py:215-217`), else <= 32
        chunk = args.vae_encode_chunk or (1 if res >= 1024 and batch > 1 else 32)
        bundle = dataclasses.replace(bundle, vae_encode_chunk=chunk)
    gen = torch.Generator(device).manual_seed(args.seed)
    # on cached latents SDXL needs the UNet alone and SD3 the MMDiT and, for the
    # uncond encode, its towers; validation adds the towers and the VAE (each
    # module draws the whole bundle's weights: the others draw from streams of
    # their own)
    cached_modules = {"sdxl": ("unet",) + (("vae", "text", "text2") if validate else ()),
                      "sd3": ("mmdit", "text", "text2", "t5") + (("vae",) if validate else ())}
    if args.cached_latents_dir and family in cached_modules:
        frozen, lora = bundle.init(gen, device, modules=cached_modules[family])
    else:
        frozen, lora = bundle.init(gen, device)
    if args.teacher_checkpoint:
        states = torch.load(args.teacher_checkpoint, weights_only=True)
        lacking = [m for m in frozen if m not in states]
        if lacking:
            ap.error(f"--teacher-checkpoint {args.teacher_checkpoint} lacks {lacking}, which "
                     "this run needs")
        frozen = bundle.from_states(states, device)
    if args.frozen_weights == "int8":  # --tiny: quantize the small TINY weights too
        frozen = quantize_frozen(frozen, min_size=0 if args.tiny else 65536)
    distill_cfg = recipe.distill
    if args.int8_matmul == "scoped":
        distill_cfg = dataclasses.replace(distill_cfg, int8_no_grad_fwd=True)

    tx = make_optimizer(lr, max_grad_norm=1.0, use_8bit=args.use_8bit_adam,
                        warmup_steps=args.lr_warmup_steps, schedule=args.lr_scheduler,
                        total_steps=max_steps, optimizer=args.optimizer)
    state = TrainState.create(lora, tx)

    proc_batch = batch * accum
    extra = {}
    if family != "sdxl":  # uncond embeds from empty prompts (scripts/train.py:348-361)
        ids = [torch.from_numpy(toks[k]([""] * proc_batch)).long().to(device) for k in tok_keys]
        with torch.no_grad():
            uncond = bundle.encode_prompts(frozen, *ids)
        extra["uncond_embeds"] = uncond["prompt_embeds"]
        if sd3:
            extra["uncond_pooled"] = uncond["pooled"]
    validation = None
    if validate:
        latent_hw = (ds.get(0)["latents"].shape[0] if args.cached_latents_dir
                     else res // bundle.vae_scale)
        validation = validation_setup(bundle, recipe, frozen, toks, args.validation_prompts,
                                      latent_hw, device)
    # on caches the step needs the backbone alone: SDXL and SD3 free their
    # towers after the set-up encodes (T5-XXL: 9.5 GB), --offload-encoders
    # every module but the backbone, keeping a host copy of the VAE
    vae_host = None
    if args.offload_encoders and "vae" in frozen:
        vae_host = frozen["vae"].to("cpu")
    if args.cached_latents_dir and (args.offload_encoders or family != "sd15"):
        keep = BACKBONES + (() if args.offload_encoders else ("vae",))
        frozen = {k: m for k, m in frozen.items() if k in keep}
        if device.type == "cuda":
            torch.cuda.empty_cache()

    loop_cfg = LoopConfig(output_dir=args.output_dir, max_train_steps=max_steps,
                          checkpointing_steps=args.checkpointing_steps,
                          checkpoints_total_limit=args.checkpoints_total_limit,
                          log_every=args.log_every, seed=args.seed, resume=not args.no_resume,
                          lora_alpha=bundle.lora.alpha if bundle.lora.alpha is not None
                          else bundle.lora.rank, kohya_prefix=bundle.KOHYA_PREFIX,
                          validation_steps=args.validation_steps if validate else 0)
    schedule = make_flow_schedule(shift=3.0) if sd3 else make_ddpm_schedule()
    if recipe.adversarial:
        disc, d_params = init_discriminator(
            disc_config(family, args.tiny), bundle.tap_channels(),
            torch.Generator(device).manual_seed(args.seed + 1), device)
        tx_d = make_optimizer(recipe.adv_lr, b1=0.0, max_grad_norm=1.0)  # scripts/train.py:399
        step = build_adv_train_step(bundle, schedule, distill_cfg, AdvConfig(recipe.adv_weight),
                                    disc, tx, tx_d, args.adv_pairing, accum)
        trainer = Trainer(loop_cfg, frozen, state, step, distill_cfg, bundle.latents_like,
                          device, accum, d_state=TrainState.create(d_params, tx_d),
                          adv_span=adv_offset_span(schedule, distill_cfg))
    else:
        distill_step = build_ddim_distill_step(bundle, schedule, distill_cfg, tx,
                                               grad_accum_steps=accum)

        def step(state, d_state, frozen, batch, draws, global_step):
            state, metrics = distill_step(state, frozen, batch, draws)
            return state, d_state, metrics, 1

        trainer = Trainer(loop_cfg, frozen, state, step, distill_cfg, bundle.latents_like,
                          device, accum)
    if validation is not None:
        trainer.validation_fn = validation_fn(bundle, validation, args.seed, device, vae_host)
    if rank == 0:
        print(f"# {args.recipe}: batch {batch} x accum {accum}, {max_steps} steps on {device}"
              + (f", rank 0 of {world} ({mesh.backend()}), global batch {batch * world}"
                 if mesh.active() else "")
              + f", {args.frozen_weights} frozen weights, {args.optimizer}"
              + f", remat {args.remat}" + (f" / {remat_gran}" if remat_gran else "")
              + (f", {args.adv_pairing} adversarial pairing" if recipe.adversarial else "")
              + (f", int8 matmul {args.int8_matmul}" if args.int8_matmul else "")
              + (f", resumed at step {trainer.resumed_from}" if trainer.resumed_from else ""),
              flush=True)
    # dense/fused: every int8 product of the run (the scoped mode is in the step)
    run_ctx = (int8_matmul(args.int8_matmul) if args.int8_matmul in ("dense", "fused")
               else contextlib.nullcontext())
    if args.train_data_dir:
        from ..data.native_image import native_error

        why = f" ({native_error()})" if images.decoder == "numpy" else ""
        if rank == 0:
            print(f"# {len(images)} images at {res} px" + (" a rank" if world > 1 else "")
                  + f", {images.decoder} decoder{why}", flush=True)
        data = DataLoader(images, proc_batch, make_collate(toks, res, sdxl=sdxl),
                          num_workers=args.dataloader_workers, seed=args.seed)
    else:
        data = batches(ds, proc_batch, args.seed)
    start = trainer.global_step
    reset_launch_counts()  # launches.jsonl counts the run alone, not the set-up
    with run_ctx:
        trainer.run(data, extra)
    if rank == 0:
        with open(os.path.join(args.output_dir, "launches.jsonl"), "a") as f:
            f.write(json.dumps({"from_step": start, "to_step": trainer.global_step,
                                "remat": args.remat, "remat_granularity": remat_gran,
                                "launches": launch_counts()}) + "\n")
    if multihost:
        torch.distributed.destroy_process_group()
    return trainer


if __name__ == "__main__":
    main()
