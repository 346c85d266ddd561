"""Few-step text-to-image generation with a distilled PCM LoRA on a CUDA card
(counterpart of `scripts/generate.py`).

  python -m pcm_tpu_torch.generate --family sd15 --teacher-checkpoint ckpts/sd15.pt \\
      --lora runs/sd15_4phase/pcm_lora_0005000.safetensors \\
      --prompt "a photo of a cat" --steps 2 --cfg 1.0 --out out.png [--scheduler tcd]
  python -m pcm_tpu_torch.generate --family sd3 --teacher-checkpoint ckpts/sd3.pt \\
      --lora pcm_sd3.safetensors --prompt "a photo of a cat" --steps 4 --scheduler fm_stoch

The flags are the JAX script's, and ``--device`` (``cuda``; ``--tiny
--device cpu`` runs the TINY configuration through the kernels' plain
versions, a smoke mode). ``--teacher-checkpoint`` is the file
``python -m pcm_tpu_torch.port_weights`` writes (``torch.save``d state dicts
of every module of the family). ``--lora`` takes a kohya file: SD1.5 and
SDXL under ``lora_unet``, SD3 under ``lora_transformer`` on the target list
whose layers the file holds (`configs/families.py:sd3_lora_targets`);
without it the teacher samples. SD1.5 and SDXL sample trailing DDIM
(``--scheduler ddim``, the default) or TCD (``tcd``, gamma 0.3); SD3 PCM-FM
(``fm_det``, the default, or ``fm_stoch``) on the flow schedule at
``--shift`` and the 100-point grid its recipes train on. Above ``--cfg`` 1
the uncond is ``--negative-prompt``. Row i's starting noise, and the fresh
noise of TCD and ``fm_stoch``, come from a generator seeded ``--seed + i``
on the device. At >= 1024 px the VAE decodes a sample a call unless
``--decode-chunk`` says otherwise. ``--weights int8`` stores the UNet or
MMDiT and the text weights as per-channel int8, as serving's ``--weights
int8`` does, for every family. One image is written to ``--out``, several to ``<out>_<i>.png``.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

# the family's schedulers; the first is the default
SCHEDULERS = {"sd15": ("ddim", "tcd"), "sdxl": ("ddim", "tcd"), "sd3": ("fm_det", "fm_stoch")}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m pcm_tpu_torch.generate")
    ap.add_argument("--family", required=True, choices=["sd15", "sdxl", "sd3"])
    ap.add_argument("--teacher-checkpoint", required=True,
                    help="the teacher file of `python -m pcm_tpu_torch.port_weights`")
    ap.add_argument("--lora", default=None, help="kohya-format LoRA safetensors")
    ap.add_argument("--prompt", required=True, nargs="+")
    ap.add_argument("--negative-prompt", default="")
    ap.add_argument("--steps", type=int, default=2, choices=[1, 2, 4, 8, 16])
    ap.add_argument("--cfg", type=float, default=1.0)
    ap.add_argument("--shift", type=float, default=3.0, help="SD3 sigma shift")
    ap.add_argument("--resolution", type=int, default=None)
    ap.add_argument("--scheduler", default=None, choices=["ddim", "tcd", "fm_det", "fm_stoch"])
    ap.add_argument("--tokenizer-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--decode-chunk", type=int, default=None,
                    help="VAE-decode this many images at a time (default: one at >= 1024 px)")
    ap.add_argument("--out", default="out.png")
    ap.add_argument("--weights", default="bf16", choices=["bf16", "int8"],
                    help="int8 = per-channel int8 UNet / MMDiT and text weights (the VAE stays bf16)")
    ap.add_argument("--tiny", action="store_true", help="tiny-model smoke mode")
    ap.add_argument("--device", default="cuda")
    return ap


def check_args(ap: argparse.ArgumentParser, args: argparse.Namespace) -> None:
    """Refuse what is not ported and a scheduler of another family."""
    if args.scheduler is not None and args.scheduler not in SCHEDULERS[args.family]:
        ap.error(f"--scheduler {args.scheduler} is not one of --family {args.family}'s "
                 f"{SCHEDULERS[args.family]}")
    if args.lora and not os.path.isfile(args.lora):
        ap.error(f"--lora {args.lora}: no such file")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu (with --tiny) to smoke-test on the CPU")


def load_lora(bundle, frozen: dict, family: str, path: str, device: torch.device) -> dict:
    """The kohya file ``path`` as an adapter dict of the family's backbone, on ``device``."""
    from .lora.kohya import load_kohya_safetensors
    from .lora.layers import lora_shapes

    backbone = frozen["mmdit" if family == "sd3" else "unet"]
    template = {k: torch.zeros(s) for k, s in lora_shapes(backbone, bundle.lora.rank).items()}
    tree, _ = load_kohya_safetensors(path, template, bundle.lora.rank, bundle.KOHYA_PREFIX)
    return {k: v.to(device) for k, v in tree.items()}


def make_sampler(family: str, scheduler: str, steps: int, shift: float):
    """The family's sampler: PCM-FM for SD3 (``fm_stoch`` stochastic), TCD or
    trailing DDIM for SD1.5 and SDXL."""
    from .configs.families import SD3_PCM_TIMESTEPS
    from .core.schedule import make_ddpm_schedule, make_flow_schedule
    from .sampling.ddim import DDIMSampler, TCDSampler
    from .sampling.pcm_fm import PCMFMSampler

    if family == "sd3":
        return PCMFMSampler.create(make_flow_schedule(shift=shift), steps, SD3_PCM_TIMESTEPS,
                                   stochastic=scheduler == "fm_stoch")
    if scheduler == "tcd":
        return TCDSampler.create(make_ddpm_schedule(), steps)
    return DDIMSampler.create(make_ddpm_schedule(), steps)


def build(args: argparse.Namespace) -> dict:
    """The bundle, its weights (``--teacher-checkpoint``, ``--weights``), the
    ``--lora`` adapter (None: the teacher), the tokenizers, the pipeline and
    the resolution the flags describe."""
    from .configs.families import FAMILIES, sd3_bundle, sd3_lora_targets, sd15_bundle, sdxl_bundle
    from .data.tokenizer import resolve_tokenizers
    from .port_weights import FAMILY_MODULES
    from .sampling.pipeline import TextToImagePipeline

    device = torch.device(args.device)
    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    default_res, tok_keys = FAMILIES[args.family]
    make_bundle = {"sd15": sd15_bundle, "sdxl": sdxl_bundle, "sd3": sd3_bundle}[args.family]
    targets = sd3_lora_targets(args.lora, args.tiny) if args.family == "sd3" and args.lora else {}
    bundle = make_bundle(dtype=dtype, tiny=args.tiny, **targets)
    states = torch.load(args.teacher_checkpoint, weights_only=True)
    lacking = [m for m, _ in FAMILY_MODULES[args.family] if m not in states]
    if lacking:
        raise SystemExit(f"--teacher-checkpoint {args.teacher_checkpoint} lacks {lacking}")
    frozen = bundle.from_states(states, device)
    del states
    lora = load_lora(bundle, frozen, args.family, args.lora, device) if args.lora else None
    if args.weights == "int8":
        from .utils.quant import quantize_frozen

        frozen = quantize_frozen(frozen, min_size=0 if args.tiny else 65536)
    sampler = make_sampler(args.family, args.scheduler or SCHEDULERS[args.family][0],
                           args.steps, args.shift)
    return {"bundle": bundle, "frozen": frozen, "lora": lora, "device": device,
            "toks": resolve_tokenizers(args.tokenizer_dir, tok_keys),
            "pipe": TextToImagePipeline(bundle, sampler),
            "resolution": args.resolution or default_res}


def noise(built: dict, args: argparse.Namespace):
    """Row i's generator, seeded ``--seed + i`` on the device, and the
    starting noise it draws first: ``(init, generators)``."""
    bundle, device = built["bundle"], built["device"]
    gens = [torch.Generator(device).manual_seed(args.seed + i) for i in range(len(args.prompt))]
    side = built["resolution"] // bundle.vae_scale
    init = torch.stack([torch.randn((side, side, bundle.latent_channels), generator=g,
                                    device=device) for g in gens])
    return init, gens


def generate(built: dict, args: argparse.Namespace, decode: bool = True,
             start=None) -> torch.Tensor:
    """(N, H, W, 3) images in [-1, 1] of ``--prompt`` (or, ``decode=False``,
    the final latents), from `noise` or from ``start``, an ``(init,
    generators)`` pair in its place."""
    from .configs.families import decode_chunk
    from .serving.engine import make_prompt_encoder

    bundle, device, res = built["bundle"], built["device"], built["resolution"]
    encode = make_prompt_encoder(bundle, built["toks"], built["frozen"], device, res)
    cond = encode(args.prompt)
    uncond = encode([args.negative_prompt] * len(args.prompt)) if args.cfg > 1.0 else None
    init, gens = start or noise(built, args)
    chunk = args.decode_chunk or decode_chunk(res)
    return built["pipe"].generate(built["frozen"], built["lora"], cond, uncond, init, args.cfg,
                                  chunk, renoise=gens, decode=decode)


def output_paths(out: str, n: int):
    return [out] if n == 1 else [out.replace(".png", f"_{i}.png") for i in range(n)]


def main(argv=None) -> dict:
    """Parse ``argv``, generate and write the PNGs; returns the built models
    and the batch's milliseconds (host clock around a synchronized call)."""
    from .utils.png import to_uint8, write_png

    ap = build_parser()
    args = ap.parse_args(argv)
    check_args(ap, args)
    built = build(args)
    device = built["device"]
    t0 = time.perf_counter()
    images = generate(built, args).float()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    ms = (time.perf_counter() - t0) * 1000.0
    if not torch.isfinite(images).all():
        raise FloatingPointError("non-finite pixels in the generated batch")
    arr = to_uint8(images.cpu().numpy())
    print(f"# {len(arr)} images, {args.steps} steps, {built['pipe'].sampler.__class__.__name__}"
          f", cfg {args.cfg:g}: {ms:.1f} ms", flush=True)
    for path, img in zip(output_paths(args.out, len(arr)), arr):
        write_png(path, img)
        print("wrote", path, flush=True)
    return {"built": built, "args": args, "ms": ms}


if __name__ == "__main__":
    main()
