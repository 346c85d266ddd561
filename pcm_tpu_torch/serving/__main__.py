"""Serve SD1.5, SDXL or SD3 over HTTP with request batching on a CUDA card.

  python -m pcm_tpu_torch.serving --steps 2 --batch-size 4 --port 8000
  python -m pcm_tpu_torch.serving --family sdxl [--lora pcm_lora_<step>.safetensors] [--cfg 7.5]
  python -m pcm_tpu_torch.serving --family sd3 [--stochastic] [--lora pcm_sd3.safetensors] \
      [--cfg 3.0]
  curl -s localhost:8000/generate -d '{"prompt": "an astronaut", "seed": 1}'

The flags are those of `scripts/serve.py`: ``--family sd15`` at 512 px,
``--family sdxl`` and ``--family sd3`` at 1024 px by default
(``--resolution``); at >= 1024 px the VAE decodes one sample a call
(`decode_chunk`). SD1.5 and SDXL sample with trailing DDIM; SD3 with the
PCM-FM sampler on the flow schedule at shift 3 and the 100-point grid the SD3
recipes train on (``--stochastic``: its stochastic variant, each request's
fresh noise from its own seed), and its text goes through CLIP-L, CLIP-bigG
and T5-XXL (three tokenizers).
``--lora <file>`` serves a kohya ``.safetensors`` LoRA (the trainer's
``pcm_lora_<step>.safetensors``; SD3's keys under ``lora_transformer``) as
the default adapter; with it, or with ``--enable-lora-swap`` (a no-op
adapter), ``POST /lora`` swaps adapters live.
``--weights int8`` stores the UNet and text weights as per-channel int8 and
dequantizes each at its use (weight-only: the products stay bf16); not yet
with SD3. Without ``--teacher-checkpoint`` (``torch.save``d state dicts of
``unet``, ``vae``, ``text`` and, for SDXL, ``text2``; for SD3 ``mmdit``,
``vae``, ``text``, ``text2`` and ``t5``) the weights are drawn on the device
from ``--seed``.
``--tiny --device cpu`` runs the tiny configuration on the CPU through the
kernels' plain versions (a smoke mode; with ``--weights int8`` it quantizes
every Linear and conv weight: all but a few TINY weights are under the
65536-element threshold).
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import torch

# family -> (default resolution, token keys), as `scripts/serve.py:66-75`
FAMILIES = {"sd15": (512, ["input_ids"]), "sdxl": (1024, ["input_ids", "input_ids_2"]),
            "sd3": (1024, ["input_ids", "input_ids_2", "input_ids_3"])}
# the SD3 sampler's grid: the 100 solver steps the SD3 recipes train on (as
# `bench.py:build_infer` and `scripts/generate.py` sample; `scripts/serve.py`
# takes the sampler's default of 50, whose 4-step sigmas miss a 4-phase
# student's boundaries)
SD3_PCM_TIMESTEPS = 100


def decode_chunk(resolution: int) -> Optional[int]:
    """Samples a VAE decode call: one at >= 1024 px, else the batch. The
    reference decodes in chunks of 2 there when the batch is above 4
    (`scripts/serve.py:127`, for memory). On the H100 the decoder's cuDNN
    convolutions at 1024 px round a sample differently by its position in
    the batch, so one sample a call keeps a request's image the same in any
    batch (and holds less memory than 2)."""
    return 1 if resolution >= 1024 else None


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m pcm_tpu_torch.serving")
    ap.add_argument("--family", default="sd15", choices=["sd15", "sdxl", "sd3"])
    ap.add_argument("--teacher-checkpoint", default=None,
                    help="torch.save'd {'unet': sd, 'vae': sd, 'text': sd} state dicts "
                         "(SDXL: also 'text2'; SD3: 'mmdit', 'vae', 'text', 'text2', 't5')")
    ap.add_argument("--lora", default=None,
                    help="kohya safetensors LoRA, the default adapter (implies "
                         "--enable-lora-swap)")
    ap.add_argument("--tokenizer-dir", default=None)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--cfg", type=float, default=1.0)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--resolution", type=int, default=None)
    ap.add_argument("--max-wait-ms", type=float, default=50.0)
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--weights", default="bf16", choices=["bf16", "int8"])
    ap.add_argument("--stochastic", action="store_true",
                    help="SD3: the stochastic PCM-FM sampler")
    ap.add_argument("--tiny", action="store_true", help="tiny-model smoke mode")
    ap.add_argument("--enable-lora-swap", action="store_true",
                    help="start with a no-op adapter so adapters can be swapped in later")
    ap.add_argument("--data-parallel", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0, help="seed of the random weights")
    return ap


def check_args(ap: argparse.ArgumentParser, args: argparse.Namespace) -> None:
    """Refuse what is not ported, and a ``--lora`` that is not a file."""
    if args.lora and not os.path.isfile(args.lora):
        ap.error(f"--lora {args.lora}: no such file")
    if args.stochastic and args.family != "sd3":
        ap.error("--stochastic is SD3's sampler (--family sd3)")
    if args.family == "sd3" and args.weights == "int8":
        ap.error("--weights int8 with --family sd3 is not yet ported (bf16)")
    if args.data_parallel != 1:
        ap.error("--data-parallel is not yet ported")


def build_engine(args: argparse.Namespace):
    """The `InferenceEngine` the flags describe: weights drawn from ``--seed``
    (or ``--teacher-checkpoint``), the ``--lora`` file as its adapter."""
    from ..configs.families import sd3_bundle, sd15_bundle, sdxl_bundle
    from ..core.schedule import make_ddpm_schedule, make_flow_schedule
    from ..data.tokenizer import resolve_tokenizers
    from ..sampling.ddim import DDIMSampler
    from ..sampling.pcm_fm import PCMFMSampler
    from .engine import EngineConfig, InferenceEngine

    device = torch.device(args.device)
    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    default_res, tok_keys = FAMILIES[args.family]
    make_bundle = {"sd15": sd15_bundle, "sdxl": sdxl_bundle, "sd3": sd3_bundle}[args.family]
    bundle = make_bundle(dtype=dtype, tiny=args.tiny)
    gen = torch.Generator(device).manual_seed(args.seed)
    frozen, template = bundle.init(gen, device)
    if args.teacher_checkpoint:
        frozen = bundle.from_states(torch.load(args.teacher_checkpoint, weights_only=True), device)
    if args.weights == "int8":
        from ..utils.quant import quantize_frozen

        frozen = quantize_frozen(frozen, min_size=0 if args.tiny else 65536)
    lora = template if args.enable_lora_swap or args.lora else None
    toks = resolve_tokenizers(args.tokenizer_dir, tok_keys)
    res = args.resolution or default_res
    if args.family == "sd3":
        sampler = PCMFMSampler.create(make_flow_schedule(), args.steps,
                                      SD3_PCM_TIMESTEPS, stochastic=args.stochastic)
    else:
        sampler = DDIMSampler.create(make_ddpm_schedule(), args.steps)
    engine = InferenceEngine(
        bundle, sampler, frozen, lora, toks,
        EngineConfig(batch_size=args.batch_size, latent_hw=res // bundle.vae_scale,
                     resolution=res, guidance_scale=args.cfg,
                     decode_chunk=decode_chunk(res)),
        device,
    )
    if args.lora:
        engine.load_lora(args.lora, swap=False)
    return engine


def main(argv=None) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)
    check_args(ap, args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu (with --tiny) to smoke-test on the CPU")
    from .server import BatchingServer

    engine = build_engine(args)
    print(f"# warming up {args.family} {args.steps}-step engine (bs={args.batch_size}) on {device}"
          + (f" with {args.lora}" if args.lora else "") + "...", flush=True)
    engine.warmup()
    server = BatchingServer(engine, args.host, args.port, args.max_wait_ms)
    print(f"# serving on http://{args.host}:{server.address[1]}", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
