"""Serve SD1.5 or SDXL over HTTP with request batching on a CUDA card.

  python -m pcm_tpu_torch.serving --steps 2 --batch-size 4 --port 8000
  python -m pcm_tpu_torch.serving --family sdxl [--lora pcm_lora_<step>.safetensors] [--cfg 7.5]
  curl -s localhost:8000/generate -d '{"prompt": "an astronaut", "seed": 1}'

The flags are those of `scripts/serve.py`: ``--family sd15`` at 512 px and
``--family sdxl`` at 1024 px by default (``--resolution``); at >= 1024 px
the VAE decodes one sample a call (`decode_chunk`). SD3 is not ported.
``--lora <file>`` serves a kohya ``.safetensors`` LoRA (the trainer's
``pcm_lora_<step>.safetensors``) as the default adapter; with it, or with
``--enable-lora-swap`` (a no-op adapter), ``POST /lora`` swaps adapters live.
``--weights int8`` stores the UNet and text weights as per-channel int8 and
dequantizes each at its use (weight-only: the products stay bf16). Without
``--teacher-checkpoint`` (``torch.save``d state dicts of ``unet``, ``vae``,
``text`` and, for SDXL, ``text2``) the weights are drawn on the device from
``--seed``.
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
FAMILIES = {"sd15": (512, ["input_ids"]), "sdxl": (1024, ["input_ids", "input_ids_2"])}


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
                         "(SDXL: also 'text2')")
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
    ap.add_argument("--stochastic", action="store_true", help="SD3 only (not yet ported)")
    ap.add_argument("--tiny", action="store_true", help="tiny-model smoke mode")
    ap.add_argument("--enable-lora-swap", action="store_true",
                    help="start with a no-op adapter so adapters can be swapped in later")
    ap.add_argument("--data-parallel", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0, help="seed of the random weights")
    return ap


def check_args(ap: argparse.ArgumentParser, args: argparse.Namespace) -> None:
    """Refuse what is not ported, and a ``--lora`` that is not a file."""
    if args.family not in FAMILIES:
        ap.error(f"--family {args.family} is not yet ported (sd15, sdxl)")
    if args.lora and not os.path.isfile(args.lora):
        ap.error(f"--lora {args.lora}: no such file")
    if args.stochastic or args.data_parallel != 1:
        ap.error("--stochastic and --data-parallel are not yet ported")


def build_engine(args: argparse.Namespace):
    """The `InferenceEngine` the flags describe: weights drawn from ``--seed``
    (or ``--teacher-checkpoint``), the ``--lora`` file as its adapter."""
    from ..configs.families import sd15_bundle, sdxl_bundle
    from ..core.schedule import make_ddpm_schedule
    from ..data.tokenizer import resolve_tokenizers
    from ..sampling.ddim import DDIMSampler
    from .engine import EngineConfig, InferenceEngine

    device = torch.device(args.device)
    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    default_res, tok_keys = FAMILIES[args.family]
    make_bundle = sd15_bundle if args.family == "sd15" else sdxl_bundle
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
    engine = InferenceEngine(
        bundle, DDIMSampler.create(make_ddpm_schedule(), args.steps), frozen, lora, toks,
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
