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
adapter), ``POST /lora`` swaps adapters live. An SD3 engine takes its
adapter's layers from the file: the base list of the SD3 recipes, the
adversarial one or the stochastic-adversarial one (`sd3_lora_targets`); a
file of any other layers is refused, as is any file holding layers outside
the engine's adapter (every layer of a file is served, or none).
``--weights int8`` stores the UNet or MMDiT and the text weights as
per-channel int8 (the VAE and the embeddings stay bf16) and dequantizes
each at its use (weight-only: the products stay bf16), for every family, as
`scripts/serve.py` does. Without ``--teacher-checkpoint`` (``torch.save``d state dicts of
``unet``, ``vae``, ``text`` and, for SDXL, ``text2``; for SD3 ``mmdit``,
``vae``, ``text``, ``text2`` and ``t5``) the weights are drawn on the device
from ``--seed``.
``--data-parallel N`` serves each batch on ``cuda:0`` ... ``cuda:N-1``: a
replica of the weights on each card, each card a contiguous chunk of the
batch (``--batch-size`` must divide by N, and N must not exceed the visible
cards; `serving/engine.py`); a request's image is the one a single card
gives it.
``--tiny --device cpu`` runs the tiny configuration on the CPU through the
kernels' plain versions (a smoke mode; with ``--weights int8`` it quantizes
every Linear and conv weight: all but a few TINY weights are under the
65536-element threshold).
"""

from __future__ import annotations

import argparse
import os

import torch

from ..configs.families import FAMILIES, SD3_PCM_TIMESTEPS, decode_chunk, sd3_lora_targets


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
    ap.add_argument("--data-parallel", type=int, default=1,
                    help="split each batch over this many cards (--batch-size must divide by "
                         "it); 1 = one card")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0, help="seed of the random weights")
    return ap


def check_args(ap: argparse.ArgumentParser, args: argparse.Namespace) -> None:
    """Refuse what is not ported, a ``--lora`` that is not a file and a
    ``--data-parallel`` that the batch or the cards cannot take."""
    if args.lora and not os.path.isfile(args.lora):
        ap.error(f"--lora {args.lora}: no such file")
    if args.stochastic and args.family != "sd3":
        ap.error("--stochastic is SD3's sampler (--family sd3)")
    if args.data_parallel < 1:
        ap.error("--data-parallel must be at least 1")
    if args.batch_size % args.data_parallel:
        ap.error("--batch-size must be divisible by --data-parallel")
    cards = torch.cuda.device_count()
    if torch.device(args.device).type == "cuda" and 1 < args.data_parallel > cards:
        ap.error(f"--data-parallel {args.data_parallel} > {cards} visible devices")
    if args.family == "sd3" and args.lora:
        try:
            sd3_lora_targets(args.lora, args.tiny)
        except ValueError as e:
            ap.error(str(e))


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
    if device.type == "cuda" and args.data_parallel > 1:
        device = torch.device("cuda", 0)
    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    default_res, tok_keys = FAMILIES[args.family]
    make_bundle = {"sd15": sd15_bundle, "sdxl": sdxl_bundle, "sd3": sd3_bundle}[args.family]
    targets = sd3_lora_targets(args.lora, args.tiny) if args.family == "sd3" and args.lora else {}
    bundle = make_bundle(dtype=dtype, tiny=args.tiny, **targets)
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
    devices = ([torch.device("cuda", i) for i in range(args.data_parallel)]
               if device.type == "cuda" and args.data_parallel > 1
               else [device] * args.data_parallel)
    engine = InferenceEngine(
        bundle, sampler, frozen, lora, toks,
        EngineConfig(batch_size=args.batch_size, latent_hw=res // bundle.vae_scale,
                     resolution=res, guidance_scale=args.cfg,
                     decode_chunk=decode_chunk(res)),
        devices,
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
    print(f"# warming up {args.family} {args.steps}-step engine (bs={args.batch_size}) on "
          + ", ".join(map(str, engine.devices))
          + (f" with {args.lora}" if args.lora else "") + "...", flush=True)
    engine.warmup()
    server = BatchingServer(engine, args.host, args.port, args.max_wait_ms)
    print(f"# serving on http://{args.host}:{server.address[1]}", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
