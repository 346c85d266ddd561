"""Serve SD1.5 over HTTP with request batching on a CUDA card.

  python -m pcm_tpu_torch.serving --steps 2 --batch-size 4 --port 8000
  curl -s localhost:8000/generate -d '{"prompt": "an astronaut", "seed": 1}'

The flags are those of `scripts/serve.py`. So far only ``--family sd15`` is
ported. ``--weights int8`` stores the UNet and text weights as per-channel
int8 and dequantizes each at its use (weight-only: the products stay bf16).
Without ``--teacher-checkpoint`` the weights are drawn on the device from
``--seed``. ``--tiny --device cpu`` runs the tiny configuration on the CPU
through the kernels' plain versions (a smoke mode; with ``--weights int8``
it quantizes every Linear and conv weight: all but a few TINY weights are
under the 65536-element threshold).
"""

from __future__ import annotations

import argparse

import torch


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m pcm_tpu_torch.serving")
    ap.add_argument("--family", default="sd15", choices=["sd15", "sdxl", "sd3"])
    ap.add_argument("--teacher-checkpoint", default=None,
                    help="torch.save'd {'unet': sd, 'vae': sd, 'text': sd} state dicts")
    ap.add_argument("--lora", default=None, help="kohya safetensors LoRA (not yet ported)")
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


def main(argv=None) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.family != "sd15":
        ap.error(f"--family {args.family} is not yet ported (sd15 only)")
    if args.lora:
        ap.error("--lora: loading a kohya LoRA file is not yet ported")
    if args.stochastic or args.data_parallel != 1:
        ap.error("--stochastic and --data-parallel are not yet ported")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu (with --tiny) to smoke-test on the CPU")

    from ..configs.families import sd15_bundle
    from ..core.schedule import make_ddpm_schedule
    from ..sampling.ddim import DDIMSampler
    from .engine import EngineConfig, InferenceEngine
    from .server import BatchingServer

    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    bundle = sd15_bundle(dtype=dtype, tiny=args.tiny)
    gen = torch.Generator(device).manual_seed(args.seed)
    frozen, template = bundle.init(gen, device)
    if args.teacher_checkpoint:
        frozen = bundle.from_states(torch.load(args.teacher_checkpoint, weights_only=True), device)
    if args.weights == "int8":
        from ..utils.quant import quantize_frozen

        frozen = quantize_frozen(frozen, min_size=0 if args.tiny else 65536)
    lora = template if args.enable_lora_swap else None

    from ..data.tokenizer import resolve_tokenizers

    toks = resolve_tokenizers(args.tokenizer_dir, ["input_ids"])
    res = args.resolution or 512
    engine = InferenceEngine(
        bundle, DDIMSampler.create(make_ddpm_schedule(), args.steps), frozen, lora, toks,
        EngineConfig(batch_size=args.batch_size, latent_hw=res // bundle.vae_scale,
                     guidance_scale=args.cfg),
        device,
    )
    print(f"# warming up sd15 {args.steps}-step engine (bs={args.batch_size}) on {device}...",
          flush=True)
    engine.warmup()
    server = BatchingServer(engine, args.host, args.port, args.max_wait_ms)
    print(f"# serving on http://{args.host}:{server.address[1]}", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
