#!/usr/bin/env python
"""Where the device time of the port's served batch goes (CUDA only).

  python scripts/profile_serve_torch.py [--family sd15|sdxl|sd3] [--batch-size 4]
      [--steps 2] [--seed 0]

Builds the full-width bundle with random weights (SD1.5 at 512 px, SDXL and
SD3 at 1024 px with the serving CLI's decode chunk; SD3 samples with PCM-FM
on the serving CLI's 100-point grid), warms up one student batch (seeded
adapter, guidance 1.0) and one teacher batch (guidance 7.5; SD3's recipes'
3.0), then traces one more of each with ``torch.profiler``. For each it prints
the host wall time, the summed kernel time by category (the port's three
kernels, GEMMs, convolutions, the rest), the device idle share (1 - the
union of the device operations' intervals on the profiler's timeline / the
traced window: kernels that overlap count once), and the top kernels by
device time.
"""

import argparse
import collections
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402


def category(name: str) -> str:
    n = name.lower()
    for key, cat in (("flash_fwd_", "K1 flash attention"),
                     ("flash_bwd_dkv_kernel", "K2 flash attention dK/dV"),
                     ("dkv_reduce_kernel", "K2 flash attention dK/dV"),  # its q-split sum
                     ("flash_bwd_dq_kernel", "K3 flash attention dQ"), ("gn_", "K4 group norm"),
                     ("geglu_kernel", "K5 geglu"), ("int8_matmul", "K6 int8 matmul")):
        if key in n:
            return cat
    if "im2col" in n or "conv" in n or "implicit_convolve" in n or "xmma_fprop" in n:
        return "convolution"
    if "gemm" in n or "gemv" in n or "cutlass" in n or "sm90_xmma" in n or "cublas" in n:
        return "gemm"
    return "other"


def busy_us(prof) -> float:
    """Microseconds of the union of the device operations' intervals in
    ``prof`` (kernels, copies, sets; not the device-side spans of
    ``record_function`` scopes)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False))
    covered, end = 0.0, None
    for s, e in spans:
        if end is None or s > end:
            covered, end = covered + e - s, e
        elif e > end:
            covered, end = covered + e - end, e
    return covered


def trace(fn, label: str):
    """Profiles one call of ``fn``, prints its summary and returns the profile."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1000
    # kernels only: a record_function scope also shows as a device-side span
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    by_cat = collections.Counter()
    for e in kernels:
        by_cat[category(e.key)] += e.self_device_time_total / 1000
    busy = sum(by_cat.values())
    union_ms = busy_us(prof) / 1000
    print(f"== {label}: wall {wall_ms:.1f} ms, kernel time {busy:.1f} ms, device busy "
          f"{union_ms:.1f} ms, device idle share {1 - union_ms / wall_ms:.3f}")
    for cat, ms in by_cat.most_common():
        print(f"   {cat:20s} {ms:9.2f} ms  {ms / busy:6.1%}")
    print("   top kernels:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"   {e.self_device_time_total / 1000:9.2f} ms  x{e.count:<5d} {e.key[:100]}")
    return prof


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--family", default="sd15", choices=["sd15", "sdxl", "sd3"])
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")

    from pcm_tpu_torch.configs.families import (FAMILIES, SD3_PCM_TIMESTEPS, decode_chunk,
                                                sd3_bundle, sd15_bundle, sdxl_bundle)
    from pcm_tpu_torch.core.schedule import make_ddpm_schedule, make_flow_schedule
    from pcm_tpu_torch.data.tokenizer import resolve_tokenizers
    from pcm_tpu_torch.sampling.ddim import DDIMSampler
    from pcm_tpu_torch.sampling.pcm_fm import PCMFMSampler
    from pcm_tpu_torch.serving import EngineConfig, InferenceEngine
    from pcm_tpu_torch.train.bundles import adapter_like

    dev = torch.device("cuda")
    bundle = {"sd15": sd15_bundle, "sdxl": sdxl_bundle, "sd3": sd3_bundle}[args.family]()
    res, tok_keys = FAMILIES[args.family]
    gen = torch.Generator(dev).manual_seed(args.seed)
    frozen, template = bundle.init(gen, dev)
    if args.family == "sd3":
        sampler = PCMFMSampler.create(make_flow_schedule(), args.steps,
                                      SD3_PCM_TIMESTEPS)
    else:
        sampler = DDIMSampler.create(make_ddpm_schedule(), args.steps)
    toks = resolve_tokenizers(None, tok_keys)
    prompts = [f"a photo of subject {i}" for i in range(args.batch_size)]
    seeds = list(range(args.batch_size))
    for label, lora, cfg in (("student", adapter_like(template, gen), 1.0),
                             ("teacher", None, 3.0 if args.family == "sd3" else 7.5)):
        eng = InferenceEngine(bundle, sampler, frozen, lora, toks,
                              EngineConfig(batch_size=args.batch_size,
                                           latent_hw=res // bundle.vae_scale, resolution=res,
                                           guidance_scale=cfg,
                                           decode_chunk=decode_chunk(res)),
                              dev)
        eng.generate_batch(prompts, seeds)  # warm-up
        trace(lambda: eng.generate_batch(prompts, seeds),
              f"{args.family} {label} batch {args.batch_size} x {res}px, {args.steps} steps, "
              f"guidance {cfg}")
    print(torch.cuda.get_device_name(0))


if __name__ == "__main__":
    main()
