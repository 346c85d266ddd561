"""Write a latent cache of an image folder (counterpart of `scripts/cache_latents.py`).

  python -m pcm_tpu_torch.data.cache_latents --family sd15|sdxl --train-data-dir imgs/ \\
      --output-dir cache/ [--resolution 512|1024] [--teacher-checkpoint ckpt.pt] \\
      [--tokenizer-dir tok/] [--shard-size 256] [--batch 8] [--seed 0]

One sequential pass over `data/dataset.py:ImageFolderDataset` (no shuffle,
the ragged tail dropped), each batch through the VAE encoder (a posterior
sample) and the text towers, into ``shard_*.npz`` files, as
`scripts/cache_latents.py` writes them: SD1.5 (center crop, 512 px by
default) ``latents`` (N, h, w, 4) and CLIP-L's ``prompt_embeds`` (N, 77,
768); SDXL (random crop, 1024 px by default) also ``pooled_embeds`` (N,
1280) and ``time_ids`` (N, 6) in float32, ``prompt_embeds`` (N, 77, 2048).
bf16 tensors are stored as fp16, so both packages' cache readers take them
(``--cached-latents-dir`` of either trainer). The posterior noise comes from
one generator seeded with ``--seed``, a fresh draw a batch. Without
``--teacher-checkpoint`` the weights are drawn from ``--seed`` as the
trainer draws them (SDXL draws the VAE and the towers alone: each has a
stream of its own); without ``--tokenizer-dir`` captions are hashed.
``--tiny --device cpu`` runs the tiny configuration on the CPU.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m pcm_tpu_torch.data.cache_latents")
    ap.add_argument("--family", required=True, choices=["sd15", "sdxl", "sd3"])
    ap.add_argument("--train-data-dir", required=True)
    ap.add_argument("--output-dir", required=True)
    ap.add_argument("--resolution", type=int, default=None,
                    help="image side (default: 512 for sd15, 1024 for sdxl)")
    ap.add_argument("--teacher-checkpoint", default=None,
                    help="torch.save'd {'unet': sd, 'vae': sd, 'text': sd} state dicts "
                         "(SDXL: {'vae', 'text', 'text2'} suffice)")
    ap.add_argument("--tokenizer-dir", default=None)
    ap.add_argument("--shard-size", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tiny", action="store_true", help="tiny configuration (smoke mode)")
    ap.add_argument("--device", default="cuda")
    return ap


def _host(t: torch.Tensor) -> np.ndarray:
    """bf16 -> fp16 (the cache's storage of bf16), other dtypes as they are."""
    t = t.detach()
    return (t.half() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.family not in ("sd15", "sdxl"):
        ap.error(f"--family {args.family} is not yet ported to pcm_tpu_torch (sd15, sdxl)")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu (with --tiny) to smoke-test on the CPU")

    from ..configs.families import sd15_bundle, sdxl_bundle
    from .dataset import ImageFolderDataset, make_collate
    from .tokenizer import resolve_tokenizers

    sdxl = args.family == "sdxl"
    res = args.resolution or (1024 if sdxl else 512)
    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    gen = torch.Generator(device).manual_seed(args.seed)
    if sdxl:
        bundle = sdxl_bundle(dtype=dtype, tiny=args.tiny)
        frozen, _ = bundle.init(gen, device, modules=("vae", "text", "text2"))
        tok_keys = ["input_ids", "input_ids_2"]
    else:
        bundle = sd15_bundle(dtype=dtype, tiny=args.tiny)
        frozen, _ = bundle.init(gen, device)
        tok_keys = ["input_ids"]
    if args.teacher_checkpoint:
        frozen = bundle.from_states(torch.load(args.teacher_checkpoint, weights_only=True), device)
    collate = make_collate(resolve_tokenizers(args.tokenizer_dir, tok_keys), res, sdxl=sdxl)
    ds = ImageFolderDataset(args.train_data_dir, resolution=res, seed=args.seed,
                            crop="random" if sdxl else "center")
    noise_gen = torch.Generator(device).manual_seed(args.seed)
    s = bundle.vae_scale
    lat_shape = (res // s, res // s, bundle.vae_cfg.latent_channels)

    os.makedirs(args.output_dir, exist_ok=True)
    buf, shard, done = [], 0, 0

    def flush():
        nonlocal buf, shard
        if buf:
            merged = {k: np.concatenate([b[k] for b in buf]) for k in buf[0]}
            path = os.path.join(args.output_dir, f"shard_{shard:05d}.npz")
            np.savez(path, **merged)
            print(f"wrote {path} ({merged['latents'].shape[0]} samples)", flush=True)
            buf, shard = [], shard + 1

    with torch.no_grad():
        for start in range(0, len(ds) - args.batch + 1, args.batch):
            batch = collate([ds.get(i) for i in range(start, start + args.batch)])
            pixels = torch.from_numpy(batch["pixel_values"]).to(device)
            ids = [torch.from_numpy(batch[k]).long().to(device) for k in tok_keys]
            noise = torch.randn((args.batch, *lat_shape), generator=noise_gen, device=device,
                                dtype=dtype)
            out = {"latents": _host(bundle.encode_pixels(frozen, pixels, noise))}
            if sdxl:
                time_ids = torch.from_numpy(batch["time_ids"]).to(device)
                cond = bundle.encode_prompts(frozen, *ids, time_ids)
                out.update(prompt_embeds=_host(cond["prompt_embeds"]),
                           pooled_embeds=_host(cond["added_cond"]["text_embeds"]),
                           time_ids=batch["time_ids"])
            else:
                out["prompt_embeds"] = _host(bundle.encode_prompts(frozen, *ids)["prompt_embeds"])
            buf.append(out)
            done += args.batch
            if sum(b["latents"].shape[0] for b in buf) >= args.shard_size:
                flush()
    flush()
    print(f"cached {done} samples ({ds.decoder} decoder) -> {args.output_dir}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
