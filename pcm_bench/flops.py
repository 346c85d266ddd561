"""Operations of a training step a sample, counted once over the plain
reference on the meta device with `torch.utils.flop_counter.FlopCounterMode`
(matrix products, convolutions and their backward; attention written out
as two batched products), so the count reads the same work whatever
implements the step.

    python3 -m pcm_bench.flops <config>

prints the configuration file's ``flops_per_sample`` and ``attention``
groups: a remat-free training step at batch 1 (the CFG teacher forward of a
cond and an uncond row, the target forward, the student forward and its
backward w.r.t. the LoRA factors; no recompute), and one sample's attention
forward (QKᵀ and PV of every attention layer: operations, and bytes as
`roofline.attn_work` counts them).
"""

from __future__ import annotations

import argparse
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from . import harness, roofline
from .reference import layers as ref_layers
from .traffic.train_cached import family, reference_model

LATENT_HW = 128  # 1024 px over the VAE's factor of 8


def _unet_inputs(u, rows: int, hw: int, prompt_len: int):
    m = torch.device("meta")
    x = torch.empty(rows, u["in_channels"], hw, hw, device=m)
    ctx = torch.empty(rows, prompt_len, u["cross_attention_dim"], device=m)
    pooled = u["addition_in_dim"] - 6 * u["addition_embed_dim"]
    added = {"text_embeds": torch.empty(rows, pooled, device=m),
             "time_ids": torch.empty(rows, 6, device=m)}
    return lambda model, lora: model(x, torch.zeros(rows, device=m), ctx, lora, added)


def _mmdit_inputs(c, rows: int, hw: int, prompt_len: int):
    m = torch.device("meta")
    x = torch.empty(rows, hw, hw, c["in_channels"], device=m)
    ctx = torch.empty(rows, prompt_len, c["joint_attention_dim"], device=m)
    pooled = torch.empty(rows, c["pooled_projection_dim"], device=m)
    return lambda model, lora: model(x, torch.zeros(rows, device=m), ctx, pooled, lora)


INPUTS = {"unet": _unet_inputs, "mmdit": _mmdit_inputs}  # by the family's backbone


def _inputs(cfg, rows: int, hw: int, prompt_len: int):
    backbone = family(cfg).backbone
    return INPUTS[backbone](cfg[backbone], rows, hw, prompt_len)


def count(cfg, hw: int = LATENT_HW, prompt_len: int = None) -> dict:
    """``{"flops_per_sample": {"train": ...}, "attention": {...}}`` of ``cfg``."""

    prompt_len = prompt_len or cfg["prompt_len"]
    model = reference_model(cfg, "meta")
    shapes = ref_layers.lora_shapes(model, cfg["lora"]["rank"])
    lora = {k: torch.empty(s, device="meta", requires_grad=True) for k, s in shapes.items()}
    with FlopCounterMode(display=False) as fc:
        with torch.no_grad():
            _inputs(cfg, 2, hw, prompt_len)(model, None)
            _inputs(cfg, 1, hw, prompt_len)(model, lora)
        out = _inputs(cfg, 1, hw, prompt_len)(model, lora)
        out.float().square().mean().backward()
    ref_layers.ATTENTION_TALLY = []
    try:
        with torch.no_grad():
            _inputs(cfg, 1, hw, prompt_len)(model, None)
        calls = ref_layers.ATTENTION_TALLY
    finally:
        ref_layers.ATTENTION_TALLY = None
    work = [roofline.attn_work(s, 2, 1) for s in calls]
    return {"flops_per_sample": {"train": float(fc.get_total_flops())},
            "attention": {"fwd_flops_per_sample": sum(w[0] for w in work),
                          "fwd_bytes_per_sample": sum(w[1] for w in work),
                          "layers": len(calls)}}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python3 -m pcm_bench.flops")
    ap.add_argument("config")
    args = ap.parse_args(argv)
    cfg = harness.load_json(harness.HERE / "configs" / f"{args.config}.json")
    print(json.dumps(count(cfg), indent=1))


if __name__ == "__main__":
    main()
