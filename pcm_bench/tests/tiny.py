"""TINY stand-ins of the cells for the CPU tests: the cells' own files with
the widths cut to the program's TINY presets and the traffic to a few rows."""

from __future__ import annotations

import copy

from pcm_bench import flops, harness

TINY_UNET = {"in_channels": 4, "out_channels": 4, "block_out_channels": [32, 64],
             "attn_blocks": [False, True], "num_heads": [2, 2], "transformer_depth": [1, 1],
             "layers_per_block": 1, "cross_attention_dim": 32, "use_linear_projection": True,
             "norm_groups": 32, "addition_embed_dim": 32, "addition_in_dim": 224}
TINY_MMDIT = {"in_channels": 4, "out_channels": 4, "patch_size": 2, "num_layers": 2,
              "num_heads": 2, "head_dim": 16, "joint_attention_dim": 32,
              "pooled_projection_dim": 32, "pos_embed_max_size": 32}
TRAIN_CELLS = ("sdxl-1024.train-cached.b16", "sd3-medium.train-cached.b8")


def tiny_cell(name: str, limits: float = 0.5) -> dict:
    """The cell's workload and configuration at TINY size, every compared
    number held to ``limits``."""
    spec = copy.deepcopy(harness.load_cell(name))
    cfg = spec["config_spec"]
    if cfg["family"] == "sdxl":
        cfg["unet"] = dict(TINY_UNET)
        spec.update(prompt_dim=32, pooled_dim=32)
    else:
        cfg["mmdit"] = dict(TINY_MMDIT)
        spec.update(prompt_dim=32, pooled_dim=32)
    cfg["prompt_len"] = 8
    spec.update(batch=4, cache_rows=16, latent_hw=8, prompt_len=8, check_steps=2,
                reference_rows=2, trace_seconds=0.5)
    spec["limits"] = {k: limits for k in spec["limits"]}
    cfg.update(flops.count(cfg, hw=spec["latent_hw"], prompt_len=8))
    return spec
