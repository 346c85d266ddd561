"""Timestep embeddings (diffusers conventions, as `pcm_tpu/models/embeddings.py`)."""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..lora.layers import LoRALinear


def sinusoidal_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0,
                         flip_sin_to_cos: bool = True,
                         downscale_freq_shift: float = 0.0) -> torch.Tensor:
    """Sinusoidal timestep embedding in fp32, ``(N,) -> (N, dim)``."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device)
    freqs = torch.exp(exponent / (half - downscale_freq_shift))
    args = t.float()[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    """linear -> SiLU -> linear lifting the sinusoid to the model width (the
    JAX module's `LoRADense` layers: an int8 weight takes the int8 path)."""

    def __init__(self, in_dim: int, embed_dim: int):
        super().__init__()
        self.linear_1 = LoRALinear(in_dim, embed_dim)
        self.linear_2 = LoRALinear(embed_dim, embed_dim)

    def forward(self, sample: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(sample)))
