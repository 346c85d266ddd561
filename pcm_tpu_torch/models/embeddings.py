"""Embeddings of the diffusion backbones (diffusers conventions, as
`pcm_tpu/models/embeddings.py`): the timestep sinusoid and MLP, SD3's pooled
text projection and its latent patchifier."""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..lora.layers import LoRA, LoRAConv, LoRALinear


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

    def forward(self, sample: torch.Tensor, lora: LoRA = None) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(sample, lora)), lora)


class PixArtAlphaTextProjection(TimestepEmbedding):
    """SD3's pooled-text projection: linear -> SiLU -> linear, as `TimestepEmbedding`."""


class PatchEmbed(nn.Module):
    """MMDiT's latent patchifier: a p x p conv of stride p (``proj``) plus a
    learned position table ``pos_embed`` (1, max, max, dim), center-cropped
    to the latent grid (`pcm_tpu/models/embeddings.py:82-108`). NHWC in,
    (N, h/p * w/p, dim) tokens out, row-major over the patch grid."""

    def __init__(self, patch_size: int, in_channels: int, embed_dim: int,
                 pos_embed_max_size: int):
        super().__init__()
        self.patch_size, self.max_size = patch_size, pos_embed_max_size
        self.proj = LoRAConv(in_channels, embed_dim, patch_size, stride=patch_size)
        self.pos_embed = nn.Parameter(
            torch.zeros(1, pos_embed_max_size, pos_embed_max_size, embed_dim))

    def forward(self, x: torch.Tensor, lora: LoRA = None) -> torch.Tensor:
        n, h, w, _ = x.shape
        p = self.patch_size
        tokens = self.proj(x.permute(0, 3, 1, 2), lora).flatten(2).transpose(1, 2)
        hp, wp = h // p, w // p
        if hp > self.max_size or wp > self.max_size:
            raise ValueError(f"a {hp}x{wp} patch grid exceeds the {self.max_size}-wide "
                             "position table")
        top, left = (self.max_size - hp) // 2, (self.max_size - wp) // 2
        pos = self.pos_embed[:, top:top + hp, left:left + wp].reshape(1, hp * wp, -1)
        return tokens + pos.to(tokens.dtype)
