"""Transformer blocks of the UNet (diffusers structure and names).

Counterpart of `pcm_tpu/models/attention.py`: attention runs through the
flash attention kernel, and the feed-forward in-projection runs through the
fused GEGLU kernel whenever it carries no LoRA (the teacher, on a
dequantized weight when it is int8); with LoRA it takes the split form
``a · gelu(gate)`` so the adapter applies (the student). ``proj_in`` /
``proj_out`` are 1x1 convs (SD1.5) or linear (``use_linear_projection``,
SDXL).
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..lora.layers import LoRA, LoRAConv, LoRALinear
from ..ops import flash_attention, geglu
from .normalization import GroupNorm


class Attention(nn.Module):
    """Multi-head self- or cross-attention."""

    def __init__(self, query_dim: int, heads: int, head_dim: int,
                 cross_attention_dim: Optional[int] = None):
        super().__init__()
        inner = heads * head_dim
        ctx_dim = cross_attention_dim or query_dim
        self.heads, self.head_dim = heads, head_dim
        self.to_q = LoRALinear(query_dim, inner, bias=False)
        self.to_k = LoRALinear(ctx_dim, inner, bias=False)
        self.to_v = LoRALinear(ctx_dim, inner, bias=False)
        self.to_out = nn.ModuleList([LoRALinear(inner, query_dim)])

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                lora: LoRA = None) -> torch.Tensor:
        ctx = x if context is None else context
        b, sq, _ = x.shape
        sk = ctx.shape[1]
        q = self.to_q(x, lora).view(b, sq, self.heads, self.head_dim)
        k = self.to_k(ctx, lora).view(b, sk, self.heads, self.head_dim)
        v = self.to_v(ctx, lora).view(b, sk, self.heads, self.head_dim)
        o = flash_attention(q, k, v).reshape(b, sq, self.heads * self.head_dim)
        return self.to_out[0](o, lora)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = LoRALinear(dim, inner * 2)


class FeedForward(nn.Module):
    """GEGLU feed-forward dim -> mult·dim -> dim (``net.0.proj``, ``net.2``)."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(),
                                  LoRALinear(dim * mult, dim)])

    def forward(self, x: torch.Tensor, lora: LoRA = None) -> torch.Tensor:
        proj = self.net[0].proj
        if lora is not None and proj.lora_key is not None:
            a, gate = proj(x, lora).chunk(2, dim=-1)
            h = a * F.gelu(gate)
        else:
            h = geglu(x, proj.dense_weight(x.dtype), proj.bias)
        return self.net[2](h, lora)


class BasicTransformerBlock(nn.Module):
    """LayerNorm -> self-attn -> LayerNorm -> cross-attn -> LayerNorm -> FF."""

    def __init__(self, dim: int, heads: int, head_dim: int, cross_attention_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, heads, head_dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(dim, heads, head_dim, cross_attention_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor, lora: LoRA = None) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x), lora=lora)
        x = x + self.attn2(self.norm2(x), context, lora)
        return x + self.ff(self.norm3(x), lora)


class Transformer2D(nn.Module):
    """Spatial transformer: GroupNorm, ``proj_in`` (1x1 conv, or linear with
    ``use_linear_projection``), ``depth`` blocks, ``proj_out``, residual.
    NCHW in and out. ``run(block, *args)`` calls each block (the UNet's
    remat region a block at ``block`` granularity)."""

    def __init__(self, channels: int, heads: int, head_dim: int, depth: int,
                 cross_attention_dim: int, norm_groups: int = 32,
                 use_linear_projection: bool = False):
        super().__init__()
        inner = heads * head_dim
        self.linear = use_linear_projection
        proj = LoRALinear if use_linear_projection else functools.partial(LoRAConv, kernel_size=1)
        self.norm = GroupNorm(norm_groups, channels, eps=1e-6)
        self.proj_in = proj(channels, inner)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(inner, heads, head_dim, cross_attention_dim)
            for _ in range(depth))
        self.proj_out = proj(inner, channels)

    def forward(self, x: torch.Tensor, context: torch.Tensor, lora: LoRA = None,
                run: Callable = None) -> torch.Tensor:
        n, c, h, w = x.shape
        hidden = self.norm(x)
        if self.linear:
            # channels-last memory makes these (n, h*w, c) views free
            hidden = self.proj_in(hidden.permute(0, 2, 3, 1).reshape(n, h * w, c), lora)
        else:
            hidden = self.proj_in(hidden, lora)
            hidden = hidden.permute(0, 2, 3, 1).reshape(n, h * w, hidden.shape[1])
        for block in self.transformer_blocks:
            hidden = run(block, hidden, context, lora) if run else block(hidden, context, lora)
        if self.linear:
            hidden = self.proj_out(hidden, lora).reshape(n, h, w, c).permute(0, 3, 1, 2)
        else:
            hidden = self.proj_out(hidden.reshape(n, h, w, -1).permute(0, 3, 1, 2), lora)
        return hidden + x
