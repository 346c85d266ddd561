"""Plain layers of the reference models: nn.Linear / nn.Conv2d with a LoRA
term, GroupNorm, attention and the timestep embeddings, in plain PyTorch.

Parameter names follow the diffusers layout that the program under test
uses, so the benchmark's seeded weights (`pcm_bench/weights.py`) land on the
same tensors on both sides. Nothing here calls a kernel of the program.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

LoRA = Optional[Dict[str, torch.Tensor]]

# counts attention products while set (`pcm_bench/flops.py`)
ATTENTION_TALLY: Optional[list] = None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q kᵀ / sqrt(d)) v over ``(b, s, h, d)`` tensors. On a CUDA
    device through PyTorch's scaled_dot_product_attention; elsewhere (the
    CPU tests, the meta device of the operation count) written out."""
    if ATTENTION_TALLY is not None:
        b, sq, h, d = q.shape
        ATTENTION_TALLY.append((b, sq, k.shape[1], h, d))
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    if q.device.type == "cuda":
        o = F.scaled_dot_product_attention(q, k, v)
    else:
        s = torch.matmul(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
        o = torch.matmul(torch.softmax(s, dim=-1), v)
    return o.transpose(1, 2)


class Linear(nn.Linear):
    """``x Wᵀ + b + s · (x Aᵀ) Bᵀ`` where the adapter holds this layer."""

    lora_key: Optional[str] = None
    lora_scale: float = 1.0

    def forward(self, x: torch.Tensor, lora: LoRA = None) -> torch.Tensor:
        y = F.linear(x, self.weight, self.bias)
        if lora is not None and self.lora_key is not None:
            a = lora[self.lora_key + ".lora_a"].to(x.dtype)
            b = lora[self.lora_key + ".lora_b"].to(x.dtype)
            y = y + self.lora_scale * F.linear(F.linear(x, a), b)
        return y


class Conv2d(nn.Conv2d):
    """``conv(x, W) + b + s · conv(conv(x, A), B)`` where the adapter holds
    this layer: A takes the layer's kernel, stride and padding, B is 1x1."""

    lora_key: Optional[str] = None
    lora_scale: float = 1.0

    def forward(self, x: torch.Tensor, lora: LoRA = None) -> torch.Tensor:
        y = self._conv_forward(x, self.weight, self.bias)
        if lora is not None and self.lora_key is not None:
            a = lora[self.lora_key + ".lora_a"].to(x.dtype)
            b = lora[self.lora_key + ".lora_b"].to(x.dtype)
            h = F.conv2d(x, a, stride=self.stride, padding=self.padding)
            y = y + self.lora_scale * F.conv2d(h, b)
        return y


def attach_lora(model: nn.Module, targets: Sequence[str], rank: int, alpha: float) -> None:
    """Mark every Linear / Conv2d whose dotted module path contains one of
    ``targets`` (dotted names: ``to_out.0``, ``ff.net.0.proj``)."""
    for path, m in model.named_modules():
        if isinstance(m, (Linear, Conv2d)):
            m.lora_key = path if any(t in path for t in targets) else None
            m.lora_scale = alpha / rank


def lora_shapes(model: nn.Module, rank: int) -> Dict[str, tuple]:
    """The factor shapes of every marked layer: A (r, in[, kh, kw]), B (out, r[, 1, 1])."""
    shapes = {}
    for m in model.modules():
        if isinstance(m, Linear) and m.lora_key is not None:
            shapes[m.lora_key + ".lora_a"] = (rank, m.in_features)
            shapes[m.lora_key + ".lora_b"] = (m.out_features, rank)
        elif isinstance(m, Conv2d) and m.lora_key is not None:
            shapes[m.lora_key + ".lora_a"] = (rank, m.in_channels, *m.kernel_size)
            shapes[m.lora_key + ".lora_b"] = (m.out_channels, rank, 1, 1)
    return shapes


class GroupNorm(nn.Module):
    """GroupNorm over NCHW input, statistics in fp32, with an optional SiLU."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-5,
                 act: Optional[str] = None):
        super().__init__()
        self.num_groups, self.eps, self.act = num_groups, eps, act
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.float(), self.num_groups, self.weight.float(), self.bias.float(),
                         self.eps).to(x.dtype)
        return F.silu(y) if self.act == "silu" else y


def sinusoidal_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """The diffusers timestep sinusoid (cos first, no frequency shift) in fp32."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device)
    args = t.float()[:, None] * torch.exp(exponent / half)[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    return F.pad(emb, (0, 1)) if dim % 2 else emb


class TimestepEmbedding(nn.Module):
    """linear -> SiLU -> linear."""

    def __init__(self, in_dim: int, embed_dim: int):
        super().__init__()
        self.linear_1 = Linear(in_dim, embed_dim)
        self.linear_2 = Linear(embed_dim, embed_dim)

    def forward(self, x: torch.Tensor, lora: LoRA = None) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(x, lora)), lora)
