"""T5 encoder, SD3's third text tower (counterpart of `pcm_tpu/models/t5.py`).

T5 v1.1 as ``transformers.T5EncoderModel`` names it (google/t5-v1_1-xxl is
SD3's ``text_encoder_3``): gated tanh-GELU feed-forward, no biases, RMSNorm,
and unscaled self-attention with one relative position bias shared by every
layer (block 0's table). The attention is plain matmuls with fp32 logits and
softmax and no padding mask, as the JAX package computes it outside any
kernel. Its linear layers dequantize an int8 weight at each use
(`DequantLinear`), as CLIP's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.quant import DequantLinear


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6


T5_XXL_CONFIG = T5Config()
TINY_T5_CONFIG = T5Config(vocab_size=1000, d_model=64, d_kv=16, d_ff=128, num_layers=2,
                          num_heads=4)


class RMSNorm(nn.Module):
    """x / rms(x) in fp32, cast back to x's dtype, times ``weight``."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        y = (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + self.eps)).to(x.dtype)
        return y * self.weight.to(x.dtype)


def relative_position_bucket(relative_position: torch.Tensor, num_buckets: int = 32,
                             max_distance: int = 128) -> torch.Tensor:
    """T5's bidirectional buckets of ``memory_pos - query_pos`` (int32), the
    log-spaced part in fp32 as the JAX function computes it."""
    num_buckets //= 2
    ret = (relative_position > 0).to(torch.int32) * num_buckets
    n = relative_position.abs()
    max_exact = num_buckets // 2
    large = torch.log(n.float() / max_exact + 1e-6) / math.log(max_distance / max_exact)
    large = max_exact + (large * (num_buckets - max_exact)).to(torch.int32)
    large = torch.clamp(large, max=num_buckets - 1)
    return ret + torch.where(n < max_exact, n.to(torch.int32), large)


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool):
        super().__init__()
        inner = cfg.num_heads * cfg.d_kv
        self.heads, self.d_kv = cfg.num_heads, cfg.d_kv
        self.q = DequantLinear(cfg.d_model, inner, bias=False)
        self.k = DequantLinear(cfg.d_model, inner, bias=False)
        self.v = DequantLinear(cfg.d_model, inner, bias=False)
        self.o = DequantLinear(inner, cfg.d_model, bias=False)
        if has_bias:
            self.relative_attention_bias = nn.Embedding(cfg.relative_attention_num_buckets,
                                                        cfg.num_heads)

    def forward(self, x: torch.Tensor, position_bias: torch.Tensor) -> torch.Tensor:
        b, s, _ = x.shape

        def heads(t):
            return t.view(b, s, self.heads, self.d_kv).transpose(1, 2)

        q, k, v = heads(self.q(x)), heads(self.k(x)), heads(self.v(x))
        logits = torch.matmul(q, k.transpose(-1, -2)).float() + position_bias
        p = torch.softmax(logits, dim=-1).to(x.dtype)
        o = torch.matmul(p, v).transpose(1, 2).reshape(b, s, self.heads * self.d_kv)
        return self.o(o)


class _SelfAttentionLayer(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool):
        super().__init__()
        self.SelfAttention = T5Attention(cfg, has_bias)
        self.layer_norm = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)


class _GatedGELU(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.wi_0 = DequantLinear(cfg.d_model, cfg.d_ff, bias=False)
        self.wi_1 = DequantLinear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = DequantLinear(cfg.d_ff, cfg.d_model, bias=False)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.wo(F.gelu(self.wi_0(h), approximate="tanh") * self.wi_1(h))


class _FFLayer(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.DenseReluDense = _GatedGELU(cfg)
        self.layer_norm = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)


class T5Block(nn.Module):
    """Pre-norm self-attention, then the pre-norm gated feed-forward."""

    def __init__(self, cfg: T5Config, has_bias: bool = False):
        super().__init__()
        self.layer = nn.ModuleList([_SelfAttentionLayer(cfg, has_bias), _FFLayer(cfg)])

    def forward(self, x: torch.Tensor, position_bias: torch.Tensor) -> torch.Tensor:
        attn, ff = self.layer
        x = x + attn.SelfAttention(attn.layer_norm(x), position_bias)
        return x + ff.DenseReluDense(ff.layer_norm(x))


class _Stack(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.block = nn.ModuleList(T5Block(cfg, has_bias=(i == 0)) for i in range(cfg.num_layers))
        self.final_layer_norm = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)


class T5Encoder(nn.Module):
    """``forward(input_ids)`` -> the final-RMSNorm hidden states (N, S, d_model)."""

    def __init__(self, cfg: T5Config = T5_XXL_CONFIG):
        super().__init__()
        self.cfg = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.encoder = _Stack(cfg)

    def fsdp_units(self) -> List[nn.Module]:
        """The modules that gather their own sharded weights (`parallel/fsdp.py`):
        the blocks."""
        return list(self.encoder.block)

    def fsdp_top(self) -> List[nn.Module]:
        """Modules inside a unit whose weights `position_bias` reads: they
        are gathered with the top level."""
        return [self.encoder.block[0].layer[0].SelfAttention.relative_attention_bias]

    def position_bias(self, s: int, device: torch.device) -> torch.Tensor:
        """(1, heads, s, s) fp32: the shared table at each pair's bucket."""
        cfg = self.cfg
        pos = torch.arange(s, device=device)
        buckets = relative_position_bucket(pos[None, :] - pos[:, None],
                                           cfg.relative_attention_num_buckets,
                                           cfg.relative_attention_max_distance)
        table = self.encoder.block[0].layer[0].SelfAttention.relative_attention_bias.weight
        return table[buckets.long()].permute(2, 0, 1)[None].float()

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        dtype = self.encoder.final_layer_norm.weight.dtype
        x = self.shared(input_ids).to(dtype)
        bias = self.position_bias(input_ids.shape[1], input_ids.device)
        for block in self.encoder.block:
            x = block(x, bias)
        return self.encoder.final_layer_norm(x)
