"""CLIP text encoder (counterpart of `pcm_tpu/models/clip.py`), transformers names.

The causal self-attention over <= 77 tokens is a plain matmul, mask and
softmax: the JAX package leaves it to XLA, and it is no kernel here either.
Its linear layers are the JAX package's stock ``nn.Dense``: an int8 weight
is dequantized at each use (`DequantLinear`), never an int8 product.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.quant import DequantLinear


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_length: int = 77
    hidden_act: str = "quick_gelu"
    projection_dim: Optional[int] = None


CLIP_L_CONFIG = CLIPTextConfig()  # SD1.5; SDXL's first tower
# SDXL's second tower (OpenCLIP bigG as CLIPTextModelWithProjection):
# `pcm_tpu/models/clip.py:41`, exact-erf gelu, a bias-free 1280 projection
CLIP_BIG_G_CONFIG = CLIPTextConfig(hidden_size=1280, num_layers=32, num_heads=20,
                                   intermediate_size=5120, hidden_act="gelu",
                                   projection_dim=1280)


def _act(name: str):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    if name in ("gelu", "gelu_new"):
        return F.gelu
    raise ValueError(name)


class _SelfAttention(nn.Module):
    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj = DequantLinear(d, d), DequantLinear(d, d)
        self.v_proj, self.out_proj = DequantLinear(d, d), DequantLinear(d, d)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        hd = d // self.heads

        def heads(t):
            return t.view(b, s, self.heads, hd).transpose(1, 2)

        q, k, v = heads(self.q_proj(x)), heads(self.k_proj(x)), heads(self.v_proj(x))
        logits = torch.matmul(q, k.transpose(-1, -2)).float() / hd ** 0.5
        logits = logits.masked_fill(~mask, -1e9)
        p = torch.softmax(logits, dim=-1).to(x.dtype)
        o = torch.matmul(p, v).transpose(1, 2).reshape(b, s, d)
        return self.out_proj(o)


class _MLP(nn.Module):
    def __init__(self, d: int, inner: int, act: str):
        super().__init__()
        self.fc1, self.fc2 = DequantLinear(d, inner), DequantLinear(inner, d)
        self.act = _act(act)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        d = cfg.hidden_size
        self.self_attn = _SelfAttention(d, cfg.num_heads)
        self.layer_norm1 = nn.LayerNorm(d, eps=1e-5)
        self.mlp = _MLP(d, cfg.intermediate_size, cfg.hidden_act)
        self.layer_norm2 = nn.LayerNorm(d, eps=1e-5)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_length, cfg.hidden_size)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList(CLIPEncoderLayer(cfg) for _ in range(cfg.num_layers))


class _TextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=1e-5)


class CLIPTextModel(nn.Module):
    """``forward(input_ids)`` -> (hidden_states, last, pooled), as the JAX model:
    ``hidden_states[i]`` is layer i's input, ``last`` the final-LN output, and
    ``pooled`` the final-LN hidden at each row's argmax (end-of-text) token,
    projected when ``projection_dim`` is set."""

    def __init__(self, cfg: CLIPTextConfig = CLIP_L_CONFIG):
        super().__init__()
        self.cfg = cfg
        self.text_model = _TextTransformer(cfg)
        if cfg.projection_dim is not None:
            self.text_projection = DequantLinear(cfg.hidden_size, cfg.projection_dim, bias=False)

    def fsdp_units(self) -> List[nn.Module]:
        """The modules that gather their own sharded weights (`parallel/fsdp.py`):
        the encoder layers."""
        return list(self.text_model.encoder.layers)

    def forward(self, input_ids: torch.Tensor
                ) -> Tuple[List[torch.Tensor], torch.Tensor, torch.Tensor]:
        tm = self.text_model
        b, s = input_ids.shape
        x = tm.embeddings.token_embedding(input_ids) + tm.embeddings.position_embedding.weight[:s]
        mask = torch.ones((s, s), dtype=torch.bool, device=input_ids.device).tril()
        hidden_states = []
        for layer in tm.encoder.layers:
            hidden_states.append(x)
            x = layer(x, mask)
        hidden_states.append(x)
        last = tm.final_layer_norm(x)
        pooled = last[torch.arange(b, device=last.device), input_ids.argmax(dim=-1)]
        if self.cfg.projection_dim is not None:
            pooled = self.text_projection(pooled)
        return hidden_states, last, pooled
