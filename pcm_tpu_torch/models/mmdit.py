"""MMDiT, SD3's ``SD3Transformer2DModel`` (counterpart of `pcm_tpu/models/mmdit.py`).

A dual-stream joint transformer: image tokens (patchified latents) and
context tokens (the CLIP + T5 projections) attend jointly, each stream
modulated by AdaLayerNormZero from the timestep + pooled-text embedding.
Joint attention runs through the flash attention kernels (K1 forward, K2/K3
backward) on the concatenated ``(N, s_img + s_ctx, heads, head_dim)`` q/k/v.
The feed-forwards are tanh-GELU MLPs of plain linears (no GEGLU).

Module and parameter names follow the JAX package's tree, so its parameters
and LoRA factors map by rule (`models/convert.py`) and kohya files name the
same layers in both packages (``transformer_blocks.0.to_out.0``,
``transformer_blocks.0.ff.net.0.proj``, ``pos_embed.proj``). Latents are NHWC
in and out. ``remat=True`` checkpoints every joint block while grad is
enabled, as the UNet does its blocks.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from ..lora.layers import LoRA, LoRALinear
from ..ops import flash_attention
from .embeddings import (PatchEmbed, PixArtAlphaTextProjection, TimestepEmbedding,
                         sinusoidal_embedding)
from .unet import _remat_contexts


@dataclasses.dataclass(frozen=True)
class MMDiTConfig:
    in_channels: int = 16
    out_channels: int = 16
    patch_size: int = 2
    num_layers: int = 24
    num_heads: int = 24
    head_dim: int = 64
    joint_attention_dim: int = 4096  # context (T5-padded) width
    pooled_projection_dim: int = 2048
    pos_embed_max_size: int = 192
    qk_norm: Optional[str] = None  # "rms" for SD3.5-style blocks

    @property
    def inner_dim(self) -> int:
        return self.num_heads * self.head_dim

    def tap_channels(self) -> Dict[str, int]:
        """The channels of each feature tap of `MMDiT.features`: the image
        stream after every joint block."""
        return {f"block_{i}": self.inner_dim for i in range(self.num_layers)}


SD3_MEDIUM_CONFIG = MMDiTConfig()
TINY_MMDIT_CONFIG = MMDiTConfig(in_channels=4, out_channels=4, num_layers=2, num_heads=2,
                                head_dim=16, joint_attention_dim=32, pooled_projection_dim=32,
                                pos_embed_max_size=32)


def _layer_norm(x: torch.Tensor) -> torch.Tensor:
    """LayerNorm without scale or bias, eps 1e-6; statistics in fp32 (as
    flax's on bf16), output in x's dtype."""
    return F.layer_norm(x, (x.shape[-1],), eps=1e-6)


def _modulate(h: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return h * (1.0 + scale[:, None]) + shift[:, None]


class AdaLayerNormZero(nn.Module):
    """SiLU(temb) -> Linear(6 dim) split into shift, scale, gate of the
    attention and of the MLP; returns the modulated LN and the other four."""

    def __init__(self, dim: int):
        super().__init__()
        self.linear = LoRALinear(dim, 6 * dim)

    def forward(self, x: torch.Tensor, temb: torch.Tensor, lora: LoRA = None):
        emb = self.linear(F.silu(temb), lora)
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = emb.chunk(6, dim=-1)
        return _modulate(_layer_norm(x), shift_msa, scale_msa), gate_msa, shift_mlp, scale_mlp, \
            gate_mlp


class AdaLayerNormContinuous(nn.Module):
    """SiLU(temb) -> Linear(2 dim) split into **scale, shift**; the modulated LN."""

    def __init__(self, dim: int):
        super().__init__()
        self.linear = LoRALinear(dim, 2 * dim)

    def forward(self, x: torch.Tensor, temb: torch.Tensor, lora: LoRA = None) -> torch.Tensor:
        scale, shift = self.linear(F.silu(temb), lora).chunk(2, dim=-1)
        return _modulate(_layer_norm(x), shift, scale)


class _Proj(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = LoRALinear(dim, inner)


class GELUMLP(nn.Module):
    """dim -> 4 dim (tanh GELU) -> dim: ``net.0.proj``, ``net.2`` (diffusers'
    FeedForward("gelu-approximate"))."""

    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.ModuleList([_Proj(dim, 4 * dim), nn.Identity(), LoRALinear(4 * dim, dim)])

    def forward(self, x: torch.Tensor, lora: LoRA = None) -> torch.Tensor:
        h = F.gelu(self.net[0].proj(x, lora), approximate="tanh")
        return self.net[2](h, lora)


def _rms(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x / rms(x) over the head dim in fp32, cast back, times ``w``."""
    xf = x.float()
    return (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + 1e-6)).to(x.dtype) * w.to(x.dtype)


class JointTransformerBlock(nn.Module):
    """One joint block. The last one is ``context_pre_only``: its context
    takes AdaLayerNormContinuous, and it has no ``to_add_out`` and no
    ``ff_context`` and returns no context."""

    def __init__(self, cfg: MMDiTConfig, context_pre_only: bool = False):
        super().__init__()
        dim = cfg.inner_dim
        self.heads, self.head_dim = cfg.num_heads, cfg.head_dim
        self.context_pre_only = context_pre_only
        self.norm1 = AdaLayerNormZero(dim)
        self.norm1_context = (AdaLayerNormContinuous(dim) if context_pre_only
                              else AdaLayerNormZero(dim))
        for name in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj"):
            setattr(self, name, LoRALinear(dim, dim))
        if cfg.qk_norm == "rms":
            self.norm_q_weight = nn.Parameter(torch.ones(cfg.head_dim))
            self.norm_k_weight = nn.Parameter(torch.ones(cfg.head_dim))
        elif cfg.qk_norm is not None:
            raise ValueError(f"qk_norm {cfg.qk_norm!r} (None or 'rms')")
        self.to_out = nn.ModuleList([LoRALinear(dim, dim)])
        self.ff = GELUMLP(dim)
        if not context_pre_only:
            self.to_add_out = LoRALinear(dim, dim)
            self.ff_context = GELUMLP(dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor, temb: torch.Tensor,
                lora: LoRA = None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        hx, gate_msa, shift_mlp, scale_mlp, gate_mlp = self.norm1(x, temb, lora)
        if self.context_pre_only:
            hc = self.norm1_context(context, temb, lora)
        else:
            hc, c_gate_msa, c_shift_mlp, c_scale_mlp, c_gate_mlp = self.norm1_context(
                context, temb, lora)
        b, sx, dim = hx.shape
        s = sx + hc.shape[1]

        def joint(img, ctx):
            return torch.cat([img(hx, lora), ctx(hc, lora)], dim=1).view(b, s, self.heads,
                                                                         self.head_dim)

        q = joint(self.to_q, self.add_q_proj)
        k = joint(self.to_k, self.add_k_proj)
        v = joint(self.to_v, self.add_v_proj)
        if hasattr(self, "norm_q_weight"):
            q, k = _rms(q, self.norm_q_weight), _rms(k, self.norm_k_weight)
        o = flash_attention(q, k, v).reshape(b, s, dim)
        ox, oc = o[:, :sx], o[:, sx:]

        x = x + gate_msa[:, None] * self.to_out[0](ox, lora)
        x = x + gate_mlp[:, None] * self.ff(_modulate(_layer_norm(x), shift_mlp, scale_mlp), lora)
        if self.context_pre_only:
            return x, None
        context = context + c_gate_msa[:, None] * self.to_add_out(oc, lora)
        h = _modulate(_layer_norm(context), c_shift_mlp, c_scale_mlp)
        return x, context + c_gate_mlp[:, None] * self.ff_context(h, lora)


class MMDiT(nn.Module):
    def __init__(self, cfg: MMDiTConfig = SD3_MEDIUM_CONFIG, remat: bool = False):
        super().__init__()
        self.cfg = cfg
        self.remat = remat
        dim = cfg.inner_dim
        self.pos_embed = PatchEmbed(cfg.patch_size, cfg.in_channels, dim, cfg.pos_embed_max_size)
        self.timestep_embedder = TimestepEmbedding(256, dim)
        self.text_embedder = PixArtAlphaTextProjection(cfg.pooled_projection_dim, dim)
        self.context_embedder = LoRALinear(cfg.joint_attention_dim, dim)
        self.transformer_blocks = nn.ModuleList(
            JointTransformerBlock(cfg, context_pre_only=(i == cfg.num_layers - 1))
            for i in range(cfg.num_layers))
        self.norm_out = AdaLayerNormContinuous(dim)
        self.proj_out = LoRALinear(dim, cfg.patch_size ** 2 * cfg.out_channels)

    def _block(self, block: nn.Module, x, context, temb, lora):
        if self.remat and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(block, x, context, temb, lora,
                                                     use_reentrant=False,
                                                     context_fn=_remat_contexts)
        return block(x, context, temb, lora)

    def _streams(self, sample, timesteps, encoder_hidden_states, pooled_projections, lora,
                 taps: Optional[Dict[str, torch.Tensor]] = None):
        """The image stream after the last joint block and ``temb``; with
        ``taps`` each block's image stream is put there as ``block_{i}``."""
        dtype = self.pos_embed.pos_embed.dtype  # never quantized
        x = self.pos_embed(sample.to(dtype), lora)
        temb = self.timestep_embedder(sinusoidal_embedding(timesteps, 256).to(dtype), lora)
        temb = temb + self.text_embedder(pooled_projections.to(dtype), lora)
        context = self.context_embedder(encoder_hidden_states.to(dtype), lora)
        for i, block in enumerate(self.transformer_blocks):
            x, context = self._block(block, x, context, temb, lora)
            if taps is not None:
                taps[f"block_{i}"] = x
        return x, temb

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor, pooled_projections: torch.Tensor,
                lora: LoRA = None) -> torch.Tensor:
        """sample (N, H, W, C) latents, timesteps (N,) in [0, 1000],
        encoder_hidden_states (N, S, joint_attention_dim), pooled_projections
        (N, pooled_projection_dim); returns the velocity (N, H, W, C)."""
        cfg = self.cfg
        n, h, w, _ = sample.shape
        p = cfg.patch_size
        x, temb = self._streams(sample, timesteps, encoder_hidden_states, pooled_projections,
                                lora)
        x = self.proj_out(self.norm_out(x, temb), lora)
        x = x.view(n, h // p, w // p, p, p, cfg.out_channels).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(n, h, w, cfg.out_channels)

    def features(self, sample: torch.Tensor, timesteps: torch.Tensor,
                 encoder_hidden_states: torch.Tensor, pooled_projections: torch.Tensor,
                 lora: LoRA = None) -> Dict[str, torch.Tensor]:
        """The feature taps of a forward (arguments as `forward`): the image
        stream (N, S, inner_dim) after each joint block, ``block_{i}``, as the
        JAX model sows them (`pcm_tpu/models/mmdit.py:218-226`). It stops
        after the last block: ``norm_out`` and ``proj_out`` feed no tap."""
        taps: Dict[str, torch.Tensor] = {}
        self._streams(sample, timesteps, encoder_hidden_states, pooled_projections, lora, taps)
        return taps


# LoRA target lists of the reference SD3 trainers (`pcm_tpu/models/mmdit.py:252-283`):
# the base list (attention q/k/v/out, the image-stream FF, the final
# ``proj_out``); the adversarial list adds the context stream, the AdaLN and
# embedder linears and ``pos_embed.proj``; the stochastic-adversarial list is
# the adversarial one without ``pos_embed.proj``.
SD3_LORA_TARGETS = (
    "to_q", "to_k", "to_v", "to_out_0", "ff/net_0_proj", "ff/net_2", "proj_out",
)
SD3_ADV_STOCHASTIC_LORA_TARGETS = SD3_LORA_TARGETS + (
    "add_q_proj", "add_k_proj", "add_v_proj", "to_add_out",
    "ff_context/net_0_proj", "ff_context/net_2",
    "norm1/linear", "norm1_context/linear", "context_embedder",
    "text_embedder/linear_1", "text_embedder/linear_2",
    "timestep_embedder/linear_1", "timestep_embedder/linear_2",
)
SD3_ADV_LORA_TARGETS = SD3_ADV_STOCHASTIC_LORA_TARGETS + ("pos_embed/proj",)
