"""SD3's MMDiT (diffusers ``SD3Transformer2DModel``) in plain PyTorch:
joint attention of the image and context streams through `layers.attention`,
AdaLayerNormZero modulation, tanh-GELU MLPs, no checkpointing. NHWC
latents in and out, as the program takes them."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv2d, Linear, LoRA, TimestepEmbedding, attention, sinusoidal_embedding


def _layer_norm(x):
    return F.layer_norm(x, (x.shape[-1],), eps=1e-6)


def _modulate(h, shift, scale):
    return h * (1.0 + scale[:, None]) + shift[:, None]


class AdaLayerNormZero(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.linear = Linear(dim, 6 * dim)

    def forward(self, x, temb, lora: LoRA = None):
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = self.linear(
            F.silu(temb), lora).chunk(6, dim=-1)
        return _modulate(_layer_norm(x), shift_msa, scale_msa), gate_msa, shift_mlp, \
            scale_mlp, gate_mlp


class AdaLayerNormContinuous(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.linear = Linear(dim, 2 * dim)

    def forward(self, x, temb, lora: LoRA = None):
        scale, shift = self.linear(F.silu(temb), lora).chunk(2, dim=-1)
        return _modulate(_layer_norm(x), shift, scale)


class _Proj(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = Linear(dim, inner)


class GELUMLP(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.ModuleList([_Proj(dim, 4 * dim), nn.Identity(), Linear(4 * dim, dim)])

    def forward(self, x, lora: LoRA = None):
        return self.net[2](F.gelu(self.net[0].proj(x, lora), approximate="tanh"), lora)


class JointTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, head_dim: int, context_pre_only: bool):
        super().__init__()
        self.heads, self.head_dim = heads, head_dim
        self.context_pre_only = context_pre_only
        self.norm1 = AdaLayerNormZero(dim)
        self.norm1_context = (AdaLayerNormContinuous(dim) if context_pre_only
                              else AdaLayerNormZero(dim))
        for name in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj"):
            setattr(self, name, Linear(dim, dim))
        self.to_out = nn.ModuleList([Linear(dim, dim)])
        self.ff = GELUMLP(dim)
        if not context_pre_only:
            self.to_add_out = Linear(dim, dim)
            self.ff_context = GELUMLP(dim)

    def forward(self, x, context, temb, lora: LoRA = None):
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

        o = attention(joint(self.to_q, self.add_q_proj), joint(self.to_k, self.add_k_proj),
                      joint(self.to_v, self.add_v_proj)).reshape(b, s, dim)
        ox, oc = o[:, :sx], o[:, sx:]
        x = x + gate_msa[:, None] * self.to_out[0](ox, lora)
        x = x + gate_mlp[:, None] * self.ff(_modulate(_layer_norm(x), shift_mlp, scale_mlp), lora)
        if self.context_pre_only:
            return x, None
        context = context + c_gate_msa[:, None] * self.to_add_out(oc, lora)
        h = _modulate(_layer_norm(context), c_shift_mlp, c_scale_mlp)
        return x, context + c_gate_mlp[:, None] * self.ff_context(h, lora)


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, in_channels: int, dim: int, max_size: int):
        super().__init__()
        self.patch_size, self.max_size = patch_size, max_size
        self.proj = Conv2d(in_channels, dim, patch_size, stride=patch_size)
        self.pos_embed = nn.Parameter(torch.zeros(1, max_size, max_size, dim))

    def forward(self, x, lora: LoRA = None):
        n, h, w, _ = x.shape
        p = self.patch_size
        tokens = self.proj(x.permute(0, 3, 1, 2), lora).flatten(2).transpose(1, 2)
        hp, wp = h // p, w // p
        top, left = (self.max_size - hp) // 2, (self.max_size - wp) // 2
        pos = self.pos_embed[:, top:top + hp, left:left + wp].reshape(1, hp * wp, -1)
        return tokens + pos.to(tokens.dtype)


class MMDiT(nn.Module):
    """``cfg``: the configuration file's ``mmdit`` group (in/out_channels,
    patch_size, num_layers, num_heads, head_dim, joint_attention_dim,
    pooled_projection_dim, pos_embed_max_size)."""

    def __init__(self, cfg: Dict):
        super().__init__()
        self.cfg = cfg
        dim = cfg["num_heads"] * cfg["head_dim"]
        self.pos_embed = PatchEmbed(cfg["patch_size"], cfg["in_channels"], dim,
                                    cfg["pos_embed_max_size"])
        self.timestep_embedder = TimestepEmbedding(256, dim)
        self.text_embedder = TimestepEmbedding(cfg["pooled_projection_dim"], dim)
        self.context_embedder = Linear(cfg["joint_attention_dim"], dim)
        self.transformer_blocks = nn.ModuleList(
            JointTransformerBlock(dim, cfg["num_heads"], cfg["head_dim"],
                                  context_pre_only=(i == cfg["num_layers"] - 1))
            for i in range(cfg["num_layers"]))
        self.norm_out = AdaLayerNormContinuous(dim)
        self.proj_out = Linear(dim, cfg["patch_size"] ** 2 * cfg["out_channels"])

    def forward(self, sample, timesteps, encoder_hidden_states, pooled_projections,
                lora: LoRA = None):
        cfg = self.cfg
        n, h, w, _ = sample.shape
        p = cfg["patch_size"]
        dtype = self.proj_out.weight.dtype
        x = self.pos_embed(sample.to(dtype), lora)
        temb = self.timestep_embedder(sinusoidal_embedding(timesteps, 256).to(dtype), lora)
        temb = temb + self.text_embedder(pooled_projections.to(dtype), lora)
        context = self.context_embedder(encoder_hidden_states.to(dtype), lora)
        for block in self.transformer_blocks:
            x, context = block(x, context, temb, lora)
        x = self.proj_out(self.norm_out(x, temb), lora)
        x = x.view(n, h // p, w // p, p, p, cfg["out_channels"]).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(n, h, w, cfg["out_channels"])

