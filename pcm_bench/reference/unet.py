"""The SD1.5 / SDXL UNet2DConditionModel in plain PyTorch (diffusers
structure and parameter names), NCHW, no checkpointing, no kernels:
GroupNorm through ``F.group_norm``, attention through `layers.attention`,
the GEGLU feed-forward as ``a * gelu(gate)`` with the exact GELU."""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv2d, GroupNorm, Linear, LoRA, TimestepEmbedding, attention, \
    sinusoidal_embedding


class Attention(nn.Module):
    def __init__(self, query_dim: int, heads: int, head_dim: int,
                 cross_attention_dim: Optional[int] = None):
        super().__init__()
        inner = heads * head_dim
        ctx_dim = cross_attention_dim or query_dim
        self.heads, self.head_dim = heads, head_dim
        self.to_q = Linear(query_dim, inner, bias=False)
        self.to_k = Linear(ctx_dim, inner, bias=False)
        self.to_v = Linear(ctx_dim, inner, bias=False)
        self.to_out = nn.ModuleList([Linear(inner, query_dim)])

    def forward(self, x, context=None, lora: LoRA = None):
        ctx = x if context is None else context
        b, sq, _ = x.shape
        sk = ctx.shape[1]
        q = self.to_q(x, lora).view(b, sq, self.heads, self.head_dim)
        k = self.to_k(ctx, lora).view(b, sk, self.heads, self.head_dim)
        v = self.to_v(ctx, lora).view(b, sk, self.heads, self.head_dim)
        o = attention(q, k, v).reshape(b, sq, self.heads * self.head_dim)
        return self.to_out[0](o, lora)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = Linear(dim, inner * 2)


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(), Linear(dim * mult, dim)])

    def forward(self, x, lora: LoRA = None):
        a, gate = self.net[0].proj(x, lora).chunk(2, dim=-1)
        return self.net[2](a * F.gelu(gate), lora)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, head_dim: int, cross_attention_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, heads, head_dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(dim, heads, head_dim, cross_attention_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x, context, lora: LoRA = None):
        x = x + self.attn1(self.norm1(x), lora=lora)
        x = x + self.attn2(self.norm2(x), context, lora)
        return x + self.ff(self.norm3(x), lora)


class Transformer2D(nn.Module):
    def __init__(self, channels: int, heads: int, head_dim: int, depth: int,
                 cross_attention_dim: int, norm_groups: int, use_linear_projection: bool):
        super().__init__()
        inner = heads * head_dim
        self.linear = use_linear_projection
        self.norm = GroupNorm(norm_groups, channels, eps=1e-6)
        if use_linear_projection:
            self.proj_in, self.proj_out = Linear(channels, inner), Linear(inner, channels)
        else:
            self.proj_in = Conv2d(channels, inner, kernel_size=1)
            self.proj_out = Conv2d(inner, channels, kernel_size=1)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(inner, heads, head_dim, cross_attention_dim)
            for _ in range(depth))

    def forward(self, x, context, lora: LoRA = None):
        n, c, h, w = x.shape
        hidden = self.norm(x)
        if self.linear:
            hidden = self.proj_in(hidden.permute(0, 2, 3, 1).reshape(n, h * w, c), lora)
        else:
            hidden = self.proj_in(hidden, lora)
            hidden = hidden.permute(0, 2, 3, 1).reshape(n, h * w, hidden.shape[1])
        for block in self.transformer_blocks:
            hidden = block(hidden, context, lora)
        if self.linear:
            hidden = self.proj_out(hidden, lora).reshape(n, h, w, c).permute(0, 3, 1, 2)
        else:
            hidden = self.proj_out(hidden.reshape(n, h, w, -1).permute(0, 3, 1, 2), lora)
        return hidden + x


class ResnetBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, temb_channels: int, groups: int):
        super().__init__()
        self.norm1 = GroupNorm(groups, in_channels, act="silu")
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = Linear(temb_channels, out_channels)
        self.norm2 = GroupNorm(groups, out_channels, act="silu")
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x, temb, lora: LoRA = None):
        h = self.conv1(self.norm1(x), lora)
        h = h + self.time_emb_proj(F.silu(temb), lora)[:, :, None, None]
        h = self.conv2(self.norm2(h), lora)
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x, lora)
        return x + h


class Downsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x, lora: LoRA = None):
        return self.conv(x, lora)


class Upsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x, lora: LoRA = None):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"), lora)


class _Block(nn.Module):
    def __init__(self):
        super().__init__()
        self.resnets = nn.ModuleList()
        self.attentions = nn.ModuleList()


class UNet2DCondition(nn.Module):
    """``cfg``: the configuration file's ``unet`` group (diffusers widths:
    block_out_channels, attn_blocks, num_heads, transformer_depth,
    layers_per_block, cross_attention_dim, use_linear_projection,
    norm_groups, in/out_channels, addition_embed_dim, addition_in_dim)."""

    def __init__(self, cfg: Dict):
        super().__init__()
        self.cfg = cfg
        chans = list(cfg["block_out_channels"])
        ch0, temb = chans[0], chans[0] * 4
        g = cfg["norm_groups"]

        def transformer(level: int, ch: int) -> Transformer2D:
            heads = cfg["num_heads"][level]
            return Transformer2D(ch, heads, ch // heads, cfg["transformer_depth"][level],
                                 cfg["cross_attention_dim"], g, cfg["use_linear_projection"])

        self.conv_in = Conv2d(cfg["in_channels"], ch0, 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch0, temb)
        if cfg.get("addition_in_dim"):
            self.add_embedding = TimestepEmbedding(cfg["addition_in_dim"], temb)
        skips, h_ch = [ch0], ch0
        self.down_blocks = nn.ModuleList()
        for level, ch in enumerate(chans):
            blk = _Block()
            for _ in range(cfg["layers_per_block"]):
                blk.resnets.append(ResnetBlock2D(h_ch, ch, temb, g))
                h_ch = ch
                if cfg["attn_blocks"][level]:
                    blk.attentions.append(transformer(level, ch))
                skips.append(ch)
            if level < len(chans) - 1:
                blk.downsamplers = nn.ModuleList([Downsample2D(ch)])
                skips.append(ch)
            self.down_blocks.append(blk)
        self.mid_block = _Block()
        self.mid_block.resnets.extend([ResnetBlock2D(h_ch, h_ch, temb, g),
                                       ResnetBlock2D(h_ch, h_ch, temb, g)])
        self.mid_block.attentions.append(transformer(len(chans) - 1, h_ch))
        self.up_blocks = nn.ModuleList()
        for level in reversed(range(len(chans))):
            ch = chans[level]
            blk = _Block()
            for _ in range(cfg["layers_per_block"] + 1):
                blk.resnets.append(ResnetBlock2D(h_ch + skips.pop(), ch, temb, g))
                h_ch = ch
                if cfg["attn_blocks"][level]:
                    blk.attentions.append(transformer(level, ch))
            if level > 0:
                blk.upsamplers = nn.ModuleList([Upsample2D(ch)])
            self.up_blocks.append(blk)
        self.conv_norm_out = GroupNorm(g, ch0, act="silu")
        self.conv_out = Conv2d(ch0, cfg["out_channels"], 3, padding=1)

    def forward(self, sample, timesteps, encoder_hidden_states, lora: LoRA = None,
                added_cond: Optional[Dict[str, torch.Tensor]] = None):
        """sample (N, C, H, W); SDXL: added_cond {"text_embeds", "time_ids"}."""
        cfg = self.cfg
        dtype = self.conv_in.weight.dtype
        temb = self.time_embedding(
            sinusoidal_embedding(timesteps, cfg["block_out_channels"][0]).to(dtype))
        if cfg.get("addition_in_dim"):
            time_ids = added_cond["time_ids"]
            aug = sinusoidal_embedding(time_ids.reshape(-1), cfg["addition_embed_dim"])
            aug = torch.cat([added_cond["text_embeds"].float(),
                             aug.reshape(time_ids.shape[0], -1)], dim=-1)
            temb = temb + self.add_embedding(aug.to(dtype))
        context = encoder_hidden_states.to(dtype)
        h = self.conv_in(sample.to(dtype), lora)
        skips = [h]
        for blk in self.down_blocks:
            for j, resnet in enumerate(blk.resnets):
                h = resnet(h, temb, lora)
                if len(blk.attentions):
                    h = blk.attentions[j](h, context, lora)
                skips.append(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h, lora)
                skips.append(h)
        mid = self.mid_block
        h = mid.resnets[0](h, temb, lora)
        h = mid.attentions[0](h, context, lora)
        h = mid.resnets[1](h, temb, lora)
        for blk in self.up_blocks:
            for j, resnet in enumerate(blk.resnets):
                h = resnet(torch.cat([h, skips.pop()], dim=1), temb, lora)
                if len(blk.attentions):
                    h = blk.attentions[j](h, context, lora)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h, lora)
        return self.conv_out(self.conv_norm_out(h), lora)
