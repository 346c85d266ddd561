"""AutoencoderKL decode path for SD1.5 (counterpart of `pcm_tpu/models/vae.py`).

``post_quant_conv`` and the ``Decoder``, diffusers names. The encoder comes
with the training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import flash_attention
from .normalization import GroupNorm


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_groups: int = 32
    use_quant_conv: bool = True
    scaling_factor: float = 0.18215
    shift_factor: float = 0.0


SD15_VAE_CONFIG = VAEConfig()
TINY_VAE_CONFIG = VAEConfig(block_out_channels=(32, 64), layers_per_block=1)


class VAEResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, norm_groups: int = 32):
        super().__init__()
        self.norm1 = GroupNorm(norm_groups, in_channels, 1e-6, act="silu")
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = GroupNorm(norm_groups, out_channels, 1e-6, act="silu")
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv2(self.norm2(self.conv1(self.norm1(x))))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class VAEAttention(nn.Module):
    """Single-head self-attention over spatial positions (head_dim = channels)."""

    def __init__(self, channels: int, norm_groups: int = 32):
        super().__init__()
        self.group_norm = GroupNorm(norm_groups, channels, 1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        y = self.group_norm(x).permute(0, 2, 3, 1).reshape(n, h * w, c)
        q = self.to_q(y)[:, :, None, :]
        k = self.to_k(y)[:, :, None, :]
        v = self.to_v(y)[:, :, None, :]
        o = self.to_out[0](flash_attention(q, k, v)[:, :, 0, :])
        return x + o.reshape(n, h, w, c).permute(0, 3, 1, 2)


class _MidBlock(nn.Module):
    def __init__(self, ch: int, g: int):
        super().__init__()
        self.resnets = nn.ModuleList([VAEResnetBlock(ch, ch, g), VAEResnetBlock(ch, ch, g)])
        self.attentions = nn.ModuleList([VAEAttention(ch, g)])


class _Upsampler(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, padding=1)


class _UpBlock(nn.Module):
    def __init__(self, resnets, upsample_ch):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if upsample_ch:
            self.upsamplers = nn.ModuleList([_Upsampler(upsample_ch)])


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chans, g = cfg.block_out_channels, cfg.norm_groups
        h_ch = chans[-1]
        self.conv_in = nn.Conv2d(cfg.latent_channels, h_ch, 3, padding=1)
        self.mid_block = _MidBlock(h_ch, g)
        self.up_blocks = nn.ModuleList()
        for level in reversed(range(len(chans))):
            ch = chans[level]
            resnets = []
            for _ in range(cfg.layers_per_block + 1):
                resnets.append(VAEResnetBlock(h_ch, ch, g))
                h_ch = ch
            self.up_blocks.append(_UpBlock(resnets, ch if level > 0 else 0))
        self.conv_norm_out = GroupNorm(g, chans[0], 1e-6, act="silu")
        self.conv_out = nn.Conv2d(chans[0], cfg.in_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(z)
        mid = self.mid_block
        h = mid.resnets[1](mid.attentions[0](mid.resnets[0](h)))
        for blk in self.up_blocks:
            for resnet in blk.resnets:
                h = resnet(h)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0].conv(F.interpolate(h, scale_factor=2.0, mode="nearest"))
        return self.conv_out(self.conv_norm_out(h))


class AutoencoderKL(nn.Module):
    """Decode half of the SD VAE: ``decode(z)`` maps normalized latents
    (N, C, h, w) to pixels in [-1, 1]."""

    def __init__(self, cfg: VAEConfig = SD15_VAE_CONFIG):
        super().__init__()
        self.cfg = cfg
        self.decoder = Decoder(cfg)
        if cfg.use_quant_conv:
            self.post_quant_conv = nn.Conv2d(cfg.latent_channels, cfg.latent_channels, 1)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        dtype = self.decoder.conv_in.weight.dtype
        z = z / self.cfg.scaling_factor + self.cfg.shift_factor
        z = z.to(dtype).contiguous(memory_format=torch.channels_last)
        if self.cfg.use_quant_conv:
            z = self.post_quant_conv(z)
        return self.decoder(z)
