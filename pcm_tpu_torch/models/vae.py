"""AutoencoderKL for SD1.5, SDXL and SD3 (counterpart of `pcm_tpu/models/vae.py`), diffusers
names: the ``Encoder`` and ``quant_conv`` (training from pixels), and
``post_quant_conv`` and the ``Decoder`` (serving). NCHW in channels-last
memory; GroupNorm (+SiLU) is K4 and the mid-block's single-head attention
K1 at d = 512.
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
SDXL_VAE_CONFIG = VAEConfig(scaling_factor=0.13025)  # the same module, its own scale
# SD3's: 16 latent channels, no quant convs, a shifted scaling (`pcm_tpu/models/vae.py:37`)
SD3_VAE_CONFIG = VAEConfig(latent_channels=16, use_quant_conv=False, scaling_factor=1.5305,
                           shift_factor=0.0609)
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


class _Downsampler(nn.Module):
    """Stride-2 3x3 conv on the input padded by one row and one column at the
    bottom and right (`pcm_tpu/models/vae.py:100-103`)."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class _DownBlock(nn.Module):
    def __init__(self, resnets, downsample_ch):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if downsample_ch:
            self.downsamplers = nn.ModuleList([_Downsampler(downsample_ch)])


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chans, g = cfg.block_out_channels, cfg.norm_groups
        self.conv_in = nn.Conv2d(cfg.in_channels, chans[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        h_ch = chans[0]
        for level, ch in enumerate(chans):
            resnets = []
            for _ in range(cfg.layers_per_block):
                resnets.append(VAEResnetBlock(h_ch, ch, g))
                h_ch = ch
            self.down_blocks.append(_DownBlock(resnets, ch if level < len(chans) - 1 else 0))
        self.mid_block = _MidBlock(h_ch, g)
        self.conv_norm_out = GroupNorm(g, h_ch, 1e-6, act="silu")
        self.conv_out = nn.Conv2d(h_ch, 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for blk in self.down_blocks:
            for resnet in blk.resnets:
                h = resnet(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h)
        mid = self.mid_block
        h = mid.resnets[1](mid.attentions[0](mid.resnets[0](h)))
        return self.conv_out(self.conv_norm_out(h))


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
    """The SD VAE: ``encode(x, noise)`` maps pixels (N, 3, H, W) in [-1, 1]
    to normalized latents (N, C, H/8, W/8), ``decode(z)`` maps them back."""

    # the encoder's parameters, drawn apart by `train/bundles.py:fill_fan_in`
    ENCODER_PREFIXES = ("encoder.", "quant_conv.")

    def __init__(self, cfg: VAEConfig = SD15_VAE_CONFIG):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        if cfg.use_quant_conv:
            self.quant_conv = nn.Conv2d(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1)
            self.post_quant_conv = nn.Conv2d(cfg.latent_channels, cfg.latent_channels, 1)

    def encode_moments(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Pixels (N, 3, H, W) in [-1, 1] -> (mean, logvar) of the latent
        posterior, logvar clipped to [-30, 20], in the weights' dtype."""
        dtype = self.encoder.conv_in.weight.dtype
        moments = self.encoder(x.to(dtype).contiguous(memory_format=torch.channels_last))
        if self.cfg.use_quant_conv:
            moments = self.quant_conv(moments)
        mean, logvar = moments.chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def encode(self, x: torch.Tensor, noise: torch.Tensor = None) -> torch.Tensor:
        """Normalized latents ``(mean + std * noise - shift) * scale`` (the
        posterior's mean without ``noise``), ``noise`` (N, C, h, w) drawn by
        the caller; in the weights' dtype, as the JAX module computes them."""
        mean, logvar = self.encode_moments(x)
        if noise is not None:
            mean = mean + torch.exp(0.5 * logvar) * noise.to(mean.dtype)
        return (mean - self.cfg.shift_factor) * self.cfg.scaling_factor

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        dtype = self.decoder.conv_in.weight.dtype
        z = z / self.cfg.scaling_factor + self.cfg.shift_factor
        z = z.to(dtype).contiguous(memory_format=torch.channels_last)
        if self.cfg.use_quant_conv:
            z = self.post_quant_conv(z)
        return self.decoder(z)
