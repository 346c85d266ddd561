"""Resnet and resampling blocks of the UNet (diffusers structure and names)."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..lora.layers import LoRA, LoRAConv, LoRALinear
from .normalization import GroupNorm


class ResnetBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, temb_channels: int,
                 norm_groups: int = 32, eps: float = 1e-5):
        super().__init__()
        self.norm1 = GroupNorm(norm_groups, in_channels, eps, act="silu")
        self.conv1 = LoRAConv(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = LoRALinear(temb_channels, out_channels)
        self.norm2 = GroupNorm(norm_groups, out_channels, eps, act="silu")
        self.conv2 = LoRAConv(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (LoRAConv(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor, temb: torch.Tensor, lora: LoRA = None) -> torch.Tensor:
        h = self.conv1(self.norm1(x), lora)
        h = h + self.time_emb_proj(F.silu(temb), lora)[:, :, None, None]
        h = self.conv2(self.norm2(h), lora)
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x, lora)
        return x + h


class Downsample2D(nn.Module):
    """3x3 stride-2 conv, symmetric padding 1 (diffusers ``downsample_padding=1``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = LoRAConv(channels, channels, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor, lora: LoRA = None) -> torch.Tensor:
        return self.conv(x, lora)


class Upsample2D(nn.Module):
    """Nearest-neighbour x2 upsample, then a 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = LoRAConv(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor, lora: LoRA = None) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"), lora)
