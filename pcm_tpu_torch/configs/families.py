"""Model-family bundle constructors (counterpart of `pcm_tpu/configs/families.py`;
SD1.5 only so far)."""

from __future__ import annotations

import torch

from ..lora.layers import LoRASpec
from ..models.clip import CLIP_L_CONFIG, CLIPTextConfig
from ..models.unet import SD15_CONFIG, TINY_UNET_CONFIG
from ..models.vae import SD15_VAE_CONFIG, TINY_VAE_CONFIG
from ..train.bundles import SD15Bundle, SD_UNET_LORA_TARGETS

# tiny text tower for `tiny=True` (CPU smoke mode): CLIP-width vocab, width
# matched to TINY_UNET_CONFIG.cross_attention_dim
_TINY_CLIP_SD15 = CLIPTextConfig(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64)


def sd15_bundle(lora_rank: int = 64, dtype: torch.dtype = torch.bfloat16,
                tiny: bool = False) -> SD15Bundle:
    return SD15Bundle(
        unet_cfg=TINY_UNET_CONFIG if tiny else SD15_CONFIG,
        vae_cfg=TINY_VAE_CONFIG if tiny else SD15_VAE_CONFIG,
        text_cfg=_TINY_CLIP_SD15 if tiny else CLIP_L_CONFIG,
        lora=LoRASpec(rank=lora_rank, alpha=8.0, targets=SD_UNET_LORA_TARGETS),
        dtype=dtype,
    )
