"""Model-family bundle constructors, the training recipes and each family's
discriminator (counterpart of `pcm_tpu/configs/families.py`; bundles for
SD1.5 and, on cached embeddings, SDXL so far)."""

from __future__ import annotations

import dataclasses

import torch

from ..lora.layers import LoRASpec
from ..models.clip import CLIP_L_CONFIG, CLIPTextConfig
from ..models.unet import SD15_CONFIG, SDXL_CONFIG, TINY_SDXL_CONFIG, TINY_UNET_CONFIG
from ..models.vae import SD15_VAE_CONFIG, TINY_VAE_CONFIG
from ..train.adv import SD15_DISC_CONFIG, SDXL_DISC_CONFIG, DiscriminatorConfig
from ..train.bundles import SD15Bundle, SDXLBundle, SD_UNET_LORA_TARGETS
from ..train.distill import DistillConfig

# tiny text tower for `tiny=True` (CPU smoke mode): CLIP-width vocab, width
# matched to TINY_UNET_CONFIG.cross_attention_dim
_TINY_CLIP_SD15 = CLIPTextConfig(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64)


def sd15_bundle(lora_rank: int = 64, dtype: torch.dtype = torch.bfloat16,
                tiny: bool = False, remat: bool = False) -> SD15Bundle:
    return SD15Bundle(
        unet_cfg=TINY_UNET_CONFIG if tiny else SD15_CONFIG,
        vae_cfg=TINY_VAE_CONFIG if tiny else SD15_VAE_CONFIG,
        text_cfg=_TINY_CLIP_SD15 if tiny else CLIP_L_CONFIG,
        lora=LoRASpec(rank=lora_rank, alpha=8.0, targets=SD_UNET_LORA_TARGETS),
        dtype=dtype,
        remat=remat,
    )


def sdxl_bundle(lora_rank: int = 64, dtype: torch.dtype = torch.bfloat16,
                tiny: bool = False, remat: bool = False) -> SDXLBundle:
    """SDXL on cached latents and text embeddings (the bundle holds the UNet)."""
    return SDXLBundle(
        unet_cfg=TINY_SDXL_CONFIG if tiny else SDXL_CONFIG,
        lora=LoRASpec(rank=lora_rank, alpha=8.0, targets=SD_UNET_LORA_TARGETS),
        dtype=dtype,
        remat=remat,
    )


# Each family's discriminator (`pcm_tpu/train/adv.py:63-80`), and with ``tiny``
# the taps of the 2-level TINY UNets (`scripts/train.py:255-268`).
_DISC_CONFIGS = {
    ("sd15", False): SD15_DISC_CONFIG,
    ("sdxl", False): SDXL_DISC_CONFIG,
    ("sd15", True): DiscriminatorConfig(taps=("down_0", "down_1", "mid", "up_0", "up_1"),
                                        num_h_per_head=4, kernel=3),
    ("sdxl", True): DiscriminatorConfig(taps=("down_0", "down_1", "mid")),
}


def disc_config(family: str, tiny: bool = False) -> DiscriminatorConfig:
    return _DISC_CONFIGS[family, tiny]


# ---------------------------------------------------------------------------
# The reference recipes, field for field as `pcm_tpu/configs/families.py:125-192`
# (the port trains the sd15 recipes and sdxl_4phase_adv; SD3 is not ported).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Recipe:
    name: str
    family: str  # sd15 | sdxl | sd3
    resolution: int
    batch_per_chip: int
    max_steps: int
    lr: float
    distill: DistillConfig
    lora_rank: int
    adversarial: bool = False
    adv_lr: float = 1e-5
    adv_weight: float = 0.1
    proportion_empty_prompts: float = 0.0
    stochastic: bool = False  # SD3 stochastic-adv variant


RECIPES = {
    # train_pcm_lora_sd15.sh:5-29
    "sd15_4phase": Recipe(
        "sd15_4phase", "sd15", 512, 20, 5000, 5e-6,
        DistillConfig(num_solver_steps=50, multiphase=4, w_min=4, w_max=5),
        lora_rank=64,
    ),
    # train_pcm_lora_sd15.sh:41-67 (no CFG solver, 10% prompt dropout)
    "sd15_4phase_nocfg": Recipe(
        "sd15_4phase_nocfg", "sd15", 512, 20, 5000, 5e-6,
        DistillConfig(num_solver_steps=50, multiphase=4, not_apply_cfg_solver=True),
        lora_rank=64, proportion_empty_prompts=0.1,
    ),
    # train_pcm_lora_sd15.sh:78-104 (2-phase adversarial)
    "sd15_2phase_adv": Recipe(
        "sd15_2phase_adv", "sd15", 512, 20, 10000, 5e-6,
        DistillConfig(num_solver_steps=50, multiphase=2, w_min=4, w_max=5),
        lora_rank=64, adversarial=True,
    ),
    # train_pcm_lora_sdxl.sh:9-37
    "sdxl_4phase_adv": Recipe(
        "sdxl_4phase_adv", "sdxl", 1024, 10, 20000, 2e-6,
        DistillConfig(num_solver_steps=40, multiphase=4, w_min=6, w_max=7),
        lora_rank=64, adversarial=True,
    ),
    # run.sh:7-95 (SD3, phases 1/2/4, fixed w=3)
    "sd3_1phase_adv": Recipe(
        "sd3_1phase_adv", "sd3", 1024, 2, 20000, 5e-6,
        DistillConfig(num_solver_steps=100, multiphase=1, fixed_w=3.0),
        lora_rank=32, adversarial=True,
    ),
    "sd3_2phase_adv": Recipe(
        "sd3_2phase_adv", "sd3", 1024, 2, 20000, 5e-6,
        DistillConfig(num_solver_steps=100, multiphase=2, fixed_w=3.0),
        lora_rank=32, adversarial=True,
    ),
    "sd3_4phase_adv": Recipe(
        "sd3_4phase_adv", "sd3", 1024, 2, 20000, 5e-6,
        DistillConfig(num_solver_steps=100, multiphase=4, fixed_w=3.0),
        lora_rank=32, adversarial=True,
    ),
    # train_pcm_lora_sd3_adv_stochastic.py
    "sd3_adv_stochastic": Recipe(
        "sd3_adv_stochastic", "sd3", 1024, 2, 20000, 5e-6,
        DistillConfig(num_solver_steps=100, multiphase=1, fixed_w=3.0),
        lora_rank=32, adversarial=True, stochastic=True,
    ),
}


@dataclasses.dataclass(frozen=True)
class CachedStep:
    """A consistency step on cached latents that no CLI recipe names."""
    distill: DistillConfig
    lr: float
    time_ids: tuple  # SDXL micro-conditioning: original size, crop, target size


# The SDXL-1024 cached step, as `pcm_tpu/bench.py:175-181` builds it for
# ``--family sdxl --mode train``; the lr is the SDXL recipe's.
SDXL_CACHED_STEP = CachedStep(
    distill=DistillConfig(num_solver_steps=40, multiphase=4, w_min=6, w_max=7),
    lr=RECIPES["sdxl_4phase_adv"].lr,
    time_ids=(1024.0, 1024.0, 0.0, 0.0, 1024.0, 1024.0),
)
