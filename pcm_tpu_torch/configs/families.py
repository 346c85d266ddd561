"""Model-family bundle constructors, the training recipes and each family's
discriminator (counterpart of `pcm_tpu/configs/families.py`): bundles for
SD1.5, SDXL and SD3."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..lora.layers import LoRASpec
from ..models.clip import CLIP_BIG_G_CONFIG, CLIP_L_CONFIG, CLIPTextConfig
from ..models.mmdit import (SD3_ADV_LORA_TARGETS, SD3_ADV_STOCHASTIC_LORA_TARGETS,
                            SD3_LORA_TARGETS, SD3_MEDIUM_CONFIG, TINY_MMDIT_CONFIG)
from ..models.t5 import T5_XXL_CONFIG, T5Config
from ..models.unet import SD15_CONFIG, SDXL_CONFIG, TINY_SDXL_CONFIG, TINY_UNET_CONFIG
from ..models.vae import SD3_VAE_CONFIG, SD15_VAE_CONFIG, SDXL_VAE_CONFIG, TINY_VAE_CONFIG
from ..train.adv import SD3_DISC_CONFIG, SD15_DISC_CONFIG, SDXL_DISC_CONFIG, DiscriminatorConfig
from ..train.bundles import SD3Bundle, SD15Bundle, SDXLBundle, SD_UNET_LORA_TARGETS
from ..train.distill import DistillConfig

# tiny text tower for `tiny=True` (CPU smoke mode): CLIP-width vocab, width
# matched to TINY_UNET_CONFIG.cross_attention_dim
_TINY_CLIP_SD15 = CLIPTextConfig(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64)
# SDXL's two towers, concatenated to TINY_SDXL_CONFIG's 32-wide context; bigG's
# projection is its 32-wide pooled input (`pcm_tpu/configs/families.py:33-39`)
_TINY_CLIP_XL1 = CLIPTextConfig(hidden_size=16, num_layers=2, num_heads=2, intermediate_size=32)
_TINY_CLIP_XL2 = CLIPTextConfig(hidden_size=16, num_layers=2, num_heads=2, intermediate_size=32,
                                hidden_act="gelu", projection_dim=32)
# SD3's three towers (`pcm_tpu/configs/families.py:40-47`): two 16-wide CLIPs
# (pooled 16 + 16 = TINY_MMDIT_CONFIG's 32) and a 32-wide T5 of CLIP's vocab
_TINY_CLIP_SD3 = CLIPTextConfig(hidden_size=16, num_layers=2, num_heads=2, intermediate_size=32,
                                projection_dim=16)
_TINY_T5 = T5Config(vocab_size=49408, d_model=32, d_kv=8, d_ff=64, num_layers=2, num_heads=4)


def sd15_bundle(lora_rank: int = 64, dtype: torch.dtype = torch.bfloat16,
                tiny: bool = False, remat: bool = False, remat_policy: Optional[str] = None,
                remat_levels: Optional[Tuple[bool, ...]] = None,
                remat_granularity: str = "module") -> SD15Bundle:
    """The remat arguments as `pcm_tpu/configs/families.py:49-67` takes them
    (``remat_levels``: `bench.py`'s ``hybrid``)."""
    return SD15Bundle(
        unet_cfg=TINY_UNET_CONFIG if tiny else SD15_CONFIG,
        vae_cfg=TINY_VAE_CONFIG if tiny else SD15_VAE_CONFIG,
        text_cfg=_TINY_CLIP_SD15 if tiny else CLIP_L_CONFIG,
        lora=LoRASpec(rank=lora_rank, alpha=8.0, targets=SD_UNET_LORA_TARGETS),
        dtype=dtype,
        remat=remat,
        remat_policy=remat_policy,
        remat_levels=remat_levels,
        remat_granularity=remat_granularity,
    )


def sdxl_bundle(lora_rank: int = 64, dtype: torch.dtype = torch.bfloat16,
                tiny: bool = False, remat: bool = False, remat_policy: Optional[str] = None,
                remat_levels: Optional[Tuple[bool, ...]] = None,
                remat_granularity: str = "module") -> SDXLBundle:
    return SDXLBundle(
        unet_cfg=TINY_SDXL_CONFIG if tiny else SDXL_CONFIG,
        vae_cfg=TINY_VAE_CONFIG if tiny else SDXL_VAE_CONFIG,
        text_cfg=_TINY_CLIP_XL1 if tiny else CLIP_L_CONFIG,
        text2_cfg=_TINY_CLIP_XL2 if tiny else CLIP_BIG_G_CONFIG,
        lora=LoRASpec(rank=lora_rank, alpha=8.0, targets=SD_UNET_LORA_TARGETS),
        dtype=dtype,
        remat=remat,
        remat_policy=remat_policy,
        remat_levels=remat_levels,
        remat_granularity=remat_granularity,
    )


def sd3_bundle(lora_rank: int = 32, dtype: torch.dtype = torch.bfloat16, tiny: bool = False,
               remat: bool = False, adv_targets: bool = False,
               stochastic: bool = False, remat_policy: Optional[str] = None) -> SD3Bundle:
    """LoRA on `SD3_LORA_TARGETS`; with ``adv_targets`` on the adversarial
    recipes' list, without ``pos_embed.proj`` when ``stochastic``
    (`pcm_tpu/configs/families.py:92-117`)."""
    if adv_targets:
        targets = SD3_ADV_STOCHASTIC_LORA_TARGETS if stochastic else SD3_ADV_LORA_TARGETS
    else:
        targets = SD3_LORA_TARGETS
    return SD3Bundle(
        mmdit_cfg=TINY_MMDIT_CONFIG if tiny else SD3_MEDIUM_CONFIG,
        vae_cfg=TINY_VAE_CONFIG if tiny else SD3_VAE_CONFIG,
        text_cfg=_TINY_CLIP_SD3 if tiny else dataclasses.replace(CLIP_L_CONFIG, projection_dim=768),
        text2_cfg=_TINY_CLIP_SD3 if tiny else CLIP_BIG_G_CONFIG,
        t5_cfg=_TINY_T5 if tiny else T5_XXL_CONFIG,
        lora=LoRASpec(rank=lora_rank, alpha=8.0, targets=targets),
        dtype=dtype,
        remat=remat,
        remat_policy=remat_policy,
    )


# family -> (default resolution, token keys), as `scripts/serve.py:66-75`
FAMILIES = {"sd15": (512, ["input_ids"]), "sdxl": (1024, ["input_ids", "input_ids_2"]),
            "sd3": (1024, ["input_ids", "input_ids_2", "input_ids_3"])}

# the SD3 sampler's grid: the 100 solver steps the SD3 recipes train on (as
# `bench.py:build_infer` and `scripts/generate.py` sample; `scripts/serve.py`
# takes the sampler's default of 50, whose 4-step sigmas miss a 4-phase
# student's boundaries)
SD3_PCM_TIMESTEPS = 100


def decode_chunk(resolution: int) -> Optional[int]:
    """Samples a VAE decode call: one at >= 1024 px, else the batch. The
    reference decodes in chunks of 2 there when the batch is above 4
    (`scripts/serve.py:127`, for memory). On the H100 the decoder's cuDNN
    convolutions at 1024 px round a sample differently by its position in
    the batch, so one sample a call keeps a request's image the same in any
    batch (and holds less memory than 2)."""
    return 1 if resolution >= 1024 else None


def sd3_lora_targets(path: str, tiny: bool = False) -> dict:
    """The `sd3_bundle` keywords of the LoRA target list whose layers the
    kohya file at ``path`` holds, each layer of it and no other: the base
    list ``{}``, the adversarial one (with ``pos_embed.proj``) or the
    stochastic-adversarial one (without it). Raises ValueError for a file
    that matches none of the three."""
    from ..lora.kohya import kohya_key, kohya_layers
    from ..lora.layers import lora_shapes
    from ..utils.safetensors import read_header

    held = set(kohya_layers(read_header(path)))
    for kw in ({}, {"adv_targets": True}, {"adv_targets": True, "stochastic": True}):
        bundle = sd3_bundle(tiny=tiny, **kw)
        meta = bundle.build(torch.device("meta"), ("mmdit",))["mmdit"]
        layers = {kohya_key(k[:-len(".lora_a")], bundle.KOHYA_PREFIX)
                  for k in lora_shapes(meta, bundle.lora.rank) if k.endswith(".lora_a")}
        if layers == held:
            return kw
    raise ValueError(f"--lora {path}: its {len(held)} layers are none of the SD3 target lists "
                     "(base, adversarial, stochastic-adversarial) under 'lora_transformer'")


# Each family's discriminator (`pcm_tpu/train/adv.py:63-80`), and with ``tiny``
# the taps of the 2-level TINY UNets and the 2-block TINY MMDiT
# (`scripts/train.py:255-268`).
_DISC_CONFIGS = {
    ("sd15", False): SD15_DISC_CONFIG,
    ("sdxl", False): SDXL_DISC_CONFIG,
    ("sd3", False): SD3_DISC_CONFIG,
    ("sd3", True): DiscriminatorConfig(taps=("block_0", "block_1")),
    ("sd15", True): DiscriminatorConfig(taps=("down_0", "down_1", "mid", "up_0", "up_1"),
                                        num_h_per_head=4, kernel=3),
    ("sdxl", True): DiscriminatorConfig(taps=("down_0", "down_1", "mid")),
}


def disc_config(family: str, tiny: bool = False) -> DiscriminatorConfig:
    return _DISC_CONFIGS[family, tiny]


# ---------------------------------------------------------------------------
# The reference recipes, field for field as `pcm_tpu/configs/families.py:125-192`.
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
    # SDXL micro-conditioning: original size, crop, target size
    time_ids: Optional[tuple] = None
    batch_size: Optional[int] = None  # the recipe's own batch, where the bench takes it


# The SDXL-1024 cached step, as `pcm_tpu/bench.py:175-181` builds it for
# ``--family sdxl --mode train``; the lr is the SDXL recipe's.
SDXL_CACHED_STEP = CachedStep(
    distill=DistillConfig(num_solver_steps=40, multiphase=4, w_min=6, w_max=7),
    lr=RECIPES["sdxl_4phase_adv"].lr,
    time_ids=(1024.0, 1024.0, 0.0, 0.0, 1024.0, 1024.0),
)


# The SD3 cached step, as `bench.py:190-197` builds it for ``--family sd3
# --mode train``: 100 Euler solver steps, 4 phases, fixed w = 3, LoRA rank 32
# on SD3_LORA_TARGETS and the flow schedule at shift 3; the lr and the batch
# of 2 are the SD3 recipes'.
SD3_CACHED_STEP = CachedStep(
    distill=DistillConfig(num_solver_steps=100, multiphase=4, fixed_w=3.0),
    lr=RECIPES["sd3_4phase_adv"].lr,
    batch_size=RECIPES["sd3_4phase_adv"].batch_per_chip,
)
