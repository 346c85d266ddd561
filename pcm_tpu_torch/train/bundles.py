"""Model bundles for SD1.5 and SDXL (counterpart of `pcm_tpu/train/bundles.py`).

``frozen`` is a dict of the bundle's modules (``unet``, ``vae``, ``text``);
adapters are dicts of LoRA factors (`lora/layers.py`). The bundle-level API
keeps the JAX package's layout: latents and images are ``(N, H, W, C)``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Tuple

import torch
import torch.nn as nn

from ..lora.layers import LoRA, LoRASpec, attach_lora, init_lora
from ..models.clip import CLIPTextConfig, CLIPTextModel
from ..models.unet import UNet2DCondition, UNetConfig
from ..models.vae import AutoencoderKL, VAEConfig

# LoRA targets of the reference SD1.5/SDXL peft config (same names as the JAX package).
SD_UNET_LORA_TARGETS = (
    "to_q", "to_k", "to_v", "to_out_0", "proj_in", "proj_out",
    "net_0_proj", "net_2", "conv1", "conv2", "conv_shortcut",
    "downsamplers_0/conv", "upsamplers_0/conv", "time_emb_proj",
)

Cond = Dict[str, Any]
Frozen = Dict[str, nn.Module]


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _fill_fan_in(module: nn.Module, generator: torch.Generator) -> None:
    """Random weights drawn in place: 1-D weights (norm scales) 1, biases 0,
    everything else N(0, 1/fan_in) with fan_in the product of all dims but
    the output one (``train/bundles.py:init_frozen_fast`` of the JAX package)."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif p.ndim == 1:
                p.fill_(1.0)
            else:
                fan_in = p.shape[0] if isinstance(_owner(module, name), nn.Embedding) \
                    else p[0].numel()
                noise = torch.randn(p.shape, generator=generator, device=p.device,
                                    dtype=torch.float32)
                p.copy_(noise * fan_in ** -0.5)


def _owner(root: nn.Module, param_name: str) -> nn.Module:
    return root.get_submodule(param_name.rsplit(".", 1)[0])


def _build(make: Callable[[], Frozen], lora: LoRASpec, dtype: torch.dtype,
           device: torch.device) -> Frozen:
    """The modules ``make()`` builds, with uninitialized weights on ``device``
    (``torch.device("meta")`` builds the structure only); LoRA marked on the
    UNet, every module but the text tower in channels-last memory."""
    with torch.device("meta"):
        frozen = make()
    attach_lora(frozen["unet"], lora)
    if torch.device(device).type == "meta":
        return frozen
    out = {}
    for k, m in frozen.items():
        m = m.to_empty(device=device).to(dtype).eval().requires_grad_(False)
        if k != "text":
            m = m.to(memory_format=torch.channels_last)
        out[k] = m
    return out


def _from_states(frozen: Frozen, states: Mapping[str, Mapping[str, torch.Tensor]]) -> Frozen:
    for k, m in frozen.items():
        own = m.state_dict()
        m.load_state_dict({n: v for n, v in states[k].items() if n in own}, strict=True)
    return frozen


@dataclasses.dataclass(frozen=True)
class SD15Bundle:
    """SD1.5: single CLIP-L, last hidden state conditioning."""

    unet_cfg: UNetConfig
    vae_cfg: VAEConfig
    text_cfg: CLIPTextConfig
    lora: LoRASpec
    dtype: torch.dtype = torch.bfloat16
    remat: bool = False  # checkpoint each UNet block while grad is on (training)

    def build(self, device: torch.device) -> Frozen:
        """The bundle's modules with uninitialized weights on ``device``
        (``torch.device("meta")`` builds the structure only)."""
        return _build(lambda: {"unet": UNet2DCondition(self.unet_cfg, remat=self.remat),
                               "vae": AutoencoderKL(self.vae_cfg),
                               "text": CLIPTextModel(self.text_cfg)},
                      self.lora, self.dtype, device)

    def init(self, generator: torch.Generator, device: torch.device
             ) -> Tuple[Frozen, Dict[str, torch.Tensor]]:
        """Random weights from ``generator`` (fan-in scaled) and a zero-effect
        adapter template (LoRA ``b = 0``)."""
        frozen = self.build(device)
        for m in frozen.values():
            _fill_fan_in(m, generator)
        return frozen, init_lora(frozen["unet"], self.lora.rank, generator, device)

    def from_states(self, states: Mapping[str, Mapping[str, torch.Tensor]],
                    device: torch.device) -> Frozen:
        """Modules loaded from state dicts ``{"unet": ..., "vae": ..., "text": ...}``;
        keys a module lacks (the VAE encoder's) are ignored, missing ones raise."""
        return _from_states(self.build(device), states)

    # -- encoding / decoding ---------------------------------------------
    def encode_prompts(self, frozen: Frozen, input_ids: torch.Tensor) -> Cond:
        _, last, _ = frozen["text"](input_ids)
        return {"prompt_embeds": last}

    def encode(self, frozen: Frozen, batch: Mapping[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, Cond, Cond]:
        """(latents, cond, uncond) of a training batch (`pcm_tpu/train/bundles.py:177-198`):
        cached ``latents``, ``prompt_embeds`` (or ``input_ids`` through the
        text tower) and ``uncond_embeds``."""
        if "latents" not in batch:
            raise NotImplementedError(
                "training from pixels (the VAE encoder) is not yet ported to pcm_tpu_torch: "
                "train on cached latents (--cached-latents-dir)")
        if "prompt_embeds" in batch:
            prompt_embeds = batch["prompt_embeds"]
        else:
            with torch.no_grad():
                prompt_embeds = self.encode_prompts(frozen, batch["input_ids"])["prompt_embeds"]
        return (batch["latents"], {"prompt_embeds": prompt_embeds},
                {"prompt_embeds": batch["uncond_embeds"]})

    def decode_latents(self, frozen: Frozen, latents: torch.Tensor) -> torch.Tensor:
        """(N, h, w, C) latents -> (N, H, W, 3) pixels in [-1, 1]."""
        return _nhwc(frozen["vae"].decode(_nchw(latents)))

    # -- forwards ----------------------------------------------------------
    def student(self, frozen: Frozen, lora: LoRA, x: torch.Tensor, t: torch.Tensor,
                cond: Cond) -> torch.Tensor:
        return _nhwc(frozen["unet"](_nchw(x), t, cond["prompt_embeds"], lora,
                                    cond.get("added_cond")))

    def teacher(self, frozen: Frozen, x: torch.Tensor, t: torch.Tensor,
                cond: Cond) -> torch.Tensor:
        return self.student(frozen, None, x, t, cond)

    def teacher_features(self, frozen: Frozen, x: torch.Tensor, t: torch.Tensor, cond: Cond,
                         stop_after_mid: bool = False) -> Dict[str, torch.Tensor]:
        """The teacher's feature taps (`models/unet.py`), ``(N, h, w, C)`` each
        (`pcm_tpu/train/bundles.py:212-217`); differentiable in ``x``."""
        taps = frozen["unet"].features(_nchw(x), t, cond["prompt_embeds"], None,
                                       cond.get("added_cond"), stop_after_mid)
        return {k: _nhwc(v) for k, v in taps.items()}

    @property
    def latent_channels(self) -> int:
        return self.unet_cfg.in_channels

    @property
    def vae_scale(self) -> int:
        return 2 ** (len(self.vae_cfg.block_out_channels) - 1)


@dataclasses.dataclass(frozen=True)
class SDXLBundle:
    """SDXL on cached text embeddings (`pcm_tpu/train/bundles.py:SDXLBundle`,
    its cached path): the shard holds ``prompt_embeds`` (N, 77, 2048), the
    pooled CLIP-bigG ``pooled_embeds`` (N, 1280) and ``time_ids`` (N, 6). The
    text towers (CLIP-L + CLIP-bigG), ``encode_prompts`` and the SDXL VAE
    are not yet ported, so ``frozen`` holds the UNet alone."""

    unet_cfg: UNetConfig
    lora: LoRASpec
    dtype: torch.dtype = torch.bfloat16
    remat: bool = False

    def build(self, device: torch.device) -> Frozen:
        return _build(lambda: {"unet": UNet2DCondition(self.unet_cfg, remat=self.remat)},
                      self.lora, self.dtype, device)

    init = SD15Bundle.init

    def from_states(self, states: Mapping[str, Mapping[str, torch.Tensor]],
                    device: torch.device) -> Frozen:
        return _from_states(self.build(device), states)

    def encode(self, frozen: Frozen, batch: Mapping[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, Cond, Cond]:
        """(latents, cond, uncond) of a cached batch; the uncond branch is
        zero embeds and zero pooled embeds with the same ``time_ids``
        (`pcm_tpu/train/bundles.py:315-326`)."""
        missing = [k for k in ("latents", "prompt_embeds", "pooled_embeds", "time_ids")
                   if k not in batch]
        if missing:
            raise NotImplementedError(
                f"SDXL batches without {missing} (the VAE encoder and the text towers) are "
                "not yet ported to pcm_tpu_torch: train on cached latents and embeddings")
        prompt_embeds, pooled = batch["prompt_embeds"], batch["pooled_embeds"]
        time_ids = batch["time_ids"]
        cond = {"prompt_embeds": prompt_embeds,
                "added_cond": {"text_embeds": pooled, "time_ids": time_ids}}
        uncond = {"prompt_embeds": torch.zeros_like(prompt_embeds),
                  "added_cond": {"text_embeds": torch.zeros_like(pooled), "time_ids": time_ids}}
        return batch["latents"], cond, uncond

    student = SD15Bundle.student
    teacher = SD15Bundle.teacher
    teacher_features = SD15Bundle.teacher_features


def adapter_like(template: Mapping[str, torch.Tensor], generator: torch.Generator,
                 scale: float = 0.05) -> Dict[str, torch.Tensor]:
    """A seeded adapter with ``b != 0`` shaped like ``template`` (smoke and tests)."""
    return {k: torch.randn(v.shape, generator=generator, device=v.device) * scale
            for k, v in template.items()}
