"""Model bundles for SD1.5, SDXL and SD3 (counterpart of `pcm_tpu/train/bundles.py`).

``frozen`` is a dict of the bundle's modules (``unet``, ``vae``, ``text``,
and SDXL's ``text2``; SD3's ``mmdit``, ``vae``, ``text``, ``text2`` and ``t5``);
adapters are dicts of LoRA factors (`lora/layers.py`). The bundle-level API
keeps the JAX package's layout: latents and images are ``(N, H, W, C)``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch
import torch.nn as nn

from ..lora.layers import LoRA, LoRASpec, attach_lora, init_lora
from ..models.clip import CLIPTextConfig, CLIPTextModel
from ..models.mmdit import MMDiT, MMDiTConfig
from ..models.t5 import T5Config, T5Encoder
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


def fill_fan_in(module: nn.Module, generator: torch.Generator,
                 which: Callable[[str], bool] = lambda name: True) -> None:
    """Random weights drawn in place for the parameters ``which`` names:
    1-D weights (norm scales) 1, biases 0, everything else N(0, 1/fan_in)
    with fan_in the product of all dims but the output one
    (``train/bundles.py:init_frozen_fast`` of the JAX package)."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if not which(name):
                continue
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


def _own_stream(generator: torch.Generator, tag: int) -> torch.Generator:
    """A generator of its own, seeded from ``generator``'s seed and ``tag``:
    drawing from it leaves ``generator``'s stream where it was."""
    seed = (generator.initial_seed() * 1000003 + tag) % 2 ** 63
    return torch.Generator(generator.device).manual_seed(seed)


_ENCODER_STREAM = 0x5D15E  # the VAE encoder's weights (`SD15Bundle.init`)
# SDXL's modules besides the UNet, each from a stream of its own (`SDXLBundle.init`)
_SDXL_STREAMS = {"vae": 0x5D1C1, "text": 0x5D1C2, "text2": 0x5D1C3}
# SD3's modules besides the MMDiT (`SD3Bundle.init`)
_SD3_STREAMS = {"vae": 0x5D3C1, "text": 0x5D3C2, "text2": 0x5D3C3, "t5": 0x5D3C4}
TEXT_TOWERS = ("text", "text2", "t5")
BACKBONES = ("unet", "mmdit")  # the modules that carry LoRA


def _owner(root: nn.Module, param_name: str) -> nn.Module:
    return root.get_submodule(param_name.rsplit(".", 1)[0])


def _build(make: Callable[[], Frozen], lora: LoRASpec, dtype: torch.dtype,
           device: torch.device) -> Frozen:
    """The modules ``make()`` builds, with uninitialized weights on ``device``
    (``torch.device("meta")`` builds the structure only); LoRA marked on the
    backbone (UNet or MMDiT), every module but the text towers in
    channels-last memory."""
    with torch.device("meta"):
        frozen = make()
    for k in BACKBONES:
        if k in frozen:
            attach_lora(frozen[k], lora)
    if torch.device(device).type == "meta":
        return frozen
    out = {}
    for k, m in frozen.items():
        # cast on the meta device first: storage is allocated once, in ``dtype``
        # (materialized in fp32 first, T5-XXL alone would take 19 GB before its cast)
        m = m.to(dtype).to_empty(device=device).eval().requires_grad_(False)
        if k not in TEXT_TOWERS:
            m = m.to(memory_format=torch.channels_last)
        out[k] = m
    return out


def _from_states(frozen: Frozen, states: Mapping[str, Mapping[str, torch.Tensor]]) -> Frozen:
    for k, m in frozen.items():
        own = m.state_dict()
        m.load_state_dict({n: v for n, v in states[k].items() if n in own}, strict=True)
    return frozen


def _decode(frozen: Frozen, latents: torch.Tensor, chunk: Optional[int]) -> torch.Tensor:
    """(N, h, w, C) latents -> (N, H, W, 3) pixels in [-1, 1], ``chunk``
    samples a decoder call (the reference's `_decode_chunked`: the batch
    must divide by the chunk)."""
    n = latents.shape[0]
    if not chunk or n <= chunk:
        return _nhwc(frozen["vae"].decode(_nchw(latents)))
    if n % chunk:
        raise ValueError(f"batch {n} not divisible by decode chunk {chunk}")
    return torch.cat([_nhwc(frozen["vae"].decode(_nchw(latents[i:i + chunk])))
                      for i in range(0, n, chunk)])


def _unet_remat(bundle) -> Dict[str, Any]:
    """The UNet's remat arguments of an SD1.5 or SDXL bundle."""
    return dict(remat=bundle.remat, remat_policy=bundle.remat_policy,
                remat_levels=bundle.remat_levels, remat_granularity=bundle.remat_granularity)


@dataclasses.dataclass(frozen=True)
class SD15Bundle:
    """SD1.5: single CLIP-L, last hidden state conditioning."""

    unet_cfg: UNetConfig
    vae_cfg: VAEConfig
    text_cfg: CLIPTextConfig
    lora: LoRASpec
    dtype: torch.dtype = torch.bfloat16
    remat: bool = False  # checkpoint each UNet block while grad is on (training)
    remat_policy: Optional[str] = None  # what a region keeps (ops/common.py:resolve_remat_policy)
    remat_levels: Optional[Tuple[bool, ...]] = None  # per-level mask (models/unet.py)
    remat_granularity: str = "module"  # "block": a region a BasicTransformerBlock
    vae_encode_chunk: Optional[int] = None  # samples a VAE encode call (None: the batch)

    KOHYA_PREFIX = "lora_unet"  # the key prefix of the family's kohya LoRA files

    def build(self, device: torch.device) -> Frozen:
        """The bundle's modules with uninitialized weights on ``device``
        (``torch.device("meta")`` builds the structure only)."""
        return _build(lambda: {"unet": UNet2DCondition(self.unet_cfg, **_unet_remat(self)),
                               "vae": AutoencoderKL(self.vae_cfg),
                               "text": CLIPTextModel(self.text_cfg)},
                      self.lora, self.dtype, device)

    def init(self, generator: torch.Generator, device: torch.device
             ) -> Tuple[Frozen, Dict[str, torch.Tensor]]:
        """Random weights from ``generator`` (fan-in scaled) and a zero-effect
        adapter template (LoRA ``b = 0``). The VAE encoder's weights come from
        a stream of their own (`_own_stream`), so every other weight and the
        template are the draws they were before the encoder was ported."""
        frozen = self.build(device)

        def encoder(name: str) -> bool:
            return name.startswith(AutoencoderKL.ENCODER_PREFIXES)

        for k, m in frozen.items():
            fill_fan_in(m, generator, lambda n: k != "vae" or not encoder(n))
        template = init_lora(frozen["unet"], self.lora.rank, generator, device)
        if "vae" in frozen:
            fill_fan_in(frozen["vae"], _own_stream(generator, _ENCODER_STREAM), encoder)
        return frozen, template

    def from_states(self, states: Mapping[str, Mapping[str, torch.Tensor]],
                    device: torch.device) -> Frozen:
        """Modules loaded from state dicts ``{"unet": ..., "vae": ..., "text": ...}``;
        keys a module lacks are ignored, missing ones raise."""
        return _from_states(self.build(device), states)

    # -- encoding / decoding ---------------------------------------------
    def encode_prompts(self, frozen: Frozen, input_ids: torch.Tensor) -> Cond:
        _, last, _ = frozen["text"](input_ids)
        return {"prompt_embeds": last}

    def encode(self, frozen: Frozen, batch: Mapping[str, torch.Tensor],
               vae_noise: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Cond, Cond]:
        """(latents, cond, uncond) of a training batch (`pcm_tpu/train/bundles.py:177-198`):
        cached ``latents`` or ``pixel_values`` (N, H, W, 3) in [-1, 1] through the
        VAE encoder with the posterior noise ``vae_noise`` (N, h, w, C), in
        chunks of ``vae_encode_chunk`` samples; ``prompt_embeds`` or
        ``input_ids`` through the text tower; ``uncond_embeds``."""
        if "prompt_embeds" in batch:
            prompt_embeds = batch["prompt_embeds"]
        else:
            with torch.no_grad():
                prompt_embeds = self.encode_prompts(frozen, batch["input_ids"])["prompt_embeds"]
        if "latents" in batch:
            latents = batch["latents"]
        else:
            latents = self.encode_pixels(frozen, batch["pixel_values"], vae_noise)
        return (latents, {"prompt_embeds": prompt_embeds},
                {"prompt_embeds": batch["uncond_embeds"]})

    @torch.no_grad()
    def encode_pixels(self, frozen: Frozen, pixels: torch.Tensor,
                      noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(N, H, W, 3) pixels -> (N, h, w, C) latents, ``vae_encode_chunk``
        samples a call (the reference encodes in chunks of up to 32); row i
        takes the posterior noise ``noise[i]``."""
        n = pixels.shape[0]
        chunk = self.vae_encode_chunk or n
        outs = []
        for i in range(0, n, chunk):
            eps = None if noise is None else _nchw(noise[i:i + chunk])
            outs.append(_nhwc(frozen["vae"].encode(_nchw(pixels[i:i + chunk]), eps)))
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    def latents_like(self, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """An empty tensor shaped, typed and placed like the latents of
        ``batch`` (its cached ``latents``, or what its pixels encode to)."""
        if "latents" in batch:
            return batch["latents"]
        n, h, w, _ = batch["pixel_values"].shape
        s = self.vae_scale
        return torch.empty((n, h // s, w // s, self.vae_cfg.latent_channels), dtype=self.dtype,
                           device=batch["pixel_values"].device)

    def decode_latents(self, frozen: Frozen, latents: torch.Tensor,
                       chunk: Optional[int] = None) -> torch.Tensor:
        """(N, h, w, C) latents -> (N, H, W, 3) pixels in [-1, 1], ``chunk``
        samples a decoder call (None: the batch)."""
        return _decode(frozen, latents, chunk)

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

    def tap_channels(self) -> Dict[str, int]:
        """The channels of each feature tap of `teacher_features`."""
        return self.unet_cfg.tap_channels()

    @property
    def vae_scale(self) -> int:
        return 2 ** (len(self.vae_cfg.block_out_channels) - 1)


@dataclasses.dataclass(frozen=True)
class SDXLBundle:
    """SDXL: CLIP-L and CLIP-bigG (penultimate hidden states concatenated,
    bigG's projected pooled output), the SDXL VAE and the UNet's
    micro-conditioning (`pcm_tpu/train/bundles.py:SDXLBundle`). A batch
    holds cached ``prompt_embeds`` (N, 77, 2048) and ``pooled_embeds``
    (N, 1280) or the two towers' ``input_ids`` and ``input_ids_2``; cached
    ``latents`` or ``pixel_values``; and ``time_ids`` (N, 6): original
    size, crop top-left, target size."""

    unet_cfg: UNetConfig
    vae_cfg: VAEConfig
    text_cfg: CLIPTextConfig  # CLIP-L
    text2_cfg: CLIPTextConfig  # CLIP-bigG, with its projection
    lora: LoRASpec
    dtype: torch.dtype = torch.bfloat16
    remat: bool = False
    remat_policy: Optional[str] = None
    remat_levels: Optional[Tuple[bool, ...]] = None
    remat_granularity: str = "module"
    vae_encode_chunk: Optional[int] = None  # samples a VAE encode call (None: the batch)

    MODULES = ("unet", "vae", "text", "text2")
    KOHYA_PREFIX = "lora_unet"

    def build(self, device: torch.device, modules: Tuple[str, ...] = MODULES) -> Frozen:
        """``modules`` of the bundle with uninitialized weights on ``device``."""
        make = {"unet": lambda: UNet2DCondition(self.unet_cfg, **_unet_remat(self)),
                "vae": lambda: AutoencoderKL(self.vae_cfg),
                "text": lambda: CLIPTextModel(self.text_cfg),
                "text2": lambda: CLIPTextModel(self.text2_cfg)}
        return _build(lambda: {k: make[k]() for k in modules}, self.lora, self.dtype, device)

    def init(self, generator: torch.Generator, device: torch.device,
             modules: Tuple[str, ...] = MODULES) -> Tuple[Frozen, Dict[str, torch.Tensor]]:
        """Random weights of ``modules`` and the zero-effect adapter template
        (empty without the UNet). The UNet and the template take
        ``generator``'s draws, as when the bundle held the UNet alone; the
        VAE and each text tower draw from a stream of their own
        (`_own_stream`), so any subset of the modules gets the weights the
        whole bundle gets."""
        frozen = self.build(device, modules)
        template = {}
        if "unet" in frozen:
            fill_fan_in(frozen["unet"], generator)
            template = init_lora(frozen["unet"], self.lora.rank, generator, device)
        for k, tag in _SDXL_STREAMS.items():
            if k in frozen:
                fill_fan_in(frozen[k], _own_stream(generator, tag))
        return frozen, template

    def from_states(self, states: Mapping[str, Mapping[str, torch.Tensor]],
                    device: torch.device) -> Frozen:
        """The modules ``states`` names (of ``{"unet", "vae", "text",
        "text2"}``) loaded from their state dicts; a run on cached
        embeddings and latents needs the UNet alone."""
        return _from_states(self.build(device, tuple(k for k in self.MODULES if k in states)),
                            states)

    # -- encoding / decoding ---------------------------------------------
    def encode_prompts(self, frozen: Frozen, input_ids: torch.Tensor, input_ids_2: torch.Tensor,
                       time_ids: torch.Tensor) -> Cond:
        """The towers' penultimate hidden states concatenated (N, 77, 768 +
        1280) and bigG's projected pooled output as ``text_embeds``
        (`pcm_tpu/train/bundles.py:282-289`)."""
        hidden1, _, _ = frozen["text"](input_ids)
        hidden2, _, pooled2 = frozen["text2"](input_ids_2)
        return {"prompt_embeds": torch.cat([hidden1[-2], hidden2[-2]], dim=-1),
                "added_cond": {"text_embeds": pooled2, "time_ids": time_ids}}

    def encode(self, frozen: Frozen, batch: Mapping[str, torch.Tensor],
               vae_noise: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Cond, Cond]:
        """(latents, cond, uncond) of a training batch (`pcm_tpu/train/bundles.py:294-327`):
        cached embeddings or the captions' ids through the towers; cached
        ``latents`` or ``pixel_values`` through the VAE encoder with the
        posterior noise ``vae_noise`` (`SD15Bundle.encode_pixels`). The
        uncond branch is zero embeds and zero pooled embeds with the batch's
        own ``time_ids``."""
        time_ids = batch["time_ids"]
        if "prompt_embeds" in batch:
            prompt_embeds, pooled = batch["prompt_embeds"], batch["pooled_embeds"]
        else:
            with torch.no_grad():
                c = self.encode_prompts(frozen, batch["input_ids"], batch["input_ids_2"],
                                        time_ids)
            prompt_embeds, pooled = c["prompt_embeds"], c["added_cond"]["text_embeds"]
        if "latents" in batch:
            latents = batch["latents"]
        else:
            latents = self.encode_pixels(frozen, batch["pixel_values"], vae_noise)
        cond = {"prompt_embeds": prompt_embeds,
                "added_cond": {"text_embeds": pooled, "time_ids": time_ids}}
        uncond = {"prompt_embeds": torch.zeros_like(prompt_embeds),
                  "added_cond": {"text_embeds": torch.zeros_like(pooled), "time_ids": time_ids}}
        return latents, cond, uncond

    encode_pixels = SD15Bundle.encode_pixels
    latents_like = SD15Bundle.latents_like
    decode_latents = SD15Bundle.decode_latents
    student = SD15Bundle.student
    teacher = SD15Bundle.teacher
    teacher_features = SD15Bundle.teacher_features
    tap_channels = SD15Bundle.tap_channels
    latent_channels = SD15Bundle.latent_channels
    vae_scale = SD15Bundle.vae_scale


@dataclasses.dataclass(frozen=True)
class SD3Bundle:
    """SD3 (`pcm_tpu/train/bundles.py:335-448`): the MMDiT; CLIP-L (with its
    768 projection) and CLIP-bigG, whose penultimate hidden states are
    concatenated, zero-padded to the T5 width and followed along the
    sequence by T5-XXL's output, and whose projected pooled outputs are
    concatenated; the 16-channel VAE. A batch holds cached ``latents`` or
    ``pixel_values``, cached ``prompt_embeds`` (N, 154, 4096) and
    ``pooled_embeds`` (N, 2048) or the three towers' ``input_ids``,
    ``input_ids_2`` and ``input_ids_3``, and the uncond branch's
    ``uncond_embeds`` / ``uncond_pooled``."""

    mmdit_cfg: MMDiTConfig
    vae_cfg: VAEConfig
    text_cfg: CLIPTextConfig  # CLIP-L with its projection
    text2_cfg: CLIPTextConfig  # CLIP-bigG with its projection
    t5_cfg: T5Config
    lora: LoRASpec
    dtype: torch.dtype = torch.bfloat16
    remat: bool = False  # checkpoint each joint block while grad is on (training)
    remat_policy: Optional[str] = None
    vae_encode_chunk: Optional[int] = None  # samples a VAE encode call (None: the batch)

    MODULES = ("mmdit", "vae", "text", "text2", "t5")
    # the SD3 trainers' kohya prefix (`scripts/train.py:378`, `scripts/generate.py:79`)
    KOHYA_PREFIX = "lora_transformer"

    def build(self, device: torch.device, modules: Tuple[str, ...] = MODULES) -> Frozen:
        """``modules`` of the bundle with uninitialized weights on ``device``."""
        make = {"mmdit": lambda: MMDiT(self.mmdit_cfg, remat=self.remat,
                                          remat_policy=self.remat_policy),
                "vae": lambda: AutoencoderKL(self.vae_cfg),
                "text": lambda: CLIPTextModel(self.text_cfg),
                "text2": lambda: CLIPTextModel(self.text2_cfg),
                "t5": lambda: T5Encoder(self.t5_cfg)}
        return _build(lambda: {k: make[k]() for k in modules}, self.lora, self.dtype, device)

    def init(self, generator: torch.Generator, device: torch.device,
             modules: Tuple[str, ...] = MODULES) -> Tuple[Frozen, Dict[str, torch.Tensor]]:
        """Random weights of ``modules`` and the zero-effect adapter template
        (empty without the MMDiT): the MMDiT and the template take
        ``generator``'s draws, the VAE and each text tower a stream of their
        own (`_own_stream`), so any subset of the modules gets the weights
        the whole bundle gets."""
        frozen = self.build(device, modules)
        template = {}
        if "mmdit" in frozen:
            fill_fan_in(frozen["mmdit"], generator)
            template = init_lora(frozen["mmdit"], self.lora.rank, generator, device)
        for k, tag in _SD3_STREAMS.items():
            if k in frozen:
                fill_fan_in(frozen[k], _own_stream(generator, tag))
        return frozen, template

    def from_states(self, states: Mapping[str, Mapping[str, torch.Tensor]],
                    device: torch.device) -> Frozen:
        """The modules ``states`` names (of `MODULES`) loaded from their state
        dicts; the step on cached latents needs the MMDiT alone."""
        return _from_states(self.build(device, tuple(k for k in self.MODULES if k in states)),
                            states)

    # -- encoding / decoding ---------------------------------------------
    def encode_prompts(self, frozen: Frozen, input_ids: torch.Tensor, input_ids_2: torch.Tensor,
                       input_ids_3: torch.Tensor) -> Cond:
        """``prompt_embeds`` (N, 2 * 77, joint width) and ``pooled`` (N, 768 +
        1280) of the three towers (`pcm_tpu/train/bundles.py:388-401`)."""
        hidden1, _, pooled1 = frozen["text"](input_ids)
        hidden2, _, pooled2 = frozen["text2"](input_ids_2)
        clip_seq = torch.cat([hidden1[-2], hidden2[-2]], dim=-1)
        clip_seq = torch.nn.functional.pad(
            clip_seq, (0, self.mmdit_cfg.joint_attention_dim - clip_seq.shape[-1]))
        t5_seq = frozen["t5"](input_ids_3).to(clip_seq.dtype)
        return {"prompt_embeds": torch.cat([clip_seq, t5_seq], dim=1),
                "pooled": torch.cat([pooled1, pooled2], dim=-1)}

    def encode(self, frozen: Frozen, batch: Mapping[str, torch.Tensor],
               vae_noise: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Cond, Cond]:
        """(latents, cond, uncond) of a training batch (`pcm_tpu/train/bundles.py:406-431`):
        cached embeddings or the captions' ids through the towers; cached
        ``latents`` or ``pixel_values`` through the VAE encoder with the
        posterior noise ``vae_noise`` (`SD15Bundle.encode_pixels`), in the
        bundle's dtype as the JAX bundle encodes (the reference keeps the
        SD3 VAE in fp32, `train_pcm_lora_sd3.py:954`); the batch's
        ``uncond_embeds`` / ``uncond_pooled``."""
        if "prompt_embeds" in batch:
            prompt_embeds, pooled = batch["prompt_embeds"], batch["pooled_embeds"]
        else:
            with torch.no_grad():
                c = self.encode_prompts(frozen, batch["input_ids"], batch["input_ids_2"],
                                        batch["input_ids_3"])
            prompt_embeds, pooled = c["prompt_embeds"], c["pooled"]
        if "latents" in batch:
            latents = batch["latents"]
        else:
            latents = self.encode_pixels(frozen, batch["pixel_values"], vae_noise)
        return (latents, {"prompt_embeds": prompt_embeds, "pooled": pooled},
                {"prompt_embeds": batch["uncond_embeds"], "pooled": batch["uncond_pooled"]})

    encode_pixels = SD15Bundle.encode_pixels
    decode_latents = SD15Bundle.decode_latents
    latents_like = SD15Bundle.latents_like
    vae_scale = SD15Bundle.vae_scale

    # -- forwards ----------------------------------------------------------
    def student(self, frozen: Frozen, lora: LoRA, x: torch.Tensor, t: torch.Tensor,
                cond: Cond) -> torch.Tensor:
        """The velocity (N, h, w, C) at latents ``x`` (N, h, w, C), timesteps ``t``."""
        return frozen["mmdit"](x, t, cond["prompt_embeds"], cond["pooled"], lora)

    def teacher(self, frozen: Frozen, x: torch.Tensor, t: torch.Tensor,
                cond: Cond) -> torch.Tensor:
        return self.student(frozen, None, x, t, cond)

    def teacher_features(self, frozen: Frozen, x: torch.Tensor, t: torch.Tensor, cond: Cond,
                         stop_after_mid: bool = False) -> Dict[str, torch.Tensor]:
        """The teacher's taps ``block_{i}`` (N, S, C) (`pcm_tpu/train/bundles.py:443-448`);
        differentiable in ``x``. ``stop_after_mid`` is taken and ignored, as
        the JAX bundle does: an MMDiT has no mid block."""
        return frozen["mmdit"].features(x, t, cond["prompt_embeds"], cond["pooled"])

    def tap_channels(self) -> Dict[str, int]:
        return self.mmdit_cfg.tap_channels()

    @property
    def latent_channels(self) -> int:
        return self.mmdit_cfg.in_channels


def adapter_like(template: Mapping[str, torch.Tensor], generator: torch.Generator,
                 scale: float = 0.05) -> Dict[str, torch.Tensor]:
    """A seeded adapter with ``b != 0`` shaped like ``template`` (smoke and tests)."""
    return {k: torch.randn(v.shape, generator=generator, device=v.device) * scale
            for k, v in template.items()}
