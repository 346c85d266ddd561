"""UNet2DCondition for SD1.5 and SDXL (counterpart of `pcm_tpu/models/unet.py`).

NCHW tensors in ``torch.channels_last`` memory; diffusers state-dict names;
LoRA factors passed per call (``lora=None`` is the teacher). SDXL adds the
micro-conditioning ``added_cond`` ({"text_embeds", "time_ids"}) through
``add_embedding`` and linear transformer projections. ``remat=True``
checkpoints every ResnetBlock2D and Transformer2D while grad is enabled (the
JAX package's ``--remat full --remat-gran block`` of training).
`UNet2DCondition.features` returns the discriminator's feature taps (the
JAX package's ``sow("features", ...)``): ``down_{level}`` after each level
(its downsampler included), ``mid`` after the mid block and ``up_{i}`` after
each up block (its upsampler included); with ``stop_after_mid`` no up block
runs. ``time_cond_proj_dim`` adds the guidance embedding's bias-free
``time_embedding_cond_proj``: with ``timestep_cond`` (N, dim) given, its
output joins the sinusoid before ``time_embedding`` (no released config
sets it, and no converter maps a file key for it).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.utils.checkpoint

from ..lora.layers import LoRA, LoRAConv
from ..ops import common, reference_ops
from ..utils import quant
from .attention import Transformer2D
from .embeddings import TimestepEmbedding, sinusoidal_embedding
from .normalization import GroupNorm
from .resnet import Downsample2D, ResnetBlock2D, Upsample2D


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    attn_blocks: Tuple[bool, ...] = (True, True, True, False)
    num_heads: Tuple[int, ...] = (8, 8, 8, 8)
    transformer_depth: Tuple[int, ...] = (1, 1, 1, 1)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    use_linear_projection: bool = False
    norm_groups: int = 32
    # SDXL micro-conditioning: sinusoid width per time_id and the concat width
    addition_embed_dim: Optional[int] = None
    addition_in_dim: Optional[int] = None
    # width of the guidance embedding (`timestep_cond`); None = disabled
    time_cond_proj_dim: Optional[int] = None

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    def tap_channels(self) -> Dict[str, int]:
        """The channels of each feature tap of `UNet2DCondition.features`."""
        chans = self.block_out_channels
        return {**{f"down_{i}": c for i, c in enumerate(chans)}, "mid": chans[-1],
                **{f"up_{i}": c for i, c in enumerate(reversed(chans))}}


SD15_CONFIG = UNetConfig()

SDXL_CONFIG = UNetConfig(
    block_out_channels=(320, 640, 1280),
    attn_blocks=(False, True, True),
    num_heads=(5, 10, 20),
    transformer_depth=(1, 2, 10),
    cross_attention_dim=2048,
    use_linear_projection=True,
    addition_embed_dim=256,
    addition_in_dim=2816,
)

TINY_UNET_CONFIG = UNetConfig(
    block_out_channels=(32, 64),
    attn_blocks=(True, False),
    num_heads=(2, 2),
    transformer_depth=(1, 1),
    layers_per_block=1,
    cross_attention_dim=32,
)

TINY_SDXL_CONFIG = UNetConfig(
    block_out_channels=(32, 64),
    attn_blocks=(False, True),
    num_heads=(2, 2),
    transformer_depth=(1, 1),
    layers_per_block=1,
    cross_attention_dim=32,
    use_linear_projection=True,
    addition_embed_dim=32,
    addition_in_dim=32 * 6 + 32,
)


class _Block(nn.Module):
    """One resolution level: ``resnets``, ``attentions`` and one resampler."""

    def __init__(self):
        super().__init__()
        self.resnets = nn.ModuleList()
        self.attentions = nn.ModuleList()


@contextlib.contextmanager
def _kernel_choice(plain: frozenset, int8_mode: Optional[str]):
    names = () if common.ALL_KERNELS in plain else tuple(plain)
    with reference_ops(*names) if plain else contextlib.nullcontext():
        with quant.mode_context(int8_mode):
            yield


def _remat_contexts():
    """(forward, recompute) contexts of a checkpointed block: the recompute,
    which autograd may run on another thread, keeps the caller's choice of
    kernels or plain versions and its int8 mode (that of ``PCM_INT8_MATMUL``
    included)."""
    return contextlib.nullcontext(), _kernel_choice(common.reference_forced(), quant.int8_mode())


class UNet2DCondition(nn.Module):
    def __init__(self, cfg: UNetConfig = SD15_CONFIG, remat: bool = False):
        super().__init__()
        self.cfg = cfg
        self.remat = remat
        chans = cfg.block_out_channels
        ch0, temb = chans[0], cfg.time_embed_dim
        g = cfg.norm_groups

        def transformer(level: int, ch: int) -> Transformer2D:
            heads = cfg.num_heads[level]
            return Transformer2D(ch, heads, ch // heads, cfg.transformer_depth[level],
                                 cfg.cross_attention_dim, g, cfg.use_linear_projection)

        self.conv_in = LoRAConv(cfg.in_channels, ch0, 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch0, temb)
        if cfg.time_cond_proj_dim is not None:
            self.time_embedding_cond_proj = quant.DequantLinear(cfg.time_cond_proj_dim, ch0,
                                                                bias=False)
        if cfg.addition_in_dim is not None:
            self.add_embedding = TimestepEmbedding(cfg.addition_in_dim, temb)

        skips = [ch0]
        h_ch = ch0
        self.down_blocks = nn.ModuleList()
        for level, ch in enumerate(chans):
            blk = _Block()
            for _ in range(cfg.layers_per_block):
                blk.resnets.append(ResnetBlock2D(h_ch, ch, temb, g))
                h_ch = ch
                if cfg.attn_blocks[level]:
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
            for _ in range(cfg.layers_per_block + 1):
                blk.resnets.append(ResnetBlock2D(h_ch + skips.pop(), ch, temb, g))
                h_ch = ch
                if cfg.attn_blocks[level]:
                    blk.attentions.append(transformer(level, ch))
            if level > 0:
                blk.upsamplers = nn.ModuleList([Upsample2D(ch)])
            self.up_blocks.append(blk)

        self.conv_norm_out = GroupNorm(g, ch0, act="silu")
        self.conv_out = LoRAConv(ch0, cfg.out_channels, 3, padding=1)

    def _block(self, module: nn.Module, *args) -> torch.Tensor:
        if self.remat and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(module, *args, use_reentrant=False,
                                                     context_fn=_remat_contexts)
        return module(*args)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor, lora: LoRA = None,
                added_cond: Optional[Dict[str, torch.Tensor]] = None,
                timestep_cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        """sample (N, C, H, W), timesteps (N,), encoder_hidden_states (N, S, D);
        SDXL: added_cond {"text_embeds": (N, 1280), "time_ids": (N, 6)};
        timestep_cond (N, time_cond_proj_dim) where the config sets it."""
        return self._run(sample, timesteps, encoder_hidden_states, lora, added_cond,
                         timestep_cond=timestep_cond)

    def features(self, sample: torch.Tensor, timesteps: torch.Tensor,
                 encoder_hidden_states: torch.Tensor, lora: LoRA = None,
                 added_cond: Optional[Dict[str, torch.Tensor]] = None,
                 stop_after_mid: bool = False) -> Dict[str, torch.Tensor]:
        """The feature taps of a forward, NCHW tensors in the model's dtype
        (arguments as `forward`); with ``stop_after_mid`` the down and mid
        taps only, and no up block runs."""
        taps: Dict[str, torch.Tensor] = {}
        self._run(sample, timesteps, encoder_hidden_states, lora, added_cond, taps,
                  stop_after_mid)
        return taps

    def _run(self, sample, timesteps, encoder_hidden_states, lora, added_cond,
             taps: Optional[Dict[str, torch.Tensor]] = None, stop_after_mid: bool = False,
             timestep_cond: Optional[torch.Tensor] = None):
        run = self._block
        cfg = self.cfg
        dtype = self.conv_norm_out.weight.dtype  # a norm scale: never quantized
        t_emb = sinusoidal_embedding(timesteps, cfg.block_out_channels[0]).to(dtype)
        if cfg.time_cond_proj_dim is not None and timestep_cond is not None:
            t_emb = t_emb + self.time_embedding_cond_proj(timestep_cond.to(dtype))
        temb = self.time_embedding(t_emb)
        if cfg.addition_in_dim is not None:
            if added_cond is None:
                raise ValueError("an SDXL UNet needs added_cond (text_embeds, time_ids)")
            time_ids = added_cond["time_ids"]
            aug = sinusoidal_embedding(time_ids.reshape(-1), cfg.addition_embed_dim)
            aug = torch.cat([added_cond["text_embeds"].float(),
                             aug.reshape(time_ids.shape[0], -1)], dim=-1)
            temb = temb + self.add_embedding(aug.to(dtype))
        context = encoder_hidden_states.to(dtype)
        sample = sample.to(dtype).contiguous(memory_format=torch.channels_last)

        tap = taps.__setitem__ if taps is not None else lambda name, t: None
        h = self.conv_in(sample, lora)
        skips = [h]
        for level, blk in enumerate(self.down_blocks):
            for j, resnet in enumerate(blk.resnets):
                h = run(resnet, h, temb, lora)
                if len(blk.attentions):
                    h = run(blk.attentions[j], h, context, lora)
                skips.append(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h, lora)
                skips.append(h)
            tap(f"down_{level}", h)

        mid = self.mid_block
        h = run(mid.resnets[0], h, temb, lora)
        h = run(mid.attentions[0], h, context, lora)
        h = run(mid.resnets[1], h, temb, lora)
        tap("mid", h)
        if stop_after_mid:
            return None

        for i, blk in enumerate(self.up_blocks):
            for j, resnet in enumerate(blk.resnets):
                h = torch.cat([h, skips.pop()], dim=1)
                h = run(resnet, h, temb, lora)
                if len(blk.attentions):
                    h = run(blk.attentions[j], h, context, lora)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h, lora)
            tap(f"up_{i}", h)

        return self.conv_out(self.conv_norm_out(h), lora)
