"""LoRA-aware linear and conv layers.

Counterpart of `pcm_tpu/lora/layers.py`. The base weights live in the
module (diffusers names); the low-rank factors do not. They travel as one
flat dict per adapter, ``{"<module path>.lora_a": A, "<module path>.lora_b": B}``,
passed to ``forward``. So the teacher (``lora=None``) and every student
adapter share one set of base weights, and swapping an adapter swaps a dict.

The student path is ``y = x Wᵀ + b + s · (x Aᵀ) Bᵀ``, two skinny products;
``W + s·B A`` is never formed. Shapes: linear ``A (r, in)``, ``B (out, r)``;
conv ``A (r, in, kh, kw)`` with the layer's stride and padding, then
``B (out, r, 1, 1)``.

The base weight ``W`` is bf16 or, after `utils.quant.quantize_frozen`, int8
codes with per-channel scales. Then the base product routes as `_base_dot`
/ `_base_conv` do (`pcm_tpu/lora/layers.py:62-84`): through the int8 path
of the active `int8_matmul` mode that covers its op class (a Linear under
``dense``, ``both`` and ``fused``; a conv as `quantized_conv` routes it),
else through the dequantized weight. The
LoRA factors stay in the activations' dtype over their fp32 masters.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.convert import torch_segment
from ..utils.quant import (QuantizableWeight, int8_matmul_enabled, quantized_conv,
                           quantized_dot)

LoRA = Optional[Dict[str, torch.Tensor]]


def _dotted(target: str) -> str:
    """JAX-package target name -> diffusers module-path fragment
    ("to_out_0" -> "to_out.0", "downsamplers_0/conv" -> "downsamplers.0.conv"),
    segment by segment as the weight converter names them."""
    return ".".join(torch_segment(s) for s in target.split("/"))


@dataclasses.dataclass(frozen=True)
class LoRASpec:
    """Which layers carry LoRA and at what rank.

    ``targets`` use the JAX package's names (`SD_UNET_LORA_TARGETS`) and are
    matched as substrings of the diffusers-style dotted module path.
    """

    rank: int = 0
    alpha: Optional[float] = None  # defaults to rank (scale 1.0)
    targets: Tuple[str, ...] = ()

    @property
    def scale(self) -> float:
        return (self.alpha if self.alpha is not None else self.rank) / max(self.rank, 1)

    def matches(self, path: str) -> bool:
        if self.rank <= 0 or not self.targets:
            return False
        return any(_dotted(t) in path for t in self.targets)


NO_LORA = LoRASpec()


class LoRALinear(QuantizableWeight, nn.Linear):
    """``nn.Linear`` that adds ``s·(x Aᵀ) Bᵀ`` when its factors are passed."""

    lora_key: Optional[str] = None  # set by `attach_lora` on matching layers
    lora_scale: float = 1.0

    def forward(self, x: torch.Tensor, lora: LoRA = None) -> torch.Tensor:
        qt = self.qweight()
        if qt is None:
            y = F.linear(x, self.weight, self.bias)
        elif int8_matmul_enabled("dense"):
            y = quantized_dot(x, qt)
            y = y if self.bias is None else y + self.bias
        else:
            y = F.linear(x, qt.astype(x.dtype), self.bias)
        if lora is not None and self.lora_key is not None:
            a = lora[self.lora_key + ".lora_a"].to(x.dtype)
            b = lora[self.lora_key + ".lora_b"].to(x.dtype)
            y = y + self.lora_scale * F.linear(F.linear(x, a), b)
        return y


class LoRAConv(QuantizableWeight, nn.Conv2d):
    """``nn.Conv2d`` that adds ``s·conv(conv(x, A), B)`` when its factors are passed."""

    lora_key: Optional[str] = None
    lora_scale: float = 1.0

    def forward(self, x: torch.Tensor, lora: LoRA = None) -> torch.Tensor:
        qt = self.qweight()
        if qt is None:
            y = self._conv_forward(x, self.weight, self.bias)
        else:
            y = quantized_conv(x, qt, self.bias, self.stride, self.padding)
        if lora is not None and self.lora_key is not None:
            a = lora[self.lora_key + ".lora_a"].to(x.dtype)
            b = lora[self.lora_key + ".lora_b"].to(x.dtype)
            h = F.conv2d(x, a, stride=self.stride, padding=self.padding)
            y = y + self.lora_scale * F.conv2d(h, b)
        return y


def attach_lora(model: nn.Module, spec: LoRASpec) -> None:
    """Mark the LoRA layers of ``model`` whose module path matches ``spec``."""
    for path, m in model.named_modules():
        if isinstance(m, (LoRALinear, LoRAConv)):
            m.lora_key = path if spec.matches(path) else None
            m.lora_scale = spec.scale


def lora_shapes(model: nn.Module, rank: int) -> Dict[str, Tuple[int, ...]]:
    """Factor shapes of every marked layer, keyed as in an adapter dict."""
    shapes = {}
    for m in model.modules():
        if isinstance(m, LoRALinear) and m.lora_key is not None:
            shapes[m.lora_key + ".lora_a"] = (rank, m.in_features)
            shapes[m.lora_key + ".lora_b"] = (m.out_features, rank)
        elif isinstance(m, LoRAConv) and m.lora_key is not None:
            shapes[m.lora_key + ".lora_a"] = (rank, m.in_channels, *m.kernel_size)
            shapes[m.lora_key + ".lora_b"] = (m.out_channels, rank, 1, 1)
    return shapes


def init_lora(model: nn.Module, rank: int, generator: torch.Generator,
              device: torch.device) -> Dict[str, torch.Tensor]:
    """Zero-effect adapter: ``A ~ N(0, 1/r²)`` (the JAX init), ``B = 0``, fp32."""
    out = {}
    for key, shape in lora_shapes(model, rank).items():
        if key.endswith(".lora_a"):
            out[key] = torch.randn(shape, generator=generator, device=device) / rank
        else:
            out[key] = torch.zeros(shape, device=device)
    return out
