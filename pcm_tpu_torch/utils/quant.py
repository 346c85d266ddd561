"""Weight-only int8 storage of frozen weights, and the int8 compute paths.

Counterpart of `pcm_tpu/utils/quant.py`. `quantize_frozen` replaces the
large Linear and conv weights of a bundle's frozen modules (all but the VAE)
by symmetric per-output-channel int8 codes and fp32 scales, halving what
they hold on the card. A quantized module keeps the codes and scales as the
buffers ``weight_values`` and ``weight_scale`` (its ``weight`` becomes
None) and dequantizes at each use, unless an `int8_matmul` context routes
its product through an int8 path:

  * ``dense``: every Linear base product as ``_qdot`` does: whole-row
    activation scales and an int8 x int8 -> int32 product (``torch._int_mm``
    on the card); convs dequantize;
  * ``fused``: Linear products and pointwise (1x1, stride 1) convs through the
    K6 kernel (`ops/int8_matmul.py`), per-(row, K-tile) scales; spatial
    convs dequantize.

Both share the exact dequantized backward: ``dx`` only. The JAX package's
``conv`` and ``both`` modes (int8 spatial convs, kept there for bisection)
are not ported. The context is a contextvar: a remat recompute, which
autograd may run on another thread, gets the caller's mode handed over by
the UNet (`models/unet.py:_remat_contexts`).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.int8_matmul import Int8MatmulFn, int_product, quantize_rows

MODES = ("dense", "fused")
NOT_PORTED_MODES = ("conv", "both")


@dataclasses.dataclass(frozen=True)
class QTensor:
    """Symmetric per-output-channel int8 weight, ``w ≈ values * scale``:
    ``values`` int8 in the float weight's layout, ``scale`` fp32 with the
    output axis (0) kept and every other axis 1."""

    values: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self):
        return self.values.shape

    def astype(self, dtype) -> torch.Tensor:
        """Dequantize in fp32, then cast once (`pcm_tpu/utils/quant.py:69-72`)."""
        return (self.values.float() * self.scale).to(dtype)


def quantize(w: torch.Tensor) -> QTensor:
    """Per-output-channel symmetric int8 codes of a torch-layout weight
    (Linear ``(out, in)``, conv ``(O, I, kh, kw)``): every axis but 0 is
    reduced. The codes equal those of `pcm_tpu.utils.quant.quantize` on the
    transposed JAX kernel (both round half to even)."""
    w32 = w.detach().float()
    amax = w32.abs().amax(dim=tuple(range(1, w32.ndim)), keepdim=True)
    # an IEEE division, as JAX's eager `quantize` does: the divisor is a
    # tensor (on the card PyTorch divides by a Python scalar through its
    # reciprocal)
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0), torch.ones_like(amax))
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return QTensor(q, scale)


class QuantizableWeight:
    """Mixin of the port's Linear and conv layers: the weight is either the
    float parameter ``weight`` or, once quantized, the int8 buffer
    ``weight_values`` with the fp32 buffer ``weight_scale``."""

    def qweight(self) -> Optional[QTensor]:
        values = self._buffers.get("weight_values")
        return None if values is None else QTensor(values, self._buffers["weight_scale"])

    def set_qweight(self, qt: QTensor) -> None:
        self.register_parameter("weight", None)
        self.register_buffer("weight_values", qt.values)
        self.register_buffer("weight_scale", qt.scale)

    def dense_weight(self, dtype: torch.dtype) -> torch.Tensor:
        """The float weight, or the quantized one dequantized to ``dtype``."""
        qt = self.qweight()
        return self.weight if qt is None else qt.astype(dtype)


class DequantLinear(QuantizableWeight, nn.Linear):
    """``nn.Linear`` that dequantizes an int8 weight at each use and never
    takes an int8 product: the stock ``nn.Dense`` layers of the JAX package
    (CLIP), which consume a `QTensor` through ``__jax_array__``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.dense_weight(x.dtype), self.bias)


def default_predicate(module: nn.Module, min_size: int = 65536) -> bool:
    """Quantize Linear and conv weights (ndim 2 or 4) of at least
    ``min_size`` elements; biases, norms and embeddings stay in float."""
    w = getattr(module, "weight", None)
    return (isinstance(module, QuantizableWeight) and isinstance(w, torch.Tensor)
            and w.ndim in (2, 4) and w.numel() >= min_size)


def quantize_module(module: nn.Module, min_size: int = 65536) -> nn.Module:
    """Quantize in place every layer of ``module`` that `default_predicate`
    selects at ``min_size``."""
    for sub in module.modules():
        if default_predicate(sub, min_size):
            sub.set_qweight(quantize(sub.weight))
    return module


def quantize_frozen(frozen: Dict[str, nn.Module], skip=("vae",),
                    min_size: int = 65536) -> Dict[str, nn.Module]:
    """Quantize a bundle's frozen modules in place, all but ``skip``'d ones
    (default: the VAE, quality-sensitive and small), and return the dict."""
    for name, module in frozen.items():
        if name not in skip:
            quantize_module(module, min_size)
    return frozen


def quantized_bytes_saved(frozen: Dict[str, nn.Module]) -> int:
    """Bytes of device memory saved against bf16 storage."""
    saved = 0
    for module in frozen.values():
        for sub in module.modules():
            qt = sub.qweight() if isinstance(sub, QuantizableWeight) else None
            if qt is not None:
                saved += qt.values.numel() - qt.scale.numel() * 4
    return saved


# ---------------------------------------------------------------------------
# int8 compute paths
# ---------------------------------------------------------------------------

_INT8_MATMUL = contextvars.ContextVar("pcm_torch_int8_matmul", default=None)


@contextlib.contextmanager
def int8_matmul(which: str):
    """Within the context, quantized layers compute their base products on
    the int8 path ``which`` ("dense" or "fused", see the module docstring)."""
    if which in NOT_PORTED_MODES:
        raise NotImplementedError(
            f"int8_matmul(which={which!r}) (int8 spatial convs) is not yet ported to "
            "pcm_tpu_torch: use 'dense' or 'fused'")
    if which not in MODES:
        raise ValueError(which)
    tok = _INT8_MATMUL.set(which)
    try:
        yield
    finally:
        _INT8_MATMUL.reset(tok)


def int8_mode() -> Optional[str]:
    """The active int8 mode: "dense", "fused" or None."""
    return _INT8_MATMUL.get()


def dense_quantized_dot_fwd(x: torch.Tensor, values: torch.Tensor, scale: torch.Tensor
                            ) -> torch.Tensor:
    """`_qdot`'s forward: whole-row activation scales, int8 x int8 -> int32
    product (``torch._int_mm`` on the card, which takes more than 16 rows:
    fewer are padded with zero rows), fp32 rescale, cast."""
    *lead, k = x.shape
    n = values.shape[0]
    xq, s = quantize_rows(x.reshape(-1, k).float())
    if x.is_cuda:
        m = xq.shape[0]
        xq8 = F.pad(xq, (0, 0, 0, max(0, 17 - m))).to(torch.int8)
        y = torch._int_mm(xq8, values.t())[:m].float()
    else:
        y = int_product(xq, values)
    return (y * s * scale.reshape(1, n).float()).to(x.dtype).reshape(*lead, n)


def quantized_dot(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """``x @ dequant(qt)ᵀ`` on the active int8 path (K6 under ``fused``),
    in x's dtype, differentiable in x."""
    values, scale = qt.values.reshape(qt.shape[0], -1), qt.scale.reshape(-1)
    if int8_mode() == "fused":
        return Int8MatmulFn.apply(x, values, scale)
    return Int8MatmulFn.apply(x, values, scale, dense_quantized_dot_fwd)


def _conv_is_pointwise(weight_shape, stride, padding) -> bool:
    """True when the conv is exactly a per-pixel product: 1x1 kernel, stride
    1, no padding."""
    no_pad = padding in ("valid", "same") or tuple(padding) == (0, 0)
    return tuple(weight_shape[2:]) == (1, 1) and tuple(stride) == (1, 1) and no_pad


def quantized_conv(x: torch.Tensor, qt: QTensor, bias: Optional[torch.Tensor] = None,
                   stride=(1, 1), padding=(0, 0)) -> torch.Tensor:
    """NCHW conv with an int8 weight. Under ``fused`` a pointwise conv is the
    K6 product over the (N·H·W, C) pixels, which a channels-last tensor gives
    without a copy; any other conv dequantizes."""
    if int8_mode() == "fused" and _conv_is_pointwise(qt.shape, stride, padding):
        y = quantized_dot(x.permute(0, 2, 3, 1), qt).permute(0, 3, 1, 2)
        return y if bias is None else y + bias[:, None, None]
    return F.conv2d(x, qt.astype(x.dtype), bias, stride, padding)
