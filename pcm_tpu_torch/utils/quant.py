"""Weight-only int8 storage of frozen weights, and the int8 compute paths.

Counterpart of `pcm_tpu/utils/quant.py`. `quantize_frozen` replaces the
large Linear and conv weights of a bundle's frozen modules (all but the VAE)
by symmetric per-output-channel int8 codes and fp32 scales, halving what
they hold on the card. A quantized module keeps the codes and scales as the
buffers ``weight_values`` and ``weight_scale`` (its ``weight`` becomes
None) and dequantizes at each use, unless an `int8_matmul` context (or, with
none set, the ``PCM_INT8_MATMUL`` environment variable) routes its product
through an int8 path:

  * ``dense``: every Linear base product as ``_qdot`` does: whole-row
    activation scales and an int8 x int8 -> int32 product (``torch._int_mm``
    on the card); convs dequantize;
  * ``conv``: every conv, spatial or pointwise, as ``_qconv`` does:
    per-sample activation scales and an int8 x int8 -> int32 conv
    (`QConvFn`); Linears dequantize;
  * ``both``: ``dense`` and ``conv`` together;
  * ``fused``: Linear products and pointwise (1x1, stride 1) convs through the
    K6 kernel (`ops/int8_matmul.py`), per-(row, K-tile) scales; spatial
    convs dequantize.

``conv`` and ``both`` are bisection modes, as in the JAX package, which
warns on entering them. Every path has the exact dequantized backward:
``dx`` only. The context is a contextvar: a remat recompute, which autograd
may run on another thread, gets the caller's mode handed over by the UNet
(`models/unet.py:_remat_contexts`).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
import warnings
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.int8_matmul import Int8MatmulFn, int_product, quantize_act

MODES = ("dense", "conv", "both", "fused")
# the dtype a `QTensor` stands for (`pcm_tpu/utils/quant.py:QTensor.logical_dtype`)
LOGICAL_DTYPE = torch.bfloat16


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
    (CLIP, T5). Those read a `QTensor` through ``__jax_array__``, which
    dequantizes to its logical dtype, bf16, before flax casts to the compute
    dtype; so does this layer."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        qt = self.qweight()
        w = self.weight if qt is None else qt.astype(LOGICAL_DTYPE).to(x.dtype)
        return F.linear(x, w, self.bias)


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
def mode_context(which: Optional[str]):
    """Set the int8 mode ``which`` for the block, None for none (which then
    holds against ``PCM_INT8_MATMUL`` too), without `int8_matmul`'s warning:
    a remat recompute re-enters the caller's mode this way."""
    if which is not None and which not in MODES:
        raise ValueError(which)
    tok = _INT8_MATMUL.set(which or False)
    try:
        yield
    finally:
        _INT8_MATMUL.reset(tok)


def int8_matmul(which: str = "both", enable: bool = True):
    """Within the context, quantized layers compute their base products on
    the int8 path ``which`` ("dense", "conv", "both" or "fused", see the
    module docstring); ``enable=False``: on none, whatever
    ``PCM_INT8_MATMUL`` says (`pcm_tpu/utils/quant.py:int8_matmul`)."""
    if which not in MODES:
        raise ValueError(which)
    if enable and which in ("conv", "both"):  # `pcm_tpu/utils/quant.py:169-182`
        warnings.warn(
            f"int8_matmul(which={which!r}) routes SPATIAL convs through the unfused int8 "
            "path, kept for bisection (the JAX package measured it 30x slower in full train "
            "graphs on the TPU); use 'dense' or 'fused' for real runs", stacklevel=2)
    return mode_context(which if enable else None)


def int8_mode() -> Optional[str]:
    """The active int8 mode: that of the innermost context (None in an
    ``enable=False`` one), else ``PCM_INT8_MATMUL`` ("1": "both"; a mode's
    name: that mode), else None (`pcm_tpu/utils/quant.py:_int8_mode`)."""
    mode = _INT8_MATMUL.get()
    if mode is None:
        env = os.environ.get("PCM_INT8_MATMUL", "0")
        mode = "both" if env == "1" else env if env in MODES else None
    return mode or None


def int8_matmul_enabled(kind: str = "dense") -> bool:
    """Is an int8 path active for the op class ``kind``, "dense" (Linears)
    or "conv" (`pcm_tpu/utils/quant.py:int8_matmul_enabled`)?"""
    mode = int8_mode()
    if kind == "dense":
        return mode in ("both", "dense", "fused")
    return mode in ("both", kind)


def dense_quantized_dot_fwd(x: torch.Tensor, values: torch.Tensor, scale: torch.Tensor
                            ) -> torch.Tensor:
    """`_qdot`'s forward: whole-row activation scales, int8 x int8 -> int32
    product (``torch._int_mm`` on the card), fp32 rescale, cast."""
    *lead, k = x.shape
    n = values.shape[0]
    xq, s = quantize_act(x.reshape(-1, k).float())
    y = _int_product(xq, values)
    return (y * s * scale.reshape(1, n).float()).to(x.dtype).reshape(*lead, n)


def _int_product(xq: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``xq (M, K) @ values (N, K)ᵀ`` of integer codes as fp32, each entry
    the exact integer rounded once. On the card ``torch._int_mm`` (int32),
    which takes more than 16 rows and K, N multiples of 8: zero rows and
    columns pad the operands (they add nothing); on the CPU the float64
    product."""
    if not xq.is_cuda:
        return int_product(xq, values)
    (m, k), n = xq.shape, values.shape[0]
    pk, pn = -k % 8, -n % 8
    xq8 = F.pad(xq, (0, pk, 0, max(0, 17 - m))).to(torch.int8)
    w8 = F.pad(values, (0, pk, 0, pn)) if pk or pn else values
    return torch._int_mm(xq8, w8.t())[:m, :n].float()


def quantized_dot(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """``x @ dequant(qt)ᵀ`` on the active int8 path (K6 under ``fused``,
    whole-row scales otherwise), in x's dtype, differentiable in x."""
    values, scale = qt.values.reshape(qt.shape[0], -1), qt.scale.reshape(-1)
    if int8_mode() == "fused":
        return Int8MatmulFn.apply(x, values, scale)
    return Int8MatmulFn.apply(x, values, scale, dense_quantized_dot_fwd)


def int8_conv_fwd(x: torch.Tensor, values: torch.Tensor, scale: torch.Tensor,
                  stride, padding) -> torch.Tensor:
    """`_qconv`'s forward on an NCHW ``x``: one activation scale a sample
    (over C, H, W), the exact integer conv of the codes with ``values`` (O,
    C, kh, kw), then ``(y · s) · scale`` in fp32 and one cast to x's dtype.
    The conv is an im2col product: `F.unfold` of the codes (integers up to
    127, exact in bf16) into (N · L, C · kh · kw) rows, the integer product
    (`_int_product`), folded back to (N, O, Ho, Wo) in channels-last memory."""
    n, _, h, w = x.shape
    o, c, kh, kw = values.shape
    (sh, sw), (ph, pw) = tuple(stride), tuple(padding)
    ho, wo = (h + 2 * ph - kh) // sh + 1, (w + 2 * pw - kw) // sw + 1
    xq, s = quantize_act(x.float(), (1, 2, 3))
    cols = F.unfold(xq if not xq.is_cuda else xq.to(torch.bfloat16), (kh, kw),
                    padding=(ph, pw), stride=(sh, sw))  # (N, C kh kw, L)
    rows = cols.transpose(1, 2).reshape(n * ho * wo, c * kh * kw)
    y = _int_product(rows, values.reshape(o, -1)).reshape(n, ho, wo, o)
    y = y * s.reshape(n, 1, 1, 1) * scale.reshape(1, 1, 1, o).float()
    return y.to(x.dtype).permute(0, 3, 1, 2)


class QConvFn(torch.autograd.Function):
    """``conv2d(x, dequant(values, scale))`` on the int8 conv path
    (`int8_conv_fwd`); backward: the conv's input gradient at the weight
    dequantized to x's dtype, for ``x`` only (`_qconv_bwd`)."""

    @staticmethod
    def forward(ctx, x, values, scale, stride, padding):
        ctx.save_for_backward(values, scale)
        ctx.shape, ctx.dtype, ctx.stride, ctx.padding = x.shape, x.dtype, stride, padding
        return int8_conv_fwd(x, values, scale, stride, padding)

    @staticmethod
    def backward(ctx, g):
        values, scale = ctx.saved_tensors
        w = (values.float() * scale.reshape(-1, 1, 1, 1).float()).to(ctx.dtype)
        dx = torch.nn.grad.conv2d_input(ctx.shape, w, g.to(ctx.dtype), ctx.stride, ctx.padding)
        return dx, None, None, None, None


def _conv_is_pointwise(weight_shape, stride, padding) -> bool:
    """True when the conv is exactly a per-pixel product: 1x1 kernel, stride
    1, no padding."""
    no_pad = padding in ("valid", "same") or tuple(padding) == (0, 0)
    return tuple(weight_shape[2:]) == (1, 1) and tuple(stride) == (1, 1) and no_pad


def quantized_conv(x: torch.Tensor, qt: QTensor, bias: Optional[torch.Tensor] = None,
                   stride=(1, 1), padding=(0, 0)) -> torch.Tensor:
    """NCHW conv with an int8 weight, routed as `_base_conv` and
    `quantized_conv` route it (`pcm_tpu/lora/layers.py:72-84`,
    `pcm_tpu/utils/quant.py:325-345`): under ``fused`` a pointwise conv is the
    K6 product over the (N·H·W, C) pixels, which a channels-last tensor gives
    without a copy, and a spatial one dequantizes; under ``conv`` and
    ``both`` every conv takes `QConvFn`; otherwise it dequantizes."""
    mode = int8_mode()
    if mode == "fused" and _conv_is_pointwise(qt.shape, stride, padding):
        y = quantized_dot(x.permute(0, 2, 3, 1), qt).permute(0, 3, 1, 2)
    elif mode in ("conv", "both"):
        y = QConvFn.apply(x, qt.values, qt.scale.reshape(-1), tuple(stride), tuple(padding))
    else:
        return F.conv2d(x, qt.astype(x.dtype), bias, stride, padding)
    return y if bias is None else y + bias[:, None, None]
