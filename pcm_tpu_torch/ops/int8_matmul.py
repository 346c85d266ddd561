"""Fused int8 matmul: CUDA kernels (`csrc/int8_matmul.cu`) and their plain
PyTorch versions.

Counterpart of `pcm_tpu/ops/int8_matmul.py`: ``x @ dequant(values, scale)ᵀ``
with the activations quantized per (row, K-tile). On the card one call runs
two kernels: a quantize pass that writes the codes and the scales of every
(row, K-tile) once (`quantize_tiles_reference` is its plain version), and
the int8 product that reads them. The
weight is the ``nn.Linear`` layout ``(N, K)`` int8 with one fp32 scale per
output row, where the JAX op took ``(K, N)`` and ``(1, N)``; the codes are
the same. The K-tile ``bk = pick_block(K, 512, 128)`` belongs to the
function (it sets where the activation scales change), so the kernel and the
plain version both use it. The output has x's dtype. The backward of every
int8 product (this one and `utils/quant.py`'s ``dense``) is the exact
dequantized product ``dx = g · dequant(W)`` (`pcm_tpu/utils/quant.py:_qdot_bwd`);
the int8 weight and its scale get no gradient.
"""

from __future__ import annotations

import numpy as np
import torch

from .common import check_cuda, count_launch, lib, require, stream_ptr, use_kernel

BLOCK_K = 512  # the JAX op's block_k: the largest K-tile
# XLA compiles the JAX kernel's `amax / 127.0` into a product with the fp32
# reciprocal of 127 (in every jitted graph), so an activation scale is
# amax * fl(1/127); the kernel uses the same constant (0x1.020408p-7f)
RECIP_127 = float(np.float32(1.0 / 127.0))


def pick_block(dim: int, target: int, quantum: int) -> int:
    """Largest multiple of ``quantum`` that divides ``dim`` and is <= ``target``
    (``dim`` itself when it is small or has no such divisor);
    `pcm_tpu/ops/int8_matmul.py:_pick_block`."""
    if dim <= target:
        return dim
    b = (target // quantum) * quantum
    while b >= quantum:
        if dim % b == 0:
            return b
        b -= quantum
    return dim


def quantize_rows(x32: torch.Tensor):
    """Symmetric int8 codes of fp32 rows, one scale per row: ``(codes as
    fp32, scale (rows, 1))``, s = max|x| · fl(1/127) (1 for an all-zero
    row), codes = clip(round(x / s), ±127) with an IEEE division (a tensor
    divisor) and round half to even."""
    amax = x32.abs().amax(dim=-1, keepdim=True)
    s = torch.where(amax > 0, amax * RECIP_127, torch.ones_like(amax))
    return torch.clamp(torch.round(x32 / s), -127, 127), s


def quantize_tiles_reference(x: torch.Tensor, bk: int):
    """Plain version of the quantize pass: the int8 codes ``(M, K)`` of every
    (row, K-tile of ``bk``) of ``x (M, K)`` and their fp32 scales laid out
    ``(K / bk, M)``, as `quantize_rows` gives them tile by tile."""
    m, k = x.shape
    codes = torch.empty((m, k), dtype=torch.int8, device=x.device)
    scales = torch.empty((k // bk, m), dtype=torch.float32, device=x.device)
    for t, k0 in enumerate(range(0, k, bk)):
        xq, s = quantize_rows(x[:, k0:k0 + bk].float())
        codes[:, k0:k0 + bk] = xq.to(torch.int8)
        scales[t] = s.reshape(m)
    return codes, scales


def int_product(xq: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``xq @ valuesᵀ`` of integer-valued tensors as fp32, each entry the
    exact integer rounded once to fp32, as an int32 product cast to fp32 is
    (the sum is exact in float64 for any K a model has)."""
    return (xq.double() @ values.double().t()).float()


def fused_quantized_dot_reference(x: torch.Tensor, values: torch.Tensor, scale: torch.Tensor
                                  ) -> torch.Tensor:
    """Plain version of the kernel: for each K-tile in order, quantize the
    rows of ``x`` with their own scale ``s``, take the exact integer product
    with the weight codes and add ``part * s`` to an fp32 sum; scale by the
    weight's per-row ``scale`` and cast."""
    *lead, k = x.shape
    n = values.shape[0]
    x2 = x.reshape(-1, k).float()
    bk = pick_block(k, BLOCK_K, 128)
    acc = torch.zeros((x2.shape[0], n), dtype=torch.float32, device=x.device)
    for k0 in range(0, k, bk):
        xq, s = quantize_rows(x2[:, k0:k0 + bk])
        acc = acc + int_product(xq, values[:, k0:k0 + bk]) * s
    return (acc * scale.reshape(1, n).float()).to(x.dtype).reshape(*lead, n)


def fused_quantized_dot_fwd(x: torch.Tensor, values: torch.Tensor, scale: torch.Tensor
                            ) -> torch.Tensor:
    """The forward alone (not differentiable): K6 on CUDA tensors, its two
    kernels counted as one launch; the codes and scales are scratch of this
    call (M K bytes and 4 M K / bk)."""
    if not use_kernel(x, values, scale, name="int8_matmul"):
        return fused_quantized_dot_reference(x, values, scale)

    *lead, k = x.shape
    n = values.shape[0]
    bk = pick_block(k, BLOCK_K, 128)
    require(x.dtype == torch.bfloat16, f"int8_matmul takes bf16 activations, got {x.dtype}")
    require(values.dtype == torch.int8 and values.shape == (n, k),
            f"weight codes must be int8 (N, {k}), got {values.dtype} {tuple(values.shape)}")
    require(scale.dtype == torch.float32 and scale.numel() == n,
            f"weight scale must be fp32 with {n} entries, got {scale.dtype} {tuple(scale.shape)}")
    require(bk % 32 == 0 and bk <= 1024,
            f"K={k} gives a K-tile of {bk}; the kernel takes multiples of 32 up to 1024")
    require(n % 8 == 0, f"N={n} must be a multiple of 8")
    x2 = x.reshape(-1, k).contiguous()
    values = values.contiguous()
    scale = scale.reshape(n).contiguous()
    for name, t in (("x", x2), ("weight codes", values), ("weight scale", scale)):
        require(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    if m:
        codes = torch.empty((m, k), dtype=torch.int8, device=x.device)
        scales = torch.empty((k // bk, m), dtype=torch.float32, device=x.device)
        err = lib().pcm_int8_matmul(x2.data_ptr(), values.data_ptr(), scale.data_ptr(),
                                    out.data_ptr(), codes.data_ptr(), scales.data_ptr(),
                                    m, n, k, bk, stream_ptr(x.device))
        check_cuda(err, "int8_matmul")
        count_launch("int8_matmul")
    return out.reshape(*lead, n)


def dequantized_dx(g: torch.Tensor, values: torch.Tensor, scale: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    """``g · dequant(W)`` in ``dtype``: the input gradient of every int8
    product, exact for the dequantized weight (`_qdot_bwd`)."""
    w = (values.float() * scale.reshape(-1, 1).float()).to(dtype)
    return g.to(dtype) @ w


class Int8MatmulFn(torch.autograd.Function):
    """Forward: ``forward_fn(x, values, scale)``, an int8 product (K6 by
    default). Backward: the dequantized product, for ``x`` only."""

    @staticmethod
    def forward(ctx, x, values, scale, forward_fn=fused_quantized_dot_fwd):
        ctx.save_for_backward(values, scale)
        ctx.dtype = x.dtype
        return forward_fn(x, values, scale)

    @staticmethod
    def backward(ctx, g):
        values, scale = ctx.saved_tensors
        return dequantized_dx(g, values, scale, ctx.dtype), None, None, None


def fused_quantized_dot(x: torch.Tensor, values: torch.Tensor, scale: torch.Tensor
                        ) -> torch.Tensor:
    """x (..., K) @ dequant(values (N, K) int8, scale (N,) fp32)ᵀ -> (..., N)
    in x's dtype; differentiable in x."""
    return Int8MatmulFn.apply(x, values, scale)
