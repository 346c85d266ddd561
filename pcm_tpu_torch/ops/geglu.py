"""Fused GEGLU projection: CUDA kernel (`csrc/geglu.cu`) and its plain
PyTorch version.

Counterpart of `pcm_tpu/ops/geglu.py`. The weight is the ``nn.Linear``
layout ``(2F, K)`` (value rows first, gate rows second), where the JAX op
took ``(K, 2F)``. The backward is autograd of the plain version on the saved
inputs, as `_geglu_bwd` is in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from .common import cdiv, check_cuda, count_launch, lib, require, stream_ptr, use_kernel, vjp_of


class GEGLUFn(torch.autograd.Function):
    """Forward: the K5 kernel (plain version on the CPU). Backward: autograd
    of `geglu_reference` (`pcm_tpu/ops/geglu.py:133`)."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w, b)
        return geglu_fwd(x, w, b)

    @staticmethod
    def backward(ctx, g):
        return vjp_of(geglu_reference, ctx.saved_tensors, (), g)


def geglu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x (..., K), w (2F, K), b (2F,) -> (x·Waᵀ + ba) · gelu(x·Wbᵀ + bb), (..., F);
    differentiable in x, w and b."""
    return GEGLUFn.apply(x, w, b)


def geglu_fwd(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The forward alone (not differentiable): K5 on CUDA tensors."""
    if not use_kernel(x, w, b, name="geglu"):
        return geglu_reference(x, w, b)

    k = x.shape[-1]
    two_f = w.shape[0]
    f = two_f // 2
    require(x.dtype == w.dtype == b.dtype == torch.bfloat16,
            f"geglu takes bf16, got {x.dtype}/{w.dtype}/{b.dtype}")
    require(w.shape == (two_f, k) and two_f % 2 == 0 and b.shape == (two_f,),
            f"shape mismatch x{tuple(x.shape)} w{tuple(w.shape)} b{tuple(b.shape)}")
    require(k % 8 == 0 and f % 8 == 0, f"K={k} and F={f} must be multiples of 8")
    require(x.is_contiguous() and w.is_contiguous() and b.is_contiguous(),
            "geglu needs contiguous x, w and b")
    for name, t in (("x", x), ("w", w), ("b", b)):
        require(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")
    m = x.numel() // k
    out = torch.empty((*x.shape[:-1], f), dtype=x.dtype, device=x.device)
    err = lib().pcm_geglu(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                          m, k, f, stream_ptr(x.device))
    check_cuda(err, "geglu")
    count_launch("geglu")
    return out


class GegluTiles(NamedTuple):
    block_m: int            # rows of a tile (two 64-row warpgroups)
    block_n: int            # value columns of a tile, and as many gate columns
    block_k: int            # K columns of a pipeline stage
    k_steps: int            # stages of a tile
    grid: Tuple[int, int]   # (N tiles, M tiles), walked N fastest


def geglu_tiles(m: int, k: int, f: int) -> GegluTiles:
    """K5's tiles at ``(M, K, F)``, as `csrc/geglu.cu` walks them: one
    persistent block an SM takes tile after tile, N fastest."""
    return GegluTiles(128, 128, 64, cdiv(k, 64), (cdiv(f, 128), cdiv(m, 128)))


def geglu_reference(x, w, b):
    """Plain version in fp32 with the exact erf gelu (mirrors
    `pcm_tpu.ops.geglu_reference`)."""
    h = F.linear(x.float(), w.float(), b.float())
    a, gate = h.chunk(2, dim=-1)
    return (a * F.gelu(gate)).to(x.dtype)
