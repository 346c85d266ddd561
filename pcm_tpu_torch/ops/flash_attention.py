"""Flash attention forward: CUDA kernel (`csrc/flash_attention.cu`) and its
plain PyTorch version.

Counterpart of `pcm_tpu/ops/flash_attention.py` (forward only; the dK/dV and
dQ kernels come with the training slice). Public layout is the projection
layout ``(batch, seq, heads, head_dim)``; the kernel reads it through its
strides, so no transpose is materialized. SD1.5 runs head_dim 40/80/160 in
the UNet and a single 512-wide head in the VAE mid-block.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .common import check_cuda, count_launch, lib, require, stream_ptr, use_kernel

LOG2E = 1.4426950408889634  # exp(x) == exp2(x * LOG2E)
MAX_HEAD_DIM = 512


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q kᵀ · scale) v over ``(b, s, h, d)``; returns q's dtype."""
    return flash_attention_fwd(q, k, v, sm_scale)[0]


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        sm_scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(o, lse)``: ``o`` as `flash_attention`, ``lse`` the base-2
    logsumexp of the scaled scores, fp32 ``(b, h, sq)`` (the residual the
    backward kernels will consume)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if not use_kernel(q, k, v):
        return attention_reference(q, k, v, sm_scale), attention_lse_reference(q, k, sm_scale)

    b, sq, h, d = q.shape
    sk = k.shape[1]
    require(q.dtype == k.dtype == v.dtype == torch.bfloat16,
            f"flash attention takes bf16, got {q.dtype}/{k.dtype}/{v.dtype}")
    require(k.shape == v.shape == (b, sk, h, d),
            f"shape mismatch q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    require(d % 8 == 0 and d <= MAX_HEAD_DIM, f"head_dim {d} must be a multiple of 8 <= 512")
    for name, t in (("q", q), ("k", k), ("v", v)):
        require(t.stride(3) == 1, f"{name} needs unit stride along head_dim")
        require(all(s % 8 == 0 for s in t.stride()[:3]),
                f"{name} strides {t.stride()} must be multiples of 8")
        require(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    err = lib().pcm_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b, h, sq, sk, d,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        ctypes.c_float(sm_scale * LOG2E), stream_ptr(q.device),
    )
    check_cuda(err, "flash_attention_fwd")
    count_launch("flash_attention_fwd")
    return o, lse


def attention_reference(q, k, v, sm_scale=None):
    """Plain attention in fp32 (mirrors `pcm_tpu.ops.attention_reference`)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    p = torch.softmax(s * sm_scale, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def attention_lse_reference(q, k, sm_scale=None):
    """Base-2 logsumexp of the scaled scores, fp32 ``(b, h, sq)``."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    return torch.logsumexp(s, dim=-1) * LOG2E
