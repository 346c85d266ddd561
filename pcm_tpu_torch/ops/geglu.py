"""Fused GEGLU projection: CUDA kernel (`csrc/geglu.cu`) and its plain
PyTorch version.

Counterpart of `pcm_tpu/ops/geglu.py` (forward). The weight is the
``nn.Linear`` layout ``(2F, K)`` (value rows first, gate rows second), where
the JAX op took ``(K, 2F)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import check_cuda, count_launch, lib, require, stream_ptr, use_kernel


def geglu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x (..., K), w (2F, K), b (2F,) -> (x·Waᵀ + ba) · gelu(x·Wbᵀ + bb), (..., F)."""
    if not use_kernel(x, w, b):
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


def geglu_reference(x, w, b):
    """Plain version in fp32 with the exact erf gelu (mirrors
    `pcm_tpu.ops.geglu_reference`)."""
    h = F.linear(x.float(), w.float(), b.float())
    a, gate = h.chunk(2, dim=-1)
    return (a * F.gelu(gate)).to(x.dtype)
