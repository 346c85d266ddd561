"""GroupNorm(+SiLU) over channels-last input: CUDA kernel
(`csrc/groupnorm.cu`) and its plain PyTorch version.

Counterpart of `pcm_tpu/ops/groupnorm.py`. Layout ``(N, *spatial, C)``: the
models keep NCHW tensors in ``torch.channels_last`` memory, so
``x.permute(0, 2, 3, 1)`` is the contiguous view this op takes. The backward
is autograd of the plain version on the saved inputs, as `_gn_bwd` is in the
JAX package (which has no backward kernel either).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from .common import (cdiv, check_cuda, count_launch, lib, require, stream_ptr, use_kernel,
                     vjp_of)

MAX_CHANNELS = 4096
_TARGET_BLOCKS = 1024  # stats-pass blocks over the whole batch (>= 7 per SM)


class GroupNormSiLUFn(torch.autograd.Function):
    """Forward: the K4 kernel (plain version on the CPU). Backward: autograd
    of `group_norm_silu_reference` (`pcm_tpu/ops/groupnorm.py:135-143`)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, num_groups, eps, act):
        ctx.save_for_backward(x, gamma, beta)
        ctx.args = (num_groups, eps, act)
        return group_norm_silu_fwd(x, gamma, beta, num_groups, eps, act)

    @staticmethod
    def backward(ctx, g):
        return (*vjp_of(group_norm_silu_reference, ctx.saved_tensors, ctx.args, g),
                None, None, None)


def group_norm_silu(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    num_groups: int = 32, eps: float = 1e-5,
                    act: Optional[str] = "silu") -> torch.Tensor:
    """GroupNorm over ``x`` (N, *spatial, C) with an optional SiLU;
    differentiable in x, gamma and beta."""
    require(act in (None, "silu"), f"unknown act {act!r}")
    return GroupNormSiLUFn.apply(x, gamma, beta, num_groups, eps, act)


def group_norm_silu_fwd(x, gamma, beta, num_groups=32, eps=1e-5, act="silu"):
    """The forward alone (not differentiable): K4 on CUDA tensors."""
    if not use_kernel(x, gamma, beta, name="group_norm_silu"):
        return group_norm_silu_reference(x, gamma, beta, num_groups, eps, act)

    n, c = x.shape[0], x.shape[-1]
    s = math.prod(x.shape[1:-1])
    require(x.dtype == gamma.dtype == beta.dtype == torch.bfloat16,
            f"group_norm_silu takes bf16, got {x.dtype}/{gamma.dtype}/{beta.dtype}")
    require(x.is_contiguous(), "group_norm_silu needs a contiguous channels-last tensor")
    require(gamma.shape == beta.shape == (c,), "gamma/beta must be (C,)")
    require(gamma.is_contiguous() and beta.is_contiguous(), "gamma/beta must be contiguous")
    require(c % 8 == 0 and c <= MAX_CHANNELS and c % num_groups == 0,
            f"C={c} must be a multiple of 8 and of groups={num_groups}, <= {MAX_CHANNELS}")
    for name, t in (("x", x), ("gamma", gamma), ("beta", beta)):
        require(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")
    rows_per_block = max(16, cdiv(s, max(1, _TARGET_BLOCKS // n)))
    nblk = cdiv(s, rows_per_block)
    scratch = torch.empty(2 * n * num_groups * (nblk + 1), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    err = lib().pcm_group_norm_silu(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        n, s, c, num_groups, int(act == "silu"), rows_per_block, float(eps),
        stream_ptr(x.device),
    )
    check_cuda(err, "group_norm_silu")
    count_launch("group_norm_silu")
    return out


def group_norm_silu_reference(x, gamma, beta, num_groups=32, eps=1e-5, act="silu"):
    """Plain version in fp32, two-pass variance (mirrors
    `pcm_tpu.ops.group_norm_silu_reference`)."""
    n, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(n, -1, num_groups, c // num_groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = xf.var(dim=(1, 3), keepdim=True, unbiased=False)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y.reshape(n, -1, c) * gamma.float() + beta.float()
    if act == "silu":
        y = F.silu(y)
    return y.reshape(x.shape).to(x.dtype)
