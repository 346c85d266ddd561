"""GroupNorm(+SiLU) over channels-last input: CUDA kernel
(`csrc/groupnorm.cu`, bf16 or fp32) and its plain PyTorch version.

Counterpart of `pcm_tpu/ops/groupnorm.py`. Layout ``(N, *spatial, C)``: the
models keep NCHW tensors in ``torch.channels_last`` memory, so
``x.permute(0, 2, 3, 1)`` is the contiguous view this op takes. The backward
is autograd of the plain version on the saved inputs, as `_gn_bwd` is in the
JAX package (which has no backward kernel either).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .common import (H100_SMS, cdiv, check_cuda, count_launch, lib, require, sm_count,
                     stream_ptr, use_kernel, vjp_of)

MAX_LANES = 512  # 16-byte vectors a row: C <= 4096 in bf16, 2048 in fp32
_ELEM_SIZE = {torch.bfloat16: 2, torch.float32: 4}  # the kernel's element types
# rows a thread walks at the least: one sweep of the stats pass's 8 loads in
# flight (`kStatsUnroll`); it sizes the grid only, the sums do not depend on it
_MIN_ROWS_A_PHASE = 8
_ROW_THREADS = 256  # threads a block spreads over its row phases (`gn_lanes` a phase)
_BLOCKS_PER_SM = 2  # blocks of one pass an SM, over the whole batch


class GNPartition(NamedTuple):
    rs: int              # row phases of a block: blockDim = rs * lanes, rounded up to a warp
    rows_per_chunk: int  # rows of a block (both passes): a multiple of rs
    nchunk: int          # blocks a sample
    seg_chan: int        # lanes merging a group's channels (stats pass)
    seg_chunk: int       # lanes merging a group's chunk partials (normalize pass)


def gn_lanes(c: int, elem_size: int = 2) -> int:
    """The threads of one row phase: 16-byte vectors a row of ``c`` channels
    of ``elem_size`` bytes (C/8 in bf16, C/4 in fp32), a launch argument."""
    return c * elem_size // 16


def gn_partition(n: int, s: int, c: int, groups: int, sms: int = H100_SMS,
                 elem_size: int = 2) -> GNPartition:
    """K4's grid, as both its launches take it: (nchunk, n) blocks of
    ``rows_per_chunk`` rows, about `_BLOCKS_PER_SM` an SM over the batch,
    each at least one unrolled sweep of its row phases; ``elem_size`` is 2
    for bf16 input, 4 for fp32."""
    lanes = gn_lanes(c, elem_size)
    rs = max(1, _ROW_THREADS // lanes)
    rows = cdiv(cdiv(s, cdiv(sms * _BLOCKS_PER_SM, n)), rs) * rs
    return _gn_grid(s, c, lanes, groups, rs, max(rs * _MIN_ROWS_A_PHASE, rows))


def _gn_grid(s: int, c: int, lanes: int, groups: int, rs: int, rows: int) -> GNPartition:
    """The partition of chunks of ``rows`` rows, with the merge segments'
    widths that `_seg_width` picks for a block of ``rs`` row phases."""
    nchunk, warps = cdiv(s, rows), cdiv(lanes * rs, 32)
    return GNPartition(rs, rows, nchunk, _seg_width(c // groups, groups, warps),
                       _seg_width(nchunk, groups, warps))


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
        return (*vjp_of(group_norm_silu_reference, ctx.saved_tensors, ctx.args, g,
                        ctx.needs_input_grad[:3]), None, None, None)


def group_norm_silu(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    num_groups: int = 32, eps: float = 1e-5,
                    act: Optional[str] = "silu") -> torch.Tensor:
    """GroupNorm over ``x`` (N, *spatial, C) with an optional SiLU;
    differentiable in x, gamma and beta."""
    require(act in (None, "silu"), f"unknown act {act!r}")
    return GroupNormSiLUFn.apply(x, gamma, beta, num_groups, eps, act)


def group_norm_silu_fwd(x, gamma, beta, num_groups=32, eps=1e-5, act="silu"):
    """The forward alone (not differentiable): K4 on CUDA tensors of bf16 or
    fp32 (x, gamma and beta of one type)."""
    if not use_kernel(x, gamma, beta, name="group_norm_silu"):
        return group_norm_silu_reference(x, gamma, beta, num_groups, eps, act)

    n, c = x.shape[0], x.shape[-1]
    s = math.prod(x.shape[1:-1])
    require(x.dtype == gamma.dtype == beta.dtype and x.dtype in _ELEM_SIZE,
            f"group_norm_silu takes bf16 or fp32, one type for x, gamma and beta; got "
            f"{x.dtype}/{gamma.dtype}/{beta.dtype}")
    elem = _ELEM_SIZE[x.dtype]
    lanes = gn_lanes(c, elem)
    require(x.is_contiguous(), "group_norm_silu needs a contiguous channels-last tensor")
    require(gamma.shape == beta.shape == (c,), "gamma/beta must be (C,)")
    require(gamma.is_contiguous() and beta.is_contiguous(), "gamma/beta must be contiguous")
    require(c * elem % 16 == 0 and lanes <= MAX_LANES and c % num_groups == 0,
            f"C={c} must be a multiple of {16 // elem} (whole 16-byte vectors) and of "
            f"groups={num_groups}, <= {MAX_LANES * 16 // elem} in {x.dtype}")
    require(n <= 65535 and s * c < 2**31, "group_norm_silu takes N <= 65535 and S*C < 2^31")
    for name, t in (("x", x), ("gamma", gamma), ("beta", beta)):
        require(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")
    part = gn_partition(n, s, c, num_groups, sm_count(x.device), elem)
    # one (mean, M2) per (sample, group, chunk), written by the stats pass
    scratch = torch.empty(2 * n * num_groups * part.nchunk, dtype=torch.float32, device=x.device)
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    err = lib().pcm_group_norm_silu(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        elem, n, s, c, lanes, num_groups, int(act == "silu"), part.rows_per_chunk, part.rs,
        part.seg_chan, part.seg_chunk, float(eps), stream_ptr(x.device),
    )
    check_cuda(err, "group_norm_silu")
    count_launch("group_norm_silu" if elem == 2 else "group_norm_silu_fp32")
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


def _chan_merge(na, ma, Ma, nb, mb, Mb):
    """Chan's merge of (count, mean, M2) partials b into a, elementwise, as
    `chan_merge` in csrc/groupnorm.cu; an empty b leaves a as it is."""
    cnt = na + nb
    w = nb / torch.where(cnt > 0, cnt, torch.ones_like(cnt))
    delta = mb - ma
    m = ma + delta * w
    M = Ma + (Mb + delta * delta * (na * w))
    empty = nb == 0
    return torch.where(empty, na, cnt), torch.where(empty, ma, m), torch.where(empty, Ma, M)


def _seg_width(k: int, groups: int, warps: int) -> int:
    """The lanes (a power of two <= 32) a warp segment of the kernel gives
    one group's ``k`` partials when ``warps`` warps merge ``groups`` groups,
    32 / width at once each: the shortest chain of merges (passes, times
    partials a lane merges in turn plus tree steps), the first of equals."""
    costs = [(cdiv(groups, warps * (32 >> e)) * (cdiv(k, 1 << e) + e), 1 << e) for e in range(6)]
    return min(costs, key=lambda t: t[0])[1]


def _seg_merge(cnt, mean, m2, width: int):
    """The kernel's merge of k partials (the last axis) in a warp segment of
    ``width`` lanes: lane l merges entries l, l + width, ... in order, then
    lane i takes lane i + width / 2, i + width / 4, ..., 1; lane 0's
    (count, mean, M2)."""
    k = mean.shape[-1]
    rounds = cdiv(k, width)
    cnt, mean, m2 = (F.pad(t.expand_as(mean), (0, rounds * width - k)).unflatten(-1, (rounds, width))
                     for t in (cnt, mean, m2))
    acc = [torch.zeros_like(mean[..., 0, :]) for _ in range(3)]
    for i in range(rounds):
        acc = _chan_merge(*acc, cnt[..., i, :], mean[..., i, :], m2[..., i, :])
    off = width // 2
    while off:
        low = _chan_merge(*(t[..., :off] for t in acc), *(t[..., off:2 * off] for t in acc))
        acc = [torch.cat([lo, t[..., off:]], -1) for lo, t in zip(low, acc)]
        off //= 2
    return tuple(t[..., 0] for t in acc)


def group_norm_stats_chunked(x, num_groups=32, eps=1e-5, rows_per_chunk=None, elem_size=2):
    """Mean and rstd per (sample, group), (N, G) fp32, merged as K4 merges
    them (csrc/groupnorm.cu, plain version for the tests) on input of
    ``elem_size``-byte elements (2: bf16, 4: fp32): per chunk of
    `gn_partition`'s rows (or ``rows_per_chunk``, a multiple of its ``rs``),
    each (row phase, channel) thread's sums shifted by its first value, the
    row phases merged in order per channel with Chan's formula, then the
    group's channels and last the sample's chunks, each by `_seg_merge` with
    the partition's widths."""
    n, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(n, -1, c)
    s = xf.shape[1]
    part = gn_partition(n, s, c, num_groups, elem_size=elem_size)
    if rows_per_chunk:
        require(rows_per_chunk % part.rs == 0,
                f"rows_per_chunk {rows_per_chunk} is not a multiple of rs = {part.rs}")
        part = _gn_grid(s, c, gn_lanes(c, elem_size), num_groups, part.rs, rows_per_chunk)
    rs, rows, nchunk = part.rs, part.rows_per_chunk, part.nchunk
    # thread (chunk j, phase r) reads rows j * rows + r + k * rs, k = 0, 1, ...
    xp = F.pad(xf, (0, 0, 0, nchunk * rows - s)).reshape(n, nchunk, rows // rs, rs, c)
    valid = (torch.arange(nchunk * rows) < s).reshape(1, nchunk, rows // rs, rs, 1)
    shift = xp[:, :, :1]
    cnt = valid.sum(2).float()  # (1, nchunk, rs, 1)
    d = torch.where(valid, xp - shift, 0.0)
    s1, s2 = d.sum(2), (d * d).sum(2)
    inv = 1.0 / cnt.clamp_min(1.0)
    mean_t = torch.where(cnt > 0, shift[:, :, 0] + s1 * inv, 0.0)
    m2_t = torch.where(cnt > 0, (s2 - s1 * s1 * inv).clamp_min(0.0), 0.0)
    acc = [torch.zeros((n, nchunk, c)) for _ in range(3)]
    for r in range(rs):
        acc = _chan_merge(*acc, cnt[:, :, r], mean_t[:, :, r], m2_t[:, :, r])
    cg = c // num_groups
    cnt_c, mean_c, m2_c = (t.reshape(n, nchunk, num_groups, cg) for t in acc)
    _, mean_j, m2_j = _seg_merge(cnt_c, mean_c, m2_c, part.seg_chan)
    cnt_j = cnt_c[..., 0] * cg  # (n, nchunk, G)
    cnt_g, mean, m2 = _seg_merge(*(t.transpose(1, 2) for t in (cnt_j, mean_j, m2_j)),
                                 part.seg_chunk)
    return mean, torch.rsqrt(m2 / cnt_g + eps)
