"""Flash attention, forward and backward: CUDA kernels
(`csrc/flash_attention.cu`, `csrc/flash_attention_bwd.cu`) and their plain
PyTorch versions, joined by one `torch.autograd.Function`.

Counterpart of `pcm_tpu/ops/flash_attention.py`: the forward saves ``o`` and
the base-2 logsumexp, and the backward recomputes the probabilities from them
in a dK/dV kernel and a dQ kernel, with ``delta = rowsum(dO * O)`` computed
between the two passes in plain torch (as `_bwd` does in XLA). Public layout
is the projection layout ``(batch, seq, heads, head_dim)``; the kernels read
it through its strides, so no transpose is materialized. SD1.5 runs head_dim
40/80/160 in the UNet (forward and backward) and a single 512-wide head in
the VAE mid-block (forward only).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from .common import (FLASH_FWD_OP, H100_SMS, cdiv, check_cuda, count_launch, lib, require,
                     sm_count, stream_ptr, use_kernel)

LOG2E = 1.4426950408889634  # exp(x) == exp2(x * LOG2E)
MAX_HEAD_DIM = 512
MAX_HEAD_DIM_BWD = 160


class FlashAttentionFn(torch.autograd.Function):
    """softmax(q kᵀ · scale) v with the flash backward (the port of the JAX
    custom VJP, `pcm_tpu/ops/flash_attention.py:382-402`). The same Function
    runs on both devices: kernels on CUDA tensors, plain versions on CPU ones.
    The forward records the choice of K2 and K3, each by its own name:
    autograd runs the backward on another thread, where a ``reference_ops()``
    context of the caller is not set. K1 runs as the op `flash_fwd`, which a
    remat policy sees (``+fa`` keeps its ``(o, lse)``, as JAX's
    ``checkpoint_name`` of ``fa_out`` / ``fa_lse``), so that the recompute of
    a checkpointed block then takes them from the forward and launches no K1."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale):
        o, lse = flash_fwd(q, k, v, float(sm_scale))
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.sm_scale, ctx.bwd_kernels = sm_scale, bwd_kernel_choice(q, k, v)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.sm_scale, ctx.bwd_kernels)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q kᵀ · scale) v over ``(b, s, h, d)``; returns q's dtype and
    is differentiable in q, k and v."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    return FlashAttentionFn.apply(q, k, v, sm_scale)


@torch.library.custom_op(FLASH_FWD_OP, mutates_args=())
def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              sm_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """`flash_attention_fwd` as one op of the dispatcher: K1's launch, or its
    plain version, is one call that a remat policy can keep."""
    return flash_attention_fwd(q, k, v, sm_scale)


@flash_fwd.register_fake
def _flash_fwd_fake(q, k, v, sm_scale):
    b, sq, h, _ = q.shape
    return q.new_empty(q.shape), q.new_empty((b, h, sq), dtype=torch.float32)


def _kernel_layout(t: torch.Tensor) -> bool:
    """Whether the kernels can read ``t`` through its ``(b, s, h)`` strides."""
    return (t.stride(3) == 1 and all(s % 8 == 0 for s in t.stride()[:3])
            and t.data_ptr() % 16 == 0)


def _check_bshd(name: str, t: torch.Tensor) -> None:
    require(_kernel_layout(t), f"{name} needs unit stride along head_dim, other strides "
            f"multiples of 8 and 16-byte alignment (strides {t.stride()})")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        sm_scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(o, lse)``: ``o`` as `flash_attention`, ``lse`` the base-2
    logsumexp of the scaled scores, fp32 ``(b, h, sq)`` (the residual the
    backward kernels consume). Not differentiable: `flash_attention` is."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if not use_kernel(q, k, v, name="flash_attention_fwd"):
        return attention_reference(q, k, v, sm_scale), attention_lse_reference(q, k, sm_scale)

    b, sq, h, d = q.shape
    sk = k.shape[1]
    require(q.dtype == k.dtype == v.dtype == torch.bfloat16,
            f"flash attention takes bf16, got {q.dtype}/{k.dtype}/{v.dtype}")
    require(k.shape == v.shape == (b, sk, h, d),
            f"shape mismatch q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    require(d % 8 == 0 and d <= MAX_HEAD_DIM, f"head_dim {d} must be a multiple of 8 <= 512")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_bshd(name, t)
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


def bwd_kernel_choice(*tensors: torch.Tensor) -> Tuple[bool, bool]:
    """Whether K2 (dK/dV) and K3 (dQ) take their kernels, each by its own
    ``reference_ops`` name."""
    return (use_kernel(*tensors, name="flash_attention_bwd_dkv"),
            use_kernel(*tensors, name="flash_attention_bwd_dq"))


def flash_attention_bwd(q, k, v, o, lse, do, sm_scale: float,
                        kernels: Optional[Tuple[bool, bool]] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of `flash_attention` from the forward's ``o`` and
    base-2 ``lse``: delta = rowsum(dO * O) in plain torch, then K2 (dK/dV)
    and K3 (dQ), each its kernel or its plain version as ``kernels`` says
    (default: `bwd_kernel_choice` of the inputs). Outputs are contiguous
    ``(b, s, h, d)`` in q's dtype."""
    dkv_kernel, dq_kernel = kernels if kernels is not None else bwd_kernel_choice(
        q, k, v, o, lse, do)
    if not (dkv_kernel or dq_kernel):
        return attention_bwd_reference(q, k, v, o, lse, do, sm_scale)
    require(o.dtype == q.dtype and o.shape == do.shape == q.shape,
            f"shape mismatch q{tuple(q.shape)} o{tuple(o.shape)} do{tuple(do.shape)}")
    do = do.to(q.dtype)  # as `_bwd`: the cotangent in q's dtype
    if not _kernel_layout(do):  # e.g. a transposed view from the caller's reshape
        do = do.contiguous()
    delta = attention_delta(o, do)
    dkv = flash_attention_bwd_dkv if dkv_kernel else attention_bwd_dkv_reference
    dq = flash_attention_bwd_dq if dq_kernel else attention_bwd_dq_reference
    dk, dv = dkv(q, k, v, do, lse, delta, sm_scale)
    return dq(q, k, v, do, lse, delta, sm_scale), dk, dv


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """rowsum(dO * O) in fp32, ``(b, h, sq)`` contiguous (computed outside the
    kernels, as `_bwd` does in XLA)."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


class FwdTiles(NamedTuple):
    d_pad: int    # head_dim zero-filled in shared memory
    q_rows: int   # q rows of a block
    k_step: int   # keys of a step
    chunk: int    # columns of a TMA box (16, 32, 64: the 32-, 64-, 128-byte swizzle)


def fwd_tiles(d: int) -> FwdTiles:
    """K1's tiles at head_dim ``d``, as `csrc/flash_attention.cu` dispatches:
    up to d = 160 two 64-row warpgroups a block, d padded as in `bwd_tiles`
    and copied in chunks of the widest swizzle that divides it, 128-key steps
    where the fp32 accumulator is at most 64 columns wide and 64-key steps
    above, so that scores, P and accumulator fit the registers; above 160 one
    512-wide instance of 64 q rows whose two warpgroups split the head, with
    32-key steps."""
    if d <= MAX_HEAD_DIM_BWD:
        d_pad = cdiv(d, 16) * 16 if d <= 80 else cdiv(d, 32) * 32
        chunk = next(c for c in (64, 32, 16) if d_pad % c == 0)
        return FwdTiles(d_pad, 128, 128 if d_pad <= 64 else 64, chunk)
    return FwdTiles(MAX_HEAD_DIM, 64, 32, 64)


class BwdTiles(NamedTuple):
    d_pad: int    # head_dim zero-filled in shared memory: a multiple of 16 (32 above 80)
    wd: int       # K2 warpgroups sharing one 64-row k slice (the dK/dV columns split)
    k2_rows: int  # k rows of a K2 block
    k2_step: int  # q rows of a K2 step
    k3_rows: int  # q rows of a K3 block
    k3_step: int  # k rows of a K3 step


def bwd_tiles(d: int) -> BwdTiles:
    """K2/K3's tiles at head_dim ``d``, as `csrc/flash_attention_bwd.cu`
    dispatches. Steps narrow to 32 rows where a warpgroup's fp32
    accumulators take 80 columns (K2) or 128 or more (K3), so that they fit
    its registers beside the scores."""
    d_pad = cdiv(d, 16) * 16 if d <= 80 else cdiv(d, 32) * 32
    wd = 1 if d_pad <= 80 else 2
    return BwdTiles(d_pad, wd, 128 // wd, 32 if d_pad // wd == 80 else 64, 128,
                    32 if d_pad >= 128 else 64)


def dkv_splits(b: int, h: int, sq: int, sk: int, d: int, sms: int = H100_SMS) -> int:
    """Blocks that share K2's q range (1: none). Short key sequences
    (cross-attention, sk = 77) leave K2 with fewer blocks than SMs; the q
    range is then split so that the grid comes near one block a SM, each
    split at least two q steps long."""
    tiles = bwd_tiles(d)
    blocks = cdiv(sk, tiles.k2_rows) * b * h
    if blocks >= sms:
        return 1
    return max(1, min(sms // blocks, cdiv(sq, tiles.k2_step) // 2))


def _bwd_check(q, k, v, do, lse, delta) -> None:
    b, sq, h, d = q.shape
    sk = k.shape[1]
    require(all(t.is_cuda for t in (q, k, v, do, lse, delta)),
            "the backward kernels take CUDA tensors (flash_attention_bwd dispatches)")
    require(q.dtype == k.dtype == v.dtype == do.dtype == torch.bfloat16,
            f"flash attention backward takes bf16, got {q.dtype}/{k.dtype}/{v.dtype}/{do.dtype}")
    require(k.shape == v.shape == (b, sk, h, d) and do.shape == q.shape,
            f"shape mismatch q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)} "
            f"do{tuple(do.shape)}")
    require(d % 8 == 0 and d <= MAX_HEAD_DIM_BWD,
            f"head_dim {d} must be a multiple of 8 <= {MAX_HEAD_DIM_BWD} in the backward")
    for name, t in (("lse", lse), ("delta", delta)):
        require(t.dtype == torch.float32 and t.shape == (b, h, sq) and t.is_contiguous(),
                f"{name} must be a contiguous fp32 (b, h, sq) tensor")
    for name, t in (("q", q), ("k", k), ("v", v), ("do", do)):
        _check_bshd(name, t)


def _bwd_args(q, k, v, do, sm_scale):
    """Shapes, strides, alpha, scale and stream, in the C interface's order."""
    b, sq, h, d = q.shape
    return ((b, h, sq, k.shape[1], d),
            (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
             ctypes.c_float(sm_scale * LOG2E), ctypes.c_float(sm_scale), stream_ptr(q.device)))


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, sm_scale: float):
    """K2: ``(dk, dv)``, contiguous ``(b, sk, h, d)`` bf16 (CUDA tensors only)."""
    _bwd_check(q, k, v, do, lse, delta)
    dk, dv = (torch.empty(k.shape, dtype=q.dtype, device=q.device) for _ in range(2))
    sizes, rest = _bwd_args(q, k, v, do, sm_scale)
    nsplit = dkv_splits(*sizes[:4], q.shape[3], sm_count(q.device))
    part = (torch.empty((nsplit, 2, *k.shape), dtype=torch.float32, device=q.device)
            if nsplit > 1 else None)
    err = lib().pcm_flash_attention_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), None if part is None else part.data_ptr(), *sizes, nsplit,
        *rest)
    check_cuda(err, "flash_attention_bwd_dkv")
    count_launch("flash_attention_bwd_dkv")
    return dk, dv


def flash_attention_bwd_dq(q, k, v, do, lse, delta, sm_scale: float):
    """K3: ``dq``, contiguous ``(b, sq, h, d)`` bf16 (CUDA tensors only)."""
    _bwd_check(q, k, v, do, lse, delta)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    sizes, rest = _bwd_args(q, k, v, do, sm_scale)
    err = lib().pcm_flash_attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), *sizes, *rest)
    check_cuda(err, "flash_attention_bwd_dq")
    count_launch("flash_attention_bwd_dq")
    return dq


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


def _bwd_scores_reference(q, k, v, lse, do, delta, sm_scale):
    """fp32 P and dS, the probabilities from the saved base-2 ``lse``."""
    qf, kf, do = q.float(), k.float(), do.float()
    p = torch.exp2(torch.einsum("bqhd,bkhd->bhqk", qf, kf) * (sm_scale * LOG2E)
                   - lse.float()[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v.float())
    return p, p * (dp - delta[..., None]) * sm_scale


def attention_bwd_dkv_reference(q, k, v, do, lse, delta, sm_scale):
    """Plain K2: ``(dk, dv)`` in q's dtype."""
    p, ds = _bwd_scores_reference(q, k, v, lse, do, delta, sm_scale)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    return dk.to(q.dtype).contiguous(), dv.to(q.dtype).contiguous()


def attention_bwd_dq_reference(q, k, v, do, lse, delta, sm_scale):
    """Plain K3: ``dq`` in q's dtype."""
    _, ds = _bwd_scores_reference(q, k, v, lse, do, delta, sm_scale)
    return torch.einsum("bhqk,bkhd->bqhd", ds, k.float()).to(q.dtype).contiguous()


def attention_bwd_reference(q, k, v, o, lse, do, sm_scale):
    """Plain version of K2 + K3 in fp32, computing P from the saved base-2
    ``lse`` as the kernels do (not by autograd of a softmax). Returns
    contiguous ``(dq, dk, dv)`` in q's dtype."""
    do = do.to(q.dtype)
    delta = attention_delta(o, do)
    dk, dv = attention_bwd_dkv_reference(q, k, v, do, lse, delta, sm_scale)
    return attention_bwd_dq_reference(q, k, v, do, lse, delta, sm_scale), dk, dv
