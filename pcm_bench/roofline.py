"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its
700 W power limit) and the least time of a piece of work on it: the larger
of its bytes (each input read once, each output written once) over the
memory rate and its operations over the peak rate of their type."""

from __future__ import annotations

HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}
CARD_POWER_W = 700.0  # the power limit the peaks assume


def bound(ops: float, kind: str, nbytes: float) -> dict:
    """``{"bound_ms", "bound_by"}`` of ``ops`` operations of type ``kind``
    that read and write ``nbytes`` bytes."""
    t_ops, t_bytes = ops / PEAK_OPS_S[kind] * 1e3, nbytes / HBM_BYTES_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def attn_work(shape, products: int, outputs: int):
    """(operations, bytes) of attention of ``shape`` (b, sq, sk, h, d):
    ``products`` matmuls of 2·sq·sk·d per (b, h); q, k, v (+ dO) in bf16 and
    the fp32 row statistics read, ``outputs`` bf16 tensors shaped like q or k
    written."""
    b, sq, sk, h, d = shape
    ops = 2.0 * products * b * h * sq * sk * d
    ins = 2.0 * (2 * b * sq * h * d + 2 * b * sk * h * d) + 4.0 * 2 * b * h * sq
    outs = 2.0 * outputs * b * max(sq, sk) * h * d
    return ops, ins + outs


def attn_bound(shape, products: int, outputs: int) -> dict:
    """`bound` of `attn_work` in bf16."""
    ops, nbytes = attn_work(shape, products, outputs)
    return bound(ops, "bf16", nbytes)
