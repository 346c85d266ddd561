"""Blockwise 8-bit Adam moments (counterpart of `pcm_tpu/train/optim8bit.py`).

Both moments are kept as int8 codes over the flattened tensor, zero-padded
to blocks of 2048:
- mu: linear absmax codes, one fp32 scale per block (``absmax / 127``, 1
  for an all-zero block);
- nu: codes linear in log2(nu) over each block's (lo, range), so small
  entries keep their order of magnitude; the code -127 decodes to 0.
Rounding is half to even, as ``jnp.round``. The update math runs in fp32
after dequantization. Plain PyTorch: the JAX version has no kernel either.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

BLOCK = 2048

Q8 = Tuple[torch.Tensor, torch.Tensor]  # (int8 codes (N_pad,), fp32 scales)


def _blocks(x: torch.Tensor) -> torch.Tensor:
    flat = x.float().reshape(-1)
    return torch.nn.functional.pad(flat, (0, (-flat.numel()) % BLOCK)).reshape(-1, BLOCK)


def quantize(x: torch.Tensor) -> Q8:
    flat = _blocks(x)
    absmax = flat.abs().amax(dim=1, keepdim=True)
    scale = torch.where(absmax == 0, torch.ones_like(absmax), absmax / 127.0)
    q = torch.clamp(torch.round(flat / scale), -127, 127).to(torch.int8)
    return q.reshape(-1), scale[:, 0]


def dequantize(q: Q8, shape) -> torch.Tensor:
    vals = q[0].float().reshape(-1, BLOCK) * q[1][:, None]
    return vals.reshape(-1)[:math.prod(shape)].reshape(shape)


def quantize_log(x: torch.Tensor) -> Q8:
    flat = _blocks(x)
    logx = torch.log2(torch.clamp(flat, min=1e-30))
    lo = logx.amin(dim=1, keepdim=True)
    rng = torch.clamp(logx.amax(dim=1, keepdim=True) - lo, min=1e-6)
    q = torch.clamp(torch.round((logx - lo) / rng * 254.0) - 127.0, -127, 127).to(torch.int8)
    return q.reshape(-1), torch.cat([lo, rng], dim=1)  # scales (blocks, 2)


def dequantize_log(q: Q8, shape) -> torch.Tensor:
    codes = q[0].reshape(-1, BLOCK)
    lo, rng = q[1][:, :1], q[1][:, 1:]
    vals = torch.exp2((codes.float() + 127.0) / 254.0 * rng + lo)
    vals = torch.where(codes == -127, torch.zeros_like(vals), vals)
    return vals.reshape(-1)[:math.prod(shape)].reshape(shape)


def adam8bit_init(params: Dict[str, torch.Tensor]):
    mu = {k: quantize(torch.zeros_like(p, dtype=torch.float32)) for k, p in params.items()}
    nu = {k: quantize_log(torch.zeros_like(p, dtype=torch.float32)) for k, p in params.items()}
    return mu, nu


def adam8bit_moments(grads, mu_q, nu_q, c1: float, c2: float, b1: float, b2: float,
                     eps: float):
    """Adam's scaled step from int8 moments, with the bias corrections ``c1``
    and ``c2`` of this update; returns (steps, new mu, new nu)
    (`scale_by_adam_8bit.update_fn`)."""
    steps, mu_new, nu_new = {}, {}, {}
    for k, g in grads.items():
        g = g.float()
        mu = dequantize(mu_q[k], g.shape) * b1 + (1 - b1) * g
        nu = dequantize_log(nu_q[k], g.shape) * b2 + (1 - b2) * g * g
        steps[k] = (mu / c1) / (torch.sqrt(nu / c2) + eps)
        mu_new[k], nu_new[k] = quantize(mu), quantize_log(nu)
    return steps, mu_new, nu_new
