"""Train state and the student optimizer (counterpart of `pcm_tpu/train/state.py`).

The optimizer differentiates the LoRA factors only; base weights are frozen
bf16 modules. It follows optax's semantics step for step, so that the port
and the JAX package update the same parameters to the same values:

  clip_by_global_norm(max_norm) -> AdamW (or blockwise 8-bit AdamW)
  -> + weight_decay * params -> * -lr(count)

- Clipping scales by ``max_norm / norm`` only when ``norm >= max_norm``
  (``torch.nn.utils.clip_grad_norm_`` would divide by ``norm + 1e-6`` always).
- The learning rate of an update is the schedule at the count of updates
  made before it: with a warmup, the first update uses lr = 0.
- Adam's bias correction uses the count after the update.

The updates are functional: ``update`` returns new tensors and a new state,
as optax does; nothing is modified in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .optim8bit import adam8bit_init, adam8bit_moments

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    step: int
    params: Params  # fp32 LoRA factors
    opt_state: Dict[str, Any]

    @classmethod
    def create(cls, params: Params, tx: "AdamW") -> "TrainState":
        return cls(step=0, params=params, opt_state=tx.init(params))


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, in fp32 (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree.values()))


def clip_by_global_norm(grads: Params, max_norm: Optional[float]) -> Params:
    """optax.clip_by_global_norm: ``g / norm * max_norm`` where ``norm >=
    max_norm``, as a select on the device (None: unclipped)."""
    if max_norm is None:
        return grads
    norm = global_norm(grads)
    keep = norm < max_norm
    return {k: torch.where(keep, g, (g / norm) * max_norm) for k, g in grads.items()}


def bias_corrections(b1: float, b2: float, count: int) -> Tuple[float, float]:
    """Adam's ``1 - b**count`` in fp32, as optax computes them (host scalars:
    no device copy per parameter)."""
    one, n = np.float32(1.0), np.float32(count)
    return float(one - np.float32(b1) ** n), float(one - np.float32(b2) ** n)


def lr_schedule(lr: float, warmup_steps: int = 0, schedule: str = "constant",
                total_steps: Optional[int] = None):
    """``count -> learning rate`` as `make_optimizer` builds it with optax:
    ``constant`` is a linear warmup from 0 joined to a constant, ``cosine`` is
    ``optax.warmup_cosine_decay_schedule(0, lr, warmup, total)``."""
    if schedule == "constant":
        if not warmup_steps:
            return lambda count: lr
        return lambda count: lr * min(count, warmup_steps) / warmup_steps
    if schedule == "cosine":
        if total_steps is None:
            raise ValueError("the cosine schedule needs total_steps")
        decay = total_steps - warmup_steps
        if decay <= 0:
            raise ValueError(f"cosine decay needs total_steps > warmup_steps, got {total_steps}")

        def cosine(count):
            if count < warmup_steps:
                return lr * count / warmup_steps
            c = min(count - warmup_steps, decay)
            return lr * 0.5 * (1.0 + math.cos(math.pi * c / decay))

        return cosine
    raise ValueError(f"unknown lr schedule {schedule!r}")


@dataclasses.dataclass(frozen=True)
class AdamW:
    """optax.chain(clip_by_global_norm, adamw | scale_by_adam_8bit + decay +
    scale_by_learning_rate) over a dict of fp32 tensors. State:
    ``{"count": int, "mu": ..., "nu": ...}``; with ``use_8bit`` the moments
    are blockwise int8 (`optim8bit.py`)."""

    lr: Any  # count -> float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    max_grad_norm: Optional[float] = 1.0
    use_8bit: bool = False

    def init(self, params: Params) -> Dict[str, Any]:
        if self.use_8bit:
            mu, nu = adam8bit_init(params)
        else:
            mu = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
            nu = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
        return {"count": 0, "mu": mu, "nu": nu}

    def clip(self, grads: Params) -> Params:
        return clip_by_global_norm(grads, self.max_grad_norm)

    def update(self, grads: Params, state: Dict[str, Any], params: Params
               ) -> Tuple[Params, Dict[str, Any]]:
        grads = self.clip(grads)
        count = state["count"] + 1
        c1, c2 = bias_corrections(self.b1, self.b2, count)
        if self.use_8bit:
            steps, mu, nu = adam8bit_moments(grads, state["mu"], state["nu"], c1, c2,
                                             self.b1, self.b2, self.eps)
        else:
            mu, nu, steps = {}, {}, {}
            for k, g in grads.items():
                g = g.float()
                mu[k] = (1 - self.b1) * g + self.b1 * state["mu"][k]
                nu[k] = (1 - self.b2) * (g * g) + self.b2 * state["nu"][k]
                steps[k] = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + self.eps)
        if self.weight_decay:
            steps = {k: s + self.weight_decay * params[k] for k, s in steps.items()}
        step_size = -self.lr(state["count"])
        return {k: s * step_size for k, s in steps.items()}, {"count": count, "mu": mu, "nu": nu}


def make_optimizer(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                   weight_decay: float = 0.0, max_grad_norm: Optional[float] = 1.0,
                   warmup_steps: int = 0, total_steps: Optional[int] = None,
                   schedule: str = "constant", use_8bit: bool = False,
                   optimizer: str = "adamw"):
    """AdamW + global-norm clipping, as `pcm_tpu.train.state.make_optimizer`;
    ``optimizer="prodigy"``: global-norm clipping + Prodigy at ``lr`` with
    no schedule (`train/prodigy.py`; keep lr about 1.0)."""
    if optimizer == "prodigy":
        from .prodigy import Prodigy

        return Prodigy(lr, b1, b2, eps=eps, weight_decay=weight_decay,
                       max_grad_norm=max_grad_norm)
    if optimizer != "adamw":
        raise ValueError(f"unsupported optimizer {optimizer!r} (adamw|prodigy)")
    return AdamW(lr_schedule(lr, warmup_steps, schedule, total_steps), b1, b2, eps,
                 weight_decay, max_grad_norm, use_8bit)


def apply_updates(state: TrainState, grads: Params, tx: AdamW) -> TrainState:
    """One optimizer step: params + updates, step + 1."""
    updates, opt_state = tx.update(grads, state.opt_state, state.params)
    params = {k: p + updates[k] for k, p in state.params.items()}
    return TrainState(step=state.step + 1, params=params, opt_state=opt_state)
