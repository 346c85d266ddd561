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

AdamW runs over one flat fp32 vector, not leaf by leaf: the grads, the
parameters and both moments are each gathered into one vector by one
``torch.cat`` (`flatten`), every step of the update is one tensor op on the
vectors, and the new parameters and moments come back as leaf-shaped views
of the new vectors (`unflatten`). The ops an update launches do not grow
with the number of leaves (SD3's adapter has 290, SDXL's 1576). Each leaf
starts at a multiple of `ALIGN` elements, as a fresh allocation would, for
the kernels that take a leaf's pointer (the heads' fp32 GroupNorm); the gaps
hold zeros, which every step keeps zero. The 8-bit moments stay per leaf
(their blocks are a leaf's); their clip and update go through the vector.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..utils import profiling
from .optim8bit import adam8bit_init, adam8bit_moments

Params = Dict[str, torch.Tensor]
ALIGN = 64  # elements: where each leaf starts in a flat vector (256 bytes in fp32)


@dataclasses.dataclass
class TrainState:
    step: int
    params: Params  # fp32 LoRA factors
    opt_state: Dict[str, Any]
    # the global norm of the grads before clipping, of the update that made
    # this state (None for a state no update made); not saved
    grad_norm: Optional[torch.Tensor] = None

    @classmethod
    def create(cls, params: Params, tx: "AdamW") -> "TrainState":
        return cls(step=0, params=params, opt_state=tx.init(params))


def flatten(tree: Params) -> torch.Tensor:
    """Every leaf of ``tree``, in the dict's order and each flattened by its
    shape (a channels-last leaf in logical order too), as one fp32 vector:
    one ``torch.cat``. Each leaf starts at a multiple of `ALIGN`; the gaps
    are zero."""
    leaves = [t.reshape(-1) for t in tree.values()]
    gap = torch.zeros(ALIGN, dtype=leaves[0].dtype, device=leaves[0].device)
    parts = []
    for t in leaves:
        parts.append(t)
        rest = -t.numel() % ALIGN
        if rest:
            parts.append(gap[:rest])
    return torch.cat(parts).float()


def unflatten(flat: torch.Tensor, like: Params) -> Params:
    """The leaves of a `flatten`ed vector, as views shaped like ``like``'s."""
    sizes = []
    for t in like.values():
        sizes += [t.numel(), -t.numel() % ALIGN]
    chunks = torch.split(flat, sizes)
    return {k: chunks[2 * i].view(t.shape) for i, (k, t) in enumerate(like.items())}


def clip_flat(flat: torch.Tensor, max_norm: Optional[float]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """optax.clip_by_global_norm over a `flatten`ed vector of every grad:
    ``g / norm * max_norm`` where ``norm >= max_norm``, as a select on the
    device (None: unclipped). Returns the vector and the global norm before
    clipping, one reduction."""
    norm = torch.sqrt(torch.sum(torch.square(flat)))  # vector_norm sums less exactly on a CPU
    if max_norm is None:
        return flat, norm
    return torch.where(norm < max_norm, flat, (flat / norm) * max_norm), norm


def clip_by_global_norm(grads: Params, max_norm: Optional[float]) -> Params:
    """`clip_flat` over a dict of grads (fp32 leaves; None: unclipped)."""
    if max_norm is None:
        return grads
    return unflatten(clip_flat(flatten(grads), max_norm)[0], grads)


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
               ) -> Tuple[Params, Dict[str, Any], torch.Tensor]:
        """The new parameters (``params + updates``, added on the flat
        vector, where optax returns the updates), the new state and the
        grads' global norm before clipping."""
        profiling.count("optimizer_flat_leaves", len(grads))
        g, norm = clip_flat(flatten(grads), self.max_grad_norm)
        count = state["count"] + 1
        c1, c2 = bias_corrections(self.b1, self.b2, count)
        if self.use_8bit:
            steps, mu, nu = adam8bit_moments(unflatten(g, grads), state["mu"], state["nu"],
                                             c1, c2, self.b1, self.b2, self.eps)
            del g
            step = flatten(steps)
            del steps
        else:
            mu_f = (1 - self.b1) * g + self.b1 * flatten(state["mu"])
            nu_f = (1 - self.b2) * (g * g) + self.b2 * flatten(state["nu"])
            del g
            step = (mu_f / c1) / (torch.sqrt(nu_f / c2) + self.eps)
            mu, nu = unflatten(mu_f, params), unflatten(nu_f, params)
        p = flatten(params)
        if self.weight_decay:
            step = step + self.weight_decay * p
        new = p + step * -self.lr(state["count"])
        return unflatten(new, params), {"count": count, "mu": mu, "nu": nu}, norm


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
    """One optimizer step: params + updates, step + 1, and the grads' norm
    before clipping as ``grad_norm``."""
    params, opt_state, norm = tx.update(grads, state.opt_state, state.params)
    return TrainState(step=state.step + 1, params=params, opt_state=opt_state,
                      grad_norm=norm)
