"""Prodigy, the parameter-free Adam-type optimizer (counterpart of
`pcm_tpu/train/prodigy.py`), the ``--optimizer prodigy`` of the reference's
SD3 trainers (`train_pcm_lora_sd3.py:1120-1145`; keep lr about 1.0).

Algorithm 3 of arXiv:2306.06101 as prodigyopt runs it by default and as
`pcm_tpu/train/state.py:make_optimizer` builds the JAX transformation (beta3
= sqrt(beta2), d0 = 1e-6, d_coef 1, no growth cap, no bias correction, no
safeguard warmup, decoupled weight decay), step for step:

  m_k   = beta1 m + (1 - beta1) d g
  v_k   = beta2 v + (1 - beta2) d^2 g^2
  r_k   = beta3 r + (d / d0) dlr <g, x0 - x>
  s_k   = beta3 s + (d / d0) dlr g
  d'    = max(d, r_k / |s_k|_1)                  (d kept if |s_k|_1 = 0)
  x'    = x - dlr m_k / (sqrt(v_k) + d eps)  [- dlr wd x]

with dlr = d lr. ``d`` is one fp32 scalar over the whole tree, and <g, x0 -
x> and |s|_1 are summed in fp32 over every tensor. ``d`` and ``r`` stay on
the device: an update reads nothing back. The state, ``{"count", "exp_avg",
"exp_avg_sq", "s", "p0", "d", "d_numerator"}``, is saved and resumed like
AdamW's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from .state import clip_flat, flatten, unflatten

Params = Dict[str, torch.Tensor]
D0 = 1e-6  # the initial distance estimate


@dataclasses.dataclass(frozen=True)
class Prodigy:
    """optax.chain(clip_by_global_norm(max_grad_norm), prodigy(lr, ...)) over
    a dict of fp32 tensors (`pcm_tpu/train/state.py:50-58`): no schedule."""

    lr: float = 1.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    max_grad_norm: Optional[float] = 1.0

    def init(self, params: Params) -> Dict[str, Any]:
        device = next(iter(params.values())).device

        def zeros():
            return {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}

        return {"count": 0, "exp_avg": zeros(), "exp_avg_sq": zeros(), "s": zeros(),
                "p0": {k: p.detach().float().clone() for k, p in params.items()},
                "d": torch.tensor(D0, dtype=torch.float32, device=device),
                "d_numerator": torch.zeros((), dtype=torch.float32, device=device)}

    def update(self, grads: Params, state: Dict[str, Any], params: Params
               ) -> Tuple[Params, Dict[str, Any], torch.Tensor]:
        """The new parameters, the new state and the grads' global norm
        before clipping (as `state.AdamW.update`)."""
        flat, norm = clip_flat(flatten(grads), self.max_grad_norm)
        grads = unflatten(flat, grads)
        b1, b2 = self.b1, self.b2
        b3 = float(b2) ** 0.5
        d = state["d"]
        dlr = d * self.lr
        dot = sum(torch.sum(g * (state["p0"][k] - params[k].float())) for k, g in grads.items())
        d_numerator = b3 * state["d_numerator"] + (d / D0) * dlr * dot
        exp_avg = {k: b1 * state["exp_avg"][k] + (1.0 - b1) * d * g for k, g in grads.items()}
        exp_avg_sq = {k: b2 * state["exp_avg_sq"][k] + (1.0 - b2) * d * d * g * g
                      for k, g in grads.items()}
        s_scale = (d / D0) * dlr
        s = {k: b3 * state["s"][k] + s_scale * g for k, g in grads.items()}
        d_denom = sum(torch.sum(torch.abs(v)) for v in s.values())
        positive = d_denom > 0.0
        d_hat = d_numerator / torch.where(positive, d_denom, 1.0)
        new_d = torch.where(positive, torch.maximum(d, d_hat), d)
        new_params = {}
        for k, m in exp_avg.items():
            u = -dlr * m / (torch.sqrt(exp_avg_sq[k]) + d * self.eps)
            if self.weight_decay:
                u = u - dlr * self.weight_decay * params[k].float()
            new_params[k] = params[k] + u.to(params[k].dtype)
        return new_params, {"count": state["count"] + 1, "exp_avg": exp_avg,
                            "exp_avg_sq": exp_avg_sq, "s": s, "p0": state["p0"], "d": new_d,
                            "d_numerator": d_numerator}, norm


def prodigy_d(opt_state: Dict[str, Any]) -> Optional[torch.Tensor]:
    """Prodigy's distance estimate ``d`` of an optimizer state (None for
    AdamW's): the number to log, since the effective rate is lr * d."""
    return opt_state.get("d") if "d_numerator" in opt_state else None
