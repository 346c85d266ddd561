"""The numbers that decide ``correct``: gaps between what the program
produced and what the plain reference works out from the same inputs.

Training (the first steps that the timed path ran, followed by the
reference):
- ``loss_gap``: the largest relative gap of a step's loss.
- ``grad_gap``: the first gradient as AdamW took it (its first moment after
  one step over ``1 - b1``), by the worst leaf: the gap between the
  program's and the reference's norm of the leaf, over the reference's norm
  of that leaf or of the median leaf, whichever is larger.
- ``change_gap``: the adapter's change over the steps, by the worst leaf,
  measured as ``grad_gap``; leaves whose reference gradient is under a
  thousandth of the median leaf's are left out (Adam moves them by
  round-off alone).
- ``grad_diff`` / ``change_diff``: the same two trees by the norm of their
  difference, over all leaves together (the change over the moving leaves):
  ``‖p − r‖ / ‖r‖``. A gap of norms sees an error only along the tree it
  measures; a difference sees it in every direction, where the error of a
  lower precision (int8 frozen weights) lies.
- ``change_gap_med``: ``change_gap``'s gap of norms at the median leaf
  instead of the worst: steady from seed to seed where the worst leaf's
  swings (SDXL).

A cell compares the numbers its workload file gives limits; the others are
printed with the run and not compared.
"""

from __future__ import annotations

import statistics
from typing import Dict, Mapping, Sequence

import torch

ZERO_GRAD = 1e-3  # a leaf's gradient norm under this share of the median's: left out


def loss_gap(program: Sequence[float], reference: Sequence[float]) -> float:
    return max(abs(p - r) / abs(r) for p, r in zip(program, reference))


def _norms(tree: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in tree.items()}


def leaf_gap(program: Mapping[str, torch.Tensor], reference: Mapping[str, torch.Tensor],
             keep=None) -> float:
    """max over leaves of |‖p‖ − ‖r‖| / max(‖r‖, median ‖r‖)."""
    pn, rn = _norms(program), _norms(reference)
    keys = [k for k in rn if keep is None or k in keep]
    med = statistics.median(rn[k] for k in keys)
    return max(abs(pn[k] - rn[k]) / max(rn[k], med) for k in keys)


def moving_leaves(grads: Mapping[str, torch.Tensor]) -> set:
    """The leaves whose reference gradient norm is at least `ZERO_GRAD` of the median's."""
    n = _norms(grads)
    med = statistics.median(n.values())
    return {k for k, v in n.items() if v >= ZERO_GRAD * med}


def diff(program: Mapping[str, torch.Tensor], reference: Mapping[str, torch.Tensor],
         keep=None) -> float:
    """‖p − r‖ / ‖r‖ over the leaves (``keep`` of them) taken as one vector."""
    keys = [k for k in reference if keep is None or k in keep]
    num = sum(float(torch.sum((program[k].float() - reference[k].float()) ** 2)) for k in keys)
    den = sum(float(torch.sum(reference[k].float() ** 2)) for k in keys)
    return (num / den) ** 0.5


def leaf_median_gap(program: Mapping[str, torch.Tensor],
                    reference: Mapping[str, torch.Tensor], keep) -> float:
    """The median over the ``keep`` leaves of |‖p‖ − ‖r‖| / ‖r‖."""
    pn, rn = _norms(program), _norms(reference)
    return statistics.median(abs(pn[k] - rn[k]) / rn[k] for k in rn if k in keep)


def training_gaps(losses_p: Sequence[float], mu1_p: Mapping[str, torch.Tensor],
                  params_p: Mapping[str, torch.Tensor], lora0: Mapping[str, torch.Tensor],
                  ref: Dict, b1: float = 0.9) -> Dict[str, float]:
    """The three gaps of `ref` (`reference.distill.train`'s result) against
    the program's losses, first moments after step one and adapter after the
    compared steps; ``lora0`` is the adapter both started from."""
    g_p = {k: v.float() / (1.0 - b1) for k, v in mu1_p.items()}
    d_p = {k: params_p[k].float() - lora0[k].float() for k in lora0}
    d_r = {k: ref["params"][k].float() - lora0[k].float() for k in lora0}
    moving = moving_leaves(ref["first_grad"])
    return {"loss_gap": loss_gap(losses_p, ref["losses"]),
            "grad_gap": leaf_gap(g_p, ref["first_grad"]),
            "change_gap": leaf_gap(d_p, d_r, keep=moving),
            "grad_diff": diff(g_p, ref["first_grad"]),
            "change_diff": diff(d_p, d_r, keep=moving),
            "change_gap_med": leaf_median_gap(d_p, d_r, moving)}
