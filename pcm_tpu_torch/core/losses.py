"""Losses of phased consistency distillation (counterpart of
`pcm_tpu/core/losses.py`), all in fp32 whatever the input dtype. The hinge
and feature-matching losses of the adversarial recipes are not ported yet."""

from __future__ import annotations

import torch


def huber_loss(pred: torch.Tensor, target: torch.Tensor, c: float = 0.001) -> torch.Tensor:
    """Pseudo-huber: mean(sqrt((pred-target)^2 + c^2) - c)."""
    d = pred.float() - target.float()
    return torch.mean(torch.sqrt(d * d + c * c) - c)


def l2_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    d = pred.float() - target.float()
    return torch.mean(d * d)


def consistency_loss(pred: torch.Tensor, target: torch.Tensor, loss_type: str = "huber",
                     huber_c: float = 0.001) -> torch.Tensor:
    if loss_type == "huber":
        return huber_loss(pred, target, huber_c)
    if loss_type == "l2":
        return l2_loss(pred, target)
    raise ValueError(f"unknown loss_type: {loss_type}")


def cfg_combine(cond: torch.Tensor, uncond: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """LCM-style CFG: cond + w (cond - uncond), per-sample w broadcast over
    the trailing dims."""
    w = w.reshape(w.shape + (1,) * (cond.ndim - w.ndim))
    return cond + w * (cond - uncond)
