"""Losses of phased consistency distillation (counterpart of
`pcm_tpu/core/losses.py`), all in fp32 whatever the input dtype: the
consistency losses, and the hinge and feature-matching losses of the
adversarial recipes (one term a discriminator head, averaged)."""

from __future__ import annotations

from typing import Sequence

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


def hinge_d_loss(fake_logits: Sequence[torch.Tensor], real_logits: Sequence[torch.Tensor],
                 weight: float = 1.0) -> torch.Tensor:
    """Hinge discriminator loss, averaged over heads:
    mean(relu(1 + fake)) + mean(relu(1 - real))."""
    n = len(fake_logits)
    loss = 0.0
    for f, r in zip(fake_logits, real_logits):
        loss = loss + (torch.mean(weight * torch.relu(f.float() + 1.0))
                       + torch.mean(weight * torch.relu(1.0 - r.float()))) / n
    return loss


def hinge_g_loss(fake_logits: Sequence[torch.Tensor], weight: float = 1.0) -> torch.Tensor:
    """Hinge generator loss: mean(relu(1 - fake)), averaged over heads."""
    n = len(fake_logits)
    loss = 0.0
    for f in fake_logits:
        loss = loss + torch.mean(weight * torch.relu(1.0 - f.float())) / n
    return loss


def feature_matching_loss(fake_features: Sequence[torch.Tensor],
                          real_features: Sequence[torch.Tensor]) -> torch.Tensor:
    """Mean squared difference of feature maps, averaged over them."""
    n = len(fake_features)
    loss = 0.0
    for f, r in zip(fake_features, real_features):
        d = f.float() - r.float()
        loss = loss + torch.mean(d * d) / n
    return loss
