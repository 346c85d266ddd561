"""GroupNorm module over the fused GroupNorm+SiLU kernel."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ..ops import group_norm_silu


class GroupNorm(nn.Module):
    """GroupNorm over NCHW input with an optional fused SiLU.

    The input is kept in ``torch.channels_last`` memory (a no-op when it
    already is), so the NHWC view the kernel takes is free.
    """

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-5,
                 act: Optional[str] = None):
        super().__init__()
        self.num_groups, self.eps, self.act = num_groups, eps, act
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        nhwc = x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
        y = group_norm_silu(nhwc, self.weight, self.bias, self.num_groups, self.eps, self.act)
        return y.permute(0, 3, 1, 2)
