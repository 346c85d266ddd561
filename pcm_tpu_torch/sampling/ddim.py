"""Trailing-DDIM sampler (counterpart of `pcm_tpu/sampling/ddim.py`; TCD comes later).

PCM's DDIM: trailing timestep spacing, ``clip_sample=False``,
``set_alpha_to_one=False``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..core.schedule import DDPMSchedule


def trailing_timesteps(num_train_timesteps: int, num_inference_steps: int) -> np.ndarray:
    """Descending timesteps by the 'trailing' rule (Table 2, arXiv:2305.08891)."""
    step_ratio = num_train_timesteps / num_inference_steps
    return np.round(np.arange(num_train_timesteps, 0, -step_ratio)).astype(np.int64) - 1


@dataclasses.dataclass(frozen=True)
class DDIMSampler:
    """Deterministic DDIM over trailing timesteps."""

    schedule: DDPMSchedule
    timesteps: Tuple[int, ...]  # descending
    alphas: Tuple[float, ...]  # alpha_cumprod at each timestep (fp32 values)
    alphas_prev: Tuple[float, ...]  # at the next lower timestep; last = alphas_cumprod[0]

    @classmethod
    def create(cls, schedule: DDPMSchedule, num_inference_steps: int) -> "DDIMSampler":
        ts = trailing_timesteps(schedule.num_train_timesteps, num_inference_steps)
        ac = schedule.alphas_cumprod
        prev = np.concatenate([ac[ts[1:]], ac[:1]])
        return cls(schedule, tuple(int(t) for t in ts), tuple(float(a) for a in ac[ts]),
                   tuple(float(a) for a in prev))

    @property
    def num_steps(self) -> int:
        return len(self.timesteps)

    def step(self, model_output: torch.Tensor, i: int, sample: torch.Tensor) -> torch.Tensor:
        """One DDIM step at position ``i`` of the descending schedule, in fp32."""
        sqrt = lambda a: float(np.sqrt(np.float32(a)))  # noqa: E731  (fp32, as the JAX tables)
        a_t, a_prev = self.alphas[i], self.alphas_prev[i]
        x = sample.float()
        eps = model_output.float()
        if self.schedule.prediction_type == "v_prediction":
            x0 = sqrt(a_t) * x - sqrt(1 - a_t) * eps
            eps = sqrt(a_t) * eps + sqrt(1 - a_t) * x
        else:
            x0 = (x - sqrt(1 - a_t) * eps) / sqrt(a_t)
        return (sqrt(a_prev) * x0 + sqrt(1 - a_prev) * eps).to(sample.dtype)
