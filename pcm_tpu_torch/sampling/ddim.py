"""Trailing-DDIM and TCD samplers (counterpart of `pcm_tpu/sampling/ddim.py`).

PCM's DDIM: trailing timestep spacing, ``clip_sample=False``,
``set_alpha_to_one=False``. TCD: a DDIM jump to ``s = (1 - gamma) t_prev``,
then fresh noise back up to ``t_prev``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.schedule import DDPMSchedule
from .pcm_fm import Renoise, draw_renoise


def _sqrt(a: float) -> float:
    """sqrt in fp32, as the JAX samplers take it of their fp32 tables."""
    return float(np.sqrt(np.float32(a)))


def _x0_eps(prediction_type: str, model_output: torch.Tensor, x: torch.Tensor, a_t: float):
    """(x0, eps) of an eps- or v-prediction at alpha_cumprod ``a_t``, fp32."""
    out = model_output.float()
    if prediction_type == "v_prediction":
        return _sqrt(a_t) * x - _sqrt(1 - a_t) * out, _sqrt(a_t) * out + _sqrt(1 - a_t) * x
    return (x - _sqrt(1 - a_t) * out) / _sqrt(a_t), out


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

    def step(self, model_output: torch.Tensor, i: int, sample: torch.Tensor,
             rng=None) -> torch.Tensor:
        """One DDIM step at position ``i`` of the descending schedule, in fp32.
        DDIM draws nothing; ``rng`` is the samplers' common signature."""
        a_prev = self.alphas_prev[i]
        x0, eps = _x0_eps(self.schedule.prediction_type, model_output, sample.float(),
                          self.alphas[i])
        return (_sqrt(a_prev) * x0 + _sqrt(1 - a_prev) * eps).to(sample.dtype)


@dataclasses.dataclass(frozen=True)
class TCDSampler:
    """Trajectory-consistency sampling over trailing timesteps: DDIM to
    ``s = floor((1 - gamma) t_prev)``, then renoise to ``t_prev`` with
    fresh noise; ``gamma = 0`` is DDIM, and the final step returns x_s."""

    schedule: DDPMSchedule
    timesteps: Tuple[int, ...]  # descending
    alphas: Tuple[float, ...]
    alphas_prev: Tuple[float, ...]  # at the next lower timestep; last = alphas_cumprod[0]
    alphas_s: Tuple[float, ...]  # at s = floor((1 - gamma) * t_prev)
    gamma: float

    @classmethod
    def create(cls, schedule: DDPMSchedule, num_inference_steps: int,
               gamma: float = 0.3) -> "TCDSampler":
        ts = trailing_timesteps(schedule.num_train_timesteps, num_inference_steps)
        ac = schedule.alphas_cumprod
        ts_prev = np.concatenate([ts[1:], [0]])
        ts_s = np.floor((1.0 - gamma) * ts_prev).astype(np.int64)
        prev = np.concatenate([ac[ts[1:]], ac[:1]])
        return cls(schedule, tuple(int(t) for t in ts), tuple(float(a) for a in ac[ts]),
                   tuple(float(a) for a in prev), tuple(float(a) for a in ac[ts_s]), gamma)

    @property
    def num_steps(self) -> int:
        return len(self.timesteps)

    def step(self, model_output: torch.Tensor, i: int, sample: torch.Tensor,
             rng: Optional[Renoise] = None) -> torch.Tensor:
        """One step at position ``i``, in fp32; the renoise's fresh noise
        comes from ``rng`` (`pcm_fm.draw_renoise`: a tensor, one generator,
        or one generator a row), drawn at every step but the final one."""
        a_s = self.alphas_s[i]
        x0, eps = _x0_eps(self.schedule.prediction_type, model_output, sample.float(),
                          self.alphas[i])
        x_s = _sqrt(a_s) * x0 + _sqrt(1 - a_s) * eps
        if self.gamma == 0.0 or i == self.num_steps - 1:
            return x_s.to(sample.dtype)
        if rng is None:
            raise ValueError("the TCD step needs its renoise (rng)")
        ratio = np.float32(self.alphas_prev[i]) / np.float32(a_s)
        noise = draw_renoise(rng, x_s)
        out = _sqrt(ratio) * x_s + _sqrt(max(np.float32(1) - ratio, np.float32(0))) * noise
        return out.to(sample.dtype)
