"""PCM flow-matching samplers for SD3 students (counterpart of
`pcm_tpu/sampling/pcm_fm.py`), deterministic and stochastic.

The inference sigmas subsample the ``pcm_timesteps``-point training grid by
the floor-linspace phase-boundary rule of training, so k-step inference
lands on the k phase boundaries of a k-phase student.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.schedule import DeviceTables, FlowSchedule
from ..core.solver import phase_boundaries, solver_grid

# the stochastic step's fresh noise: a tensor shaped like the sample, one
# generator for the batch, or one generator per row (a request's own draws)
Renoise = Union[torch.Tensor, torch.Generator, Sequence[torch.Generator]]


def pcm_fm_sigmas(schedule: FlowSchedule, pcm_timesteps: int, num_inference_steps: int
                  ) -> np.ndarray:
    """Descending inference sigmas: the phase-boundary subsample of the PCM
    solver grid, with a terminal 0 appended (float32)."""
    grid = solver_grid(schedule.num_train_timesteps, pcm_timesteps)
    desc = np.asarray(schedule.sigmas)[grid][::-1]
    sigmas = desc[phase_boundaries(pcm_timesteps, num_inference_steps)]
    return np.concatenate([sigmas, [0.0]]).astype(np.float32)


def draw_renoise(rng: Renoise, like: torch.Tensor) -> torch.Tensor:
    """Standard normal noise shaped like ``like`` (fp32, on its device):
    ``rng`` itself when it is a tensor, else drawn from one generator, or row
    by row from one generator per row."""
    if isinstance(rng, torch.Tensor):
        return rng.float()
    if isinstance(rng, torch.Generator):
        return torch.randn(like.shape, generator=rng, device=like.device)
    if len(rng) != like.shape[0]:
        raise ValueError(f"{len(rng)} generators for a batch of {like.shape[0]}")
    return torch.stack([torch.randn(like.shape[1:], generator=g, device=like.device)
                        for g in rng])


@dataclasses.dataclass(frozen=True)
class PCMFMSampler(DeviceTables):
    """``stochastic=False``: the Euler step x' = x + (x - x0)/sigma * dsigma;
    ``stochastic=True``: full denoise, then renoise with fresh noise to the
    next sigma. The arithmetic is fp32 on the sample's device, as JAX's."""

    sigmas: np.ndarray  # (S+1,) float32, descending with a terminal 0
    num_train_timesteps: int
    stochastic: bool = False

    @classmethod
    def create(cls, schedule: FlowSchedule, num_inference_steps: int, pcm_timesteps: int = 50,
               stochastic: bool = False) -> "PCMFMSampler":
        return cls(pcm_fm_sigmas(schedule, pcm_timesteps, num_inference_steps),
                   schedule.num_train_timesteps, stochastic)

    @property
    def num_steps(self) -> int:
        return int(self.sigmas.shape[0]) - 1

    @property
    def timesteps(self) -> Tuple[float, ...]:
        """The model's timestep at each step: sigma * T in fp32."""
        return tuple(float(t) for t in self.sigmas[:-1] * np.float32(self.num_train_timesteps))

    def step(self, model_output: torch.Tensor, i: int, sample: torch.Tensor,
             rng: Optional[Renoise] = None) -> torch.Tensor:
        """One step at position ``i``; the stochastic sampler takes its fresh
        noise from ``rng`` (`draw_renoise`)."""
        x, v = sample.float(), model_output.float()
        sig = self.table("sigmas", x.device)
        sigma, sigma_next = sig[i], sig[i + 1]
        denoised = x - v * sigma
        if self.stochastic:
            if rng is None:
                raise ValueError("the stochastic PCM-FM step needs its renoise (rng)")
            prev = (1.0 - sigma_next) * denoised + sigma_next * draw_renoise(rng, x)
        else:
            prev = x + (x - denoised) / sigma * (sigma_next - sigma)
        return prev.to(sample.dtype)
