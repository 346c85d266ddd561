"""Phased solvers of phased consistency distillation (counterpart of
`pcm_tpu/core/solver.py`): DDIM in epsilon space (SD1.5, SDXL) and Euler in
flow space (SD3).

The student maps any point of the PF-ODE trajectory to the start of its
phase, the largest boundary grid point at or below it. The solver holds the
discrete grid (``num_solver_steps`` of the 1000 training steps) and, over a
batch of per-sample grid indices, takes one solver step, the jump to the
phase start, and the target network's boundary scalings.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .schedule import DDPMSchedule, DeviceTables, FlowSchedule, bcast


def solver_grid(num_train_timesteps: int, num_solver_steps: int) -> np.ndarray:
    """``arange(1, S+1) * (T // S) - 1``: T=1000, S=50 -> [19, 39, ..., 999]."""
    step_ratio = num_train_timesteps // num_solver_steps
    return (np.arange(1, num_solver_steps + 1) * step_ratio).round().astype(np.int64) - 1


def phase_boundaries(num_solver_steps: int, multiphase: int) -> np.ndarray:
    """Grid indices of the phase starts, floor-linspace without the endpoint:
    S=50, multiphase=4 -> [0, 12, 25, 37]."""
    idx = np.linspace(0, num_solver_steps, num=multiphase, endpoint=False)
    return np.floor(idx).astype(np.int64)


def last_boundary_at_or_below(index: torch.Tensor, boundaries: torch.Tensor) -> torch.Tensor:
    """For each sample index, the largest boundary <= index (boundaries sorted
    ascending, boundaries[0] == 0): searchsorted with side="right", minus one."""
    pos = torch.searchsorted(boundaries, index, right=True) - 1
    return boundaries[pos]


def boundary_scalings(index: torch.Tensor, boundaries: torch.Tensor, ndim: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Target-network boundary conditions: c_skip = [index is a boundary],
    c_out = 1 - c_skip, fp32, broadcast to ``ndim``."""
    c_skip = (index[:, None] == boundaries[None, :]).any(dim=-1).float()
    return bcast(c_skip, ndim), bcast(1.0 - c_skip, ndim)


@dataclasses.dataclass(frozen=True)
class PhasedDDIMSolver(DeviceTables):
    """Epsilon-space phased solver over a discrete DDIM grid. Every table has
    shape (S,); the ``*_prev`` tables are shifted one grid point toward t = 0
    (element 0 clamped to training timestep 0)."""

    timesteps: np.ndarray  # int64 (S,)
    timesteps_prev: np.ndarray  # int64 (S,)
    alpha_cumprods: np.ndarray  # float32 (S,)
    alpha_cumprods_prev: np.ndarray  # float32 (S,)

    @classmethod
    def create(cls, schedule: DDPMSchedule, num_solver_steps: int = 50) -> "PhasedDDIMSolver":
        grid = solver_grid(schedule.num_train_timesteps, num_solver_steps)
        ac = np.asarray(schedule.alphas_cumprod, np.float32)
        return cls(
            timesteps=grid,
            timesteps_prev=np.concatenate([[0], grid[:-1]]).astype(np.int64),
            alpha_cumprods=ac[grid],
            alpha_cumprods_prev=np.concatenate([ac[:1], ac[grid[:-1]]]).astype(np.float32),
        )

    @property
    def num_steps(self) -> int:
        return int(self.timesteps.shape[0])

    def _jump(self, pred_x0, pred_noise, grid_index):
        a_prev = bcast(self.table("alpha_cumprods_prev", pred_x0.device)[grid_index], pred_x0.ndim)
        return torch.sqrt(a_prev) * pred_x0 + torch.sqrt(1.0 - a_prev) * pred_noise

    def ddim_step(self, pred_x0: torch.Tensor, pred_noise: torch.Tensor,
                  index: torch.Tensor) -> torch.Tensor:
        """One DDIM step from grid point ``index`` to the previous grid point."""
        return self._jump(pred_x0, pred_noise, index)

    def multiphase_pred(self, pred_x0: torch.Tensor, pred_noise: torch.Tensor,
                        index: torch.Tensor, multiphase: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Jump from grid point ``index`` to the start of its phase; returns
        (x at the phase start, training timestep of the phase start)."""
        boundaries = torch.from_numpy(phase_boundaries(self.num_steps, multiphase)).to(index.device)
        b = last_boundary_at_or_below(index, boundaries)
        return (self._jump(pred_x0, pred_noise, b),
                self.table("timesteps_prev", index.device)[b])


@dataclasses.dataclass(frozen=True)
class PhasedEulerSolver(DeviceTables):
    """Flow-space phased solver (SD3, `pcm_tpu/core/solver.py:127-186`):
    Euler steps ``x' = x + (sigma' - sigma) * v`` on the shifted sigma grid.
    Tables as `PhasedDDIMSolver`'s, sigmas in place of alphas."""

    timesteps: np.ndarray  # int64 (S,) indices into the training table
    timesteps_prev: np.ndarray  # int64 (S,)
    sigmas: np.ndarray  # float32 (S,)
    sigmas_prev: np.ndarray  # float32 (S,)

    @classmethod
    def create(cls, schedule: FlowSchedule, num_solver_steps: int = 100) -> "PhasedEulerSolver":
        grid = solver_grid(schedule.num_train_timesteps, num_solver_steps)
        sig = np.asarray(schedule.sigmas, np.float32)
        return cls(
            timesteps=grid,
            timesteps_prev=np.concatenate([[0], grid[:-1]]).astype(np.int64),
            sigmas=sig[grid],
            sigmas_prev=np.concatenate([sig[:1], sig[grid[:-1]]]).astype(np.float32),
        )

    @property
    def num_steps(self) -> int:
        return int(self.timesteps.shape[0])

    def euler_step(self, sample: torch.Tensor, velocity: torch.Tensor,
                   index: torch.Tensor) -> torch.Tensor:
        """One Euler step from grid point ``index`` to the previous grid point."""
        sigma = bcast(self.table("sigmas", sample.device)[index], sample.ndim)
        sigma_prev = bcast(self.table("sigmas_prev", sample.device)[index], sample.ndim)
        return sample + (sigma_prev - sigma) * velocity

    def multiphase_pred(self, sample: torch.Tensor, velocity: torch.Tensor, index: torch.Tensor,
                        multiphase: int, is_target: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Euler jump from grid point ``index`` to the start of its phase;
        returns (x at the phase start, the phase start's grid index). With
        ``is_target`` the sample sits at ``sigmas_prev[index]`` (the
        stop-grad target's input, one solver step on) instead of ``sigmas[index]``."""
        boundaries = torch.from_numpy(phase_boundaries(self.num_steps, multiphase)).to(index.device)
        b = last_boundary_at_or_below(index, boundaries)
        src = self.table("sigmas_prev" if is_target else "sigmas", sample.device)[index]
        sigma = bcast(src, sample.ndim)
        sigma_end = bcast(self.table("sigmas_prev", sample.device)[b], sample.ndim)
        return sample + (sigma_end - sigma) * velocity, b
