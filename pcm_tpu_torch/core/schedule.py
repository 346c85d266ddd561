"""Noise-schedule tables of the DDPM (SD1.5, SDXL) and flow-matching (SD3)
teachers (counterpart of `pcm_tpu/core/schedule.py`).

Host-side fp32 tables. The samplers read scalars from them; the training
steps gather per-sample coefficients from a copy of each table on the device
of its tensors (`DeviceTables`), made once per device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..utils import profiling


class DeviceTables:
    """Mixin of the frozen table dataclasses: ``table(name, device)`` is the
    named numpy field as a tensor on ``device``, copied there once."""

    def table(self, name: str, device: torch.device) -> torch.Tensor:
        cache = self.__dict__.setdefault("_device_tables", {})
        key = (name, torch.device(device))
        if key not in cache:
            with profiling.span("wait.device_table"):  # a pageable copy: the host waits
                cache[key] = torch.from_numpy(np.asarray(getattr(self, name))).to(device)
        return cache[key]


def bcast(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """Right-pad ``x``'s shape with singleton dims up to ``ndim`` (`_bcast`)."""
    return x.reshape(x.shape + (1,) * (ndim - x.ndim)) if x.ndim < ndim else x


@dataclasses.dataclass(frozen=True)
class DDPMSchedule(DeviceTables):
    """``alphas_cumprod[t]``: cumulative product of (1 - beta) through step t.

    The methods take per-sample integer timesteps ``t`` (N,) and tensors whose
    leading dim is N, and compute in fp32 (`pcm_tpu/core/schedule.py:47-95`).
    """

    num_train_timesteps: int
    betas: np.ndarray  # (T,) float32
    alphas_cumprod: np.ndarray  # (T,) float32
    prediction_type: str = "epsilon"  # or "v_prediction"

    def _coefs(self, t: torch.Tensor, like: torch.Tensor):
        """(sqrt(a_t), sqrt(1 - a_t)) broadcast against ``like``."""
        a = self.table("alphas_cumprod", like.device)[t.long()]
        return bcast(torch.sqrt(a), like.ndim), bcast(torch.sqrt(1.0 - a), like.ndim)

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """q(x_t | x_0): sqrt(a_t) x0 + sqrt(1-a_t) eps."""
        a, s = self._coefs(t, x0)
        return a * x0 + s * noise

    def noise_travel(self, x_cur: torch.Tensor, noise: torch.Tensor, t_cur: torch.Tensor,
                     t_tgt: torch.Tensor) -> torch.Tensor:
        """Re-noise from ``t_cur`` to a later ``t_tgt`` with the ratio
        r = a_tgt / a_cur: sqrt(r) x + sqrt(1-r) eps."""
        ac = self.table("alphas_cumprod", x_cur.device)
        r = ac[t_tgt.long()] / ac[t_cur.long()]
        return bcast(torch.sqrt(r), x_cur.ndim) * x_cur + bcast(torch.sqrt(1.0 - r), x_cur.ndim) * noise

    def velocity(self, x0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """v-prediction target: sqrt(a_t) eps - sqrt(1-a_t) x0."""
        a, s = self._coefs(t, x0)
        return a * noise - s * x0

    def predicted_origin(self, model_output: torch.Tensor, t: torch.Tensor,
                         sample: torch.Tensor, prediction_type: Optional[str] = None
                         ) -> torch.Tensor:
        """x0 from an epsilon- or v-prediction at per-sample t."""
        pt = prediction_type or self.prediction_type
        a, s = self._coefs(t, sample)
        if pt == "epsilon":
            return (sample - s * model_output) / a
        if pt == "v_prediction":
            return a * sample - s * model_output
        raise ValueError(f"unknown prediction_type: {pt}")


def make_ddpm_schedule(num_train_timesteps: int = 1000, beta_start: float = 0.00085,
                       beta_end: float = 0.012, beta_schedule: str = "scaled_linear",
                       prediction_type: str = "epsilon") -> DDPMSchedule:
    """Build the DDPM tables (defaults: the SD1.x convention)."""
    if beta_schedule == "linear":
        betas = np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float64)
    elif beta_schedule == "scaled_linear":
        betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, num_train_timesteps,
                            dtype=np.float64) ** 2
    elif beta_schedule == "squaredcos_cap_v2":
        def alpha_bar(u):
            return np.cos((u + 0.008) / 1.008 * np.pi / 2) ** 2

        ts = np.arange(num_train_timesteps, dtype=np.float64)
        betas = np.minimum(1.0 - alpha_bar((ts + 1) / num_train_timesteps)
                           / alpha_bar(ts / num_train_timesteps), 0.999)
    else:
        raise ValueError(f"unknown beta_schedule: {beta_schedule}")
    return DDPMSchedule(
        num_train_timesteps=num_train_timesteps,
        betas=betas.astype(np.float32),
        alphas_cumprod=np.cumprod(1.0 - betas).astype(np.float32),
        prediction_type=prediction_type,
    )


@dataclasses.dataclass(frozen=True)
class FlowSchedule(DeviceTables):
    """Shifted rectified-flow sigmas, ascending in training timestep:
    ``sigmas[t] = shift*s / (1 + (shift-1)*s)`` with ``s = (t+1)/T``
    (`pcm_tpu/core/schedule.py:135-155`). Noising is ``x_t = sigma*eps +
    (1-sigma)*x0``; the model predicts the velocity ``v ~ eps - x0``."""

    num_train_timesteps: int
    shift: float
    sigmas: np.ndarray  # (T,) float32, ascending

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor, sigma: torch.Tensor
                  ) -> torch.Tensor:
        """``sigma * noise + (1 - sigma) * x0`` with per-sample fp32 ``sigma`` (N,)."""
        s = bcast(sigma, x0.ndim)
        return s * noise + (1.0 - s) * x0


def make_flow_schedule(num_train_timesteps: int = 1000, shift: float = 3.0) -> FlowSchedule:
    """The default shift 3.0 is SD3's, which its trainers and samplers use."""
    s = np.arange(1, num_train_timesteps + 1, dtype=np.float64) / num_train_timesteps
    sigmas = shift * s / (1.0 + (shift - 1.0) * s)
    return FlowSchedule(num_train_timesteps=num_train_timesteps, shift=shift,
                        sigmas=sigmas.astype(np.float32))
