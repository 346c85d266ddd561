"""DDPM noise-schedule tables (counterpart of `pcm_tpu/core/schedule.py`).

Host-side fp32 tables; the sampler reads scalars from them, so nothing here
runs on the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DDPMSchedule:
    """``alphas_cumprod[t]``: cumulative product of (1 - beta) through step t."""

    num_train_timesteps: int
    betas: np.ndarray  # (T,) float32
    alphas_cumprod: np.ndarray  # (T,) float32
    prediction_type: str = "epsilon"  # or "v_prediction"


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
