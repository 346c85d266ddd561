"""The phased-consistency distillation step in plain PyTorch: the DDPM
(SD1.5 / SDXL) and shifted-flow (SD3) schedules, the phased DDIM and Euler
solvers, the CFG teacher, the stop-grad target, the student's pseudo-Huber
loss, its gradient w.r.t. the LoRA factors, global-norm clipping and AdamW.

It follows the trainer from the same inputs: the cache files the benchmark
wrote, read and ordered as a seeded shuffle over their rows, the draws of a
generator seeded as the trainer's, and the adapter the benchmark drew. The
batch is processed in blocks of rows so that an un-checkpointed fp32 model
fits the card; the loss is a mean over rows, so the blocks' means and
gradients, weighted by their share of the batch, add up to the batch's.
"""

from __future__ import annotations

import os
import random
from typing import Callable, Dict, List, Mapping

import numpy as np
import torch


# -- schedules and solvers -----------------------------------------------------

def ddpm_alphas_cumprod(num_train_timesteps: int = 1000, beta_start: float = 0.00085,
                        beta_end: float = 0.012) -> np.ndarray:
    """The scaled-linear DDPM schedule of SD1.5 / SDXL, fp32."""
    betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, num_train_timesteps,
                        dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas).astype(np.float32)


def flow_sigmas(num_train_timesteps: int = 1000, shift: float = 3.0) -> np.ndarray:
    """SD3's shifted sigmas, ascending in training timestep, fp32."""
    s = np.arange(1, num_train_timesteps + 1, dtype=np.float64) / num_train_timesteps
    return (shift * s / (1.0 + (shift - 1.0) * s)).astype(np.float32)


def solver_grid(num_train_timesteps: int, num_solver_steps: int) -> np.ndarray:
    ratio = num_train_timesteps // num_solver_steps
    return (np.arange(1, num_solver_steps + 1) * ratio).round().astype(np.int64) - 1


def phase_boundaries(num_solver_steps: int, multiphase: int) -> np.ndarray:
    return np.floor(np.linspace(0, num_solver_steps, num=multiphase,
                                endpoint=False)).astype(np.int64)


def _bc(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape + (1,) * (like.ndim - x.ndim))


def _huber(pred: torch.Tensor, target: torch.Tensor, c: float) -> torch.Tensor:
    d = pred.float() - target.float()
    return torch.mean(torch.sqrt(d * d + c * c) - c)


def _cfg(cond: torch.Tensor, uncond: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return cond + _bc(w, cond) * (cond - uncond)


# -- inputs --------------------------------------------------------------------

def read_cache(cache_dir: str) -> Dict[str, np.ndarray]:
    """Every key of the ``shard_*.npz`` files, concatenated in file-name order."""
    files = sorted(f for f in os.listdir(cache_dir) if f.startswith("shard_")
                   and f.endswith(".npz"))
    parts: Dict[str, List[np.ndarray]] = {}
    for f in files:
        with np.load(os.path.join(cache_dir, f)) as z:
            for k in z.files:
                parts.setdefault(k, []).append(z[k])
    return {k: np.concatenate(v) for k, v in parts.items()}


def batch_rows(n_rows: int, batch: int, seed: int, steps: int) -> List[List[int]]:
    """The rows of the first ``steps`` batches: an epoch is a seeded shuffle
    of all rows cut into whole batches, its ragged tail dropped."""
    rng, out = random.Random(seed), []
    while len(out) < steps:
        order = list(range(n_rows))
        rng.shuffle(order)
        for i in range(0, n_rows - batch + 1, batch):
            out.append(order[i:i + batch])
    return out[:steps]


def draws(gen: torch.Generator, shape, steps_n: int, w_range, fixed_w, device) -> Dict:
    """One batch's draws in the trainer's order: Gaussian noise shaped like
    the latents, grid indices in [0, S), guidance scales in [w_min, w_max)
    unless fixed."""
    n = shape[0]
    noise = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    index = torch.randint(0, steps_n, (n,), generator=gen, device=device)
    if fixed_w is not None:
        w = torch.full((n,), float(fixed_w), device=device)
    else:
        w = torch.rand((n,), generator=gen, device=device) * (w_range[1] - w_range[0]) + w_range[0]
    return {"noise": noise, "index": index, "w": w}


# -- the step --------------------------------------------------------------------

class Distill:
    """One family's step. ``model(x_nhwc, t, cond, lora) -> (N, h, w, C)``
    in fp32; ``traffic``: the workload's ``distill`` group (num_solver_steps,
    multiphase, w_min / w_max or fixed_w, huber_c; ``schedule``: ddpm | flow)."""

    def __init__(self, model: Callable, traffic: Mapping, device):
        self.model, self.t, self.device = model, traffic, torch.device(device)
        s = traffic["num_solver_steps"]
        self.flow = traffic["schedule"] == "flow"
        grid = solver_grid(1000, s)
        dev = self.device
        self.bounds = torch.from_numpy(phase_boundaries(s, traffic["multiphase"])).to(dev)
        if self.flow:
            sig = flow_sigmas(1000, traffic.get("shift", 3.0))
            self.sig = torch.from_numpy(sig[grid]).to(dev)
            self.sig_prev = torch.from_numpy(
                np.concatenate([sig[:1], sig[grid[:-1]]]).astype(np.float32)).to(dev)
        else:
            ac = ddpm_alphas_cumprod()
            self.ac = torch.from_numpy(ac).to(dev)
            self.timesteps = torch.from_numpy(grid).to(dev)
            self.timesteps_prev = torch.from_numpy(
                np.concatenate([[0], grid[:-1]]).astype(np.int64)).to(dev)
            self.ac_prev = torch.from_numpy(
                np.concatenate([ac[:1], ac[grid[:-1]]]).astype(np.float32)).to(dev)
            self.topk = 1000 // s

    def _phase_start(self, index):
        return self.bounds[torch.searchsorted(self.bounds, index, right=True) - 1]

    def _ddim_jump(self, x0, eps, grid_index):
        a = _bc(self.ac_prev[grid_index], x0)
        return torch.sqrt(a) * x0 + torch.sqrt(1.0 - a) * eps

    def _x0(self, eps, t, x):
        a = _bc(self.ac[t], x)
        return (x - torch.sqrt(1.0 - a) * eps) / torch.sqrt(a)

    def loss(self, latents, cond, uncond, dr, lora_target, lora) -> torch.Tensor:
        """The consistency loss of a block of rows; differentiable in ``lora``."""
        noise, index, w = dr["noise"], dr["index"].long(), dr["w"]
        both = {k: torch.cat([cond[k], uncond[k]]) for k in cond}
        b = self._phase_start(index)
        with torch.no_grad():
            if self.flow:
                sigma, sigma_prev = self.sig[index], self.sig_prev[index]
                t, t_prev = sigma * 1000.0, sigma_prev * 1000.0
                noisy = _bc(sigma, latents) * noise + (1.0 - _bc(sigma, latents)) * latents
                c_out, u_out = self.model(torch.cat([noisy, noisy]), torch.cat([t, t]),
                                          both, None).chunk(2)
                x_prev = noisy + _bc(sigma_prev - sigma, noisy) * _cfg(c_out, u_out, w)
                target_out = self.model(x_prev, t_prev, cond, lora_target)
                target = x_prev + _bc(self.sig_prev[b] - sigma_prev, x_prev) * target_out
            else:
                t = self.timesteps[index]
                t_prev = torch.clamp(t - self.topk, min=0)
                a = _bc(self.ac[t], latents)
                noisy = torch.sqrt(a) * latents + torch.sqrt(1.0 - a) * noise
                c_out, u_out = self.model(torch.cat([noisy, noisy]), torch.cat([t, t]),
                                          both, None).chunk(2)
                pred_x0 = _cfg(self._x0(c_out, t, noisy), self._x0(u_out, t, noisy), w)
                x_prev = self._ddim_jump(pred_x0, _cfg(c_out, u_out, w), index)
                target_out = self.model(x_prev, t_prev, cond, lora_target)
                jump = self._ddim_jump(self._x0(target_out, t_prev, x_prev), target_out, b)
                c_skip = _bc((index[:, None] == self.bounds[None, :]).any(-1).float(), x_prev)
                target = c_skip * x_prev + (1.0 - c_skip) * jump
        if self.flow:
            v = self.model(noisy, t, cond, lora)
            pred = noisy + _bc(self.sig_prev[b] - self.sig[index], noisy) * v
        else:
            eps = self.model(noisy, t, cond, lora)
            pred = self._ddim_jump(self._x0(eps, t, noisy), eps, b)
        return _huber(pred, target, self.t.get("huber_c", 0.001))


def adam_corrections(b1: float, b2: float, count: int):
    one, n = np.float32(1.0), np.float32(count)
    return float(one - np.float32(b1) ** n), float(one - np.float32(b2) ** n)


def train(distill: Distill, lora0: Mapping[str, torch.Tensor], batches: List[Dict],
          batch_draws: List[Dict], cond_of: Callable, lr: float, rows_per_block: int,
          max_grad_norm: float = 1.0, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8) -> Dict:
    """The steps over ``batches`` from adapter ``lora0``: each step's loss,
    the first step's clipped gradient (as AdamW takes it) and the adapter
    after the last step. ``cond_of(batch rows) -> (latents, cond, uncond)``."""
    params = {k: v.detach().clone().float() for k, v in lora0.items()}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, first_grad = [], None
    for count, (batch, dr) in enumerate(zip(batches, batch_draws), start=1):
        n = next(iter(batch.values())).shape[0]
        grads = {k: torch.zeros_like(v) for k, v in params.items()}
        total = 0.0
        for r0 in range(0, n, rows_per_block):
            rows = slice(r0, min(n, r0 + rows_per_block))
            share = (rows.stop - rows.start) / n
            latents, cond, uncond = cond_of({k: v[rows] for k, v in batch.items()})
            lora = {k: p.detach().requires_grad_(True) for k, p in params.items()}
            loss = distill.loss(latents, cond, uncond, {k: v[rows] for k, v in dr.items()},
                                params, lora)
            g = torch.autograd.grad(loss, list(lora.values()))
            for k, gk in zip(lora, g):
                grads[k].add_(gk, alpha=share)
            total += float(loss.detach()) * share
            del lora, loss, g
        losses.append(total)
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        if float(norm) >= max_grad_norm:
            grads = {k: g / norm * max_grad_norm for k, g in grads.items()}
        if first_grad is None:
            first_grad = {k: g.clone() for k, g in grads.items()}
        c1, c2 = adam_corrections(b1, b2, count)
        for k, g in grads.items():
            mu[k] = (1 - b1) * g + b1 * mu[k]
            nu[k] = (1 - b2) * (g * g) + b2 * nu[k]
            params[k] = params[k] - lr * ((mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps))
    return {"losses": losses, "first_grad": first_grad, "params": params}
