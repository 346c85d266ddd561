"""The training loop (counterpart of `pcm_tpu/train/loop.py:Trainer`):
steps, metrics, checkpoints, resume, for consistency-only and adversarial
training.

Each step draws its noise, solver indices and guidance scales (and the
adversarial draws) from one ``torch.Generator`` on the training device,
seeded from ``seed`` and saved with every checkpoint, so a resumed run
continues the same stream. Adversarial training holds the student's state
and the discriminator heads' (``d_state``) and counts global steps itself:
its step (`train/adv.py:build_ddim_adv_train_step`) trains D on an even
global step and G on an odd one, each counting one, or both on one batch,
counting two (`pcm_tpu/train/loop.py:359-372`). Metrics are read
back (a device sync) only every ``log_every`` steps and go to
``<output_dir>/metrics.jsonl``: ``loss`` and ``grad_norm`` (with
``loss_cm`` and ``g_loss`` when adversarial) after a G update, ``d_loss``
and ``d_grad_norm`` after a D update, ``step_ms`` a global step. A
non-finite ``loss`` or ``d_loss`` there stops the run. Checkpoints are
``torch.save`` files of {global step, LoRA and its optimizer state, the
heads and theirs, generator state} under ``<output_dir>/checkpoints/``. Not yet
ported: kohya export, validation grids and the SIGTERM save.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from ..core.schedule import DDPMSchedule
from .distill import DistillConfig, sample_draws, split_microbatches
from .state import TrainState


@dataclasses.dataclass
class LoopConfig:
    output_dir: str
    max_train_steps: int
    checkpointing_steps: int = 500
    checkpoints_total_limit: Optional[int] = 5
    log_every: int = 10
    seed: int = 42
    resume: bool = True


def _to(tree, device):
    """Tensors of a nested dict/tuple/list moved to ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to(v, device) for v in tree)
    return tree


def _layout(tree):
    """Structure and shapes of a nested dict/tuple/list of tensors."""
    if isinstance(tree, torch.Tensor):
        return tuple(tree.shape), tree.dtype
    if isinstance(tree, dict):
        return {k: _layout(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_layout(v) for v in tree)
    return type(tree)


class Trainer:
    """Drives ``step(state, d_state, frozen, batch, draws, global_step) ->
    (state, d_state, metrics, global steps counted)`` to ``max_train_steps``
    global steps. ``d_state`` is the heads' state of an adversarial run,
    else None; the draws are `sample_draws`' for ``distill_cfg``, with the
    adversarial ones over ``schedule`` when there are heads."""

    def __init__(self, loop_cfg: LoopConfig, frozen, state: TrainState, step: Callable,
                 distill_cfg: DistillConfig, schedule: DDPMSchedule, device: torch.device,
                 grad_accum_steps: int = 1, d_state: Optional[TrainState] = None):
        self.cfg = loop_cfg
        self.frozen = frozen
        self.state = state
        self.d_state = d_state
        self.step = step
        self.distill_cfg = distill_cfg
        self.adv_schedule = schedule if d_state is not None else None
        self.device = torch.device(device)
        self.accum = grad_accum_steps
        self.generator = torch.Generator(self.device).manual_seed(loop_cfg.seed)
        self.ckpt_dir = os.path.join(loop_cfg.output_dir, "checkpoints")
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.global_step = 0
        self.resumed_from: Optional[int] = None
        if loop_cfg.resume:
            self._try_resume()

    # -- checkpoints ------------------------------------------------------
    def checkpoints(self):
        """Saved checkpoint paths, oldest first."""
        names = sorted(f for f in os.listdir(self.ckpt_dir)
                       if f.startswith("step_") and f.endswith(".pt"))
        return [os.path.join(self.ckpt_dir, f) for f in names]

    def save(self) -> str:
        path = os.path.join(self.ckpt_dir, f"step_{self.global_step:07d}.pt")
        payload = {"step": self.global_step, "lora": _to(self.state.params, "cpu"),
                   "opt_state": _to(self.state.opt_state, "cpu"), "lora_step": self.state.step,
                   "generator": self.generator.get_state()}
        if self.d_state is not None:
            payload.update(d_params=_to(self.d_state.params, "cpu"),
                           d_opt_state=_to(self.d_state.opt_state, "cpu"),
                           d_step=self.d_state.step)
        torch.save(payload, path + ".tmp")
        os.replace(path + ".tmp", path)
        limit = self.cfg.checkpoints_total_limit
        if limit:
            for old in self.checkpoints()[:-limit]:
                os.remove(old)
        return path

    def _try_resume(self) -> None:
        found = self.checkpoints()
        if not found:
            return
        ck = torch.load(found[-1], map_location="cpu", weights_only=True)
        ours = {"lora": self.state.params, "opt_state": self.state.opt_state}
        if self.d_state is not None:
            ours.update(d_params=self.d_state.params, d_opt_state=self.d_state.opt_state)
        theirs = {k: ck[k] for k in ("lora", "opt_state", "d_params", "d_opt_state") if k in ck}
        if _layout(theirs) != _layout(_to(ours, "cpu")):
            raise ValueError(f"{found[-1]} does not match this run's adapter, heads or "
                             "optimizers (another recipe, rank or --use-8bit-adam?): pass "
                             "--no-resume or another --output-dir")
        self.global_step = self.resumed_from = int(ck["step"])
        self.state = TrainState(step=int(ck.get("lora_step", ck["step"])),
                                params=_to(ck["lora"], self.device),
                                opt_state=_to(ck["opt_state"], self.device))
        if self.d_state is not None:
            self.d_state = TrainState(step=int(ck["d_step"]),
                                      params=_to(ck["d_params"], self.device),
                                      opt_state=_to(ck["d_opt_state"], self.device))
        self.generator.set_state(ck["generator"])

    # -- loop -------------------------------------------------------------
    def _log(self, metrics: Dict[str, float]) -> None:
        with open(os.path.join(self.cfg.output_dir, "metrics.jsonl"), "a") as f:
            f.write(json.dumps({"step": self.global_step, "time": time.time(), **metrics}) + "\n")

    def run(self, data_iter: Iterator[Dict[str, np.ndarray]],
            extra_batch: Optional[Dict[str, torch.Tensor]] = None) -> TrainState:
        """Steps until ``max_train_steps``, then a final checkpoint.
        ``extra_batch`` is merged into every batch (the uncond embeds)."""
        cfg = self.cfg
        t_last, step_last = time.perf_counter(), self.global_step
        while self.global_step < cfg.max_train_steps:
            batch = {k: torch.from_numpy(v).to(self.device) for k, v in next(data_iter).items()}
            batch.update(extra_batch or {})
            draws = [sample_draws(self.distill_cfg, self.generator, mb["latents"],
                                  self.adv_schedule)
                     for mb in split_microbatches(batch, self.accum)]
            self.state, self.d_state, metrics, counted = self.step(
                self.state, self.d_state, self.frozen, batch, draws, self.global_step)
            self.global_step += counted

            if self.global_step % cfg.log_every == 0:
                row = {k: float(v) for k, v in metrics.items()}  # readback: a device sync
                now = time.perf_counter()
                row["step_ms"] = (now - t_last) * 1000.0 / (self.global_step - step_last)
                t_last, step_last = now, self.global_step
                if self.device.type == "cuda":
                    row["peak_gib"] = torch.cuda.max_memory_allocated(self.device) / 2 ** 30
                self._log(row)
                print(f"step {self.global_step}: " + " ".join(
                    f"{k}={v:.6g}" for k, v in row.items()), flush=True)
                bad = {k: row[k] for k in ("loss", "d_loss")
                       if k in row and not math.isfinite(row[k])}
                if bad:
                    raise FloatingPointError(
                        f"non-finite {bad} at step {self.global_step} "
                        f"(last checkpoint: {self.checkpoints()[-1:] or 'none'})")
            if cfg.checkpointing_steps and self.global_step % cfg.checkpointing_steps == 0:
                self.save()
        if not self.checkpoints() or not self.checkpoints()[-1].endswith(
                f"step_{self.global_step:07d}.pt"):
            self.save()
        return self.state
