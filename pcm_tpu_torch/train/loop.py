"""The training loop (counterpart of the consistency-only part of
`pcm_tpu/train/loop.py:Trainer`): steps, metrics, checkpoints, resume.

Each step draws its noise, solver indices and guidance scales from one
``torch.Generator`` on the training device, seeded from ``seed`` and saved
with every checkpoint, so a resumed run continues the same stream. Metrics
are read back (a device sync) only every ``log_every`` steps and go to
``<output_dir>/metrics.jsonl``; a non-finite loss there stops the run.
Checkpoints are ``torch.save`` files of {step, LoRA, optimizer state,
generator state} under ``<output_dir>/checkpoints/``. Not yet ported: the
adversarial alternation, kohya export, validation grids and the SIGTERM save.
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
    """Drives ``step_fn(state, frozen, batch, draws)`` to ``max_train_steps``."""

    def __init__(self, loop_cfg: LoopConfig, frozen, state: TrainState, step_fn: Callable,
                 distill_cfg: DistillConfig, device: torch.device, grad_accum_steps: int = 1):
        self.cfg = loop_cfg
        self.frozen = frozen
        self.state = state
        self.step_fn = step_fn
        self.distill_cfg = distill_cfg
        self.device = torch.device(device)
        self.accum = grad_accum_steps
        self.generator = torch.Generator(self.device).manual_seed(loop_cfg.seed)
        self.ckpt_dir = os.path.join(loop_cfg.output_dir, "checkpoints")
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.resumed_from: Optional[int] = None
        if loop_cfg.resume:
            self._try_resume()

    @property
    def global_step(self) -> int:
        return self.state.step

    # -- checkpoints ------------------------------------------------------
    def checkpoints(self):
        """Saved checkpoint paths, oldest first."""
        names = sorted(f for f in os.listdir(self.ckpt_dir)
                       if f.startswith("step_") and f.endswith(".pt"))
        return [os.path.join(self.ckpt_dir, f) for f in names]

    def save(self) -> str:
        path = os.path.join(self.ckpt_dir, f"step_{self.global_step:07d}.pt")
        payload = {"step": self.global_step, "lora": _to(self.state.params, "cpu"),
                   "opt_state": _to(self.state.opt_state, "cpu"),
                   "generator": self.generator.get_state()}
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
        if (_layout(ck["lora"]), _layout(ck["opt_state"])) != (
                _layout(_to(self.state.params, "cpu")), _layout(_to(self.state.opt_state, "cpu"))):
            raise ValueError(f"{found[-1]} does not match this run's adapter or optimizer "
                             "(another recipe, rank or --use-8bit-adam?): pass --no-resume "
                             "or another --output-dir")
        self.state = TrainState(step=int(ck["step"]), params=_to(ck["lora"], self.device),
                                opt_state=_to(ck["opt_state"], self.device))
        self.generator.set_state(ck["generator"])
        self.resumed_from = self.global_step

    # -- loop -------------------------------------------------------------
    def _log(self, metrics: Dict[str, float]) -> None:
        with open(os.path.join(self.cfg.output_dir, "metrics.jsonl"), "a") as f:
            f.write(json.dumps({"step": self.global_step, "time": time.time(), **metrics}) + "\n")

    def run(self, data_iter: Iterator[Dict[str, np.ndarray]],
            extra_batch: Optional[Dict[str, torch.Tensor]] = None) -> TrainState:
        """Steps until ``max_train_steps``, then a final checkpoint.
        ``extra_batch`` is merged into every batch (the uncond embeds)."""
        cfg = self.cfg
        t_last = time.perf_counter()
        while self.global_step < cfg.max_train_steps:
            batch = {k: torch.from_numpy(v).to(self.device) for k, v in next(data_iter).items()}
            batch.update(extra_batch or {})
            draws = [sample_draws(self.distill_cfg, self.generator, mb["latents"])
                     for mb in split_microbatches(batch, self.accum)]
            self.state, metrics = self.step_fn(self.state, self.frozen, batch, draws)

            if self.global_step % cfg.log_every == 0:
                row = {k: float(v) for k, v in metrics.items()}  # readback: a device sync
                now = time.perf_counter()
                row["step_ms"] = (now - t_last) * 1000.0 / cfg.log_every
                t_last = now
                if self.device.type == "cuda":
                    row["peak_gib"] = torch.cuda.max_memory_allocated(self.device) / 2 ** 30
                self._log(row)
                print(f"step {self.global_step}: " + " ".join(
                    f"{k}={v:.6g}" for k, v in row.items()), flush=True)
                if not math.isfinite(row["loss"]):
                    raise FloatingPointError(
                        f"non-finite loss {row['loss']} at step {self.global_step} "
                        f"(last checkpoint: {self.checkpoints()[-1:] or 'none'})")
            if cfg.checkpointing_steps and self.global_step % cfg.checkpointing_steps == 0:
                self.save()
        if not self.checkpoints() or not self.checkpoints()[-1].endswith(
                f"step_{self.global_step:07d}.pt"):
            self.save()
        return self.state
