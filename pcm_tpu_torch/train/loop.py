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
non-finite ``loss`` or ``d_loss`` there stops the run. Each log row also
holds the host's split of the window (`pcm_tpu/train/loop.py:207-227`):
``host_data_s`` (the step thread waiting for a batch), ``host_dispatch_s``
(the step calls), ``fence_s`` (the metrics readback), ``feed_iter_s`` (the
feeder waiting for the loader) and ``feed_put_s`` (the feeder's tensor
conversion and pinning). Checkpoints are ``torch.save`` files of {global
step, LoRA and its optimizer state, the heads and theirs, generator state}
under ``<output_dir>/checkpoints/``; each save also exports the LoRA as
``<output_dir>/pcm_lora_<step>.safetensors`` in kohya's format (fp16).

Batches come from a feeder thread that reads the data iterator, turns each
batch into host tensors (pinned for a CUDA run) and keeps `PREFETCH` of
them queued; the step thread copies each to the device ``non_blocking`` on
its own stream. A loader error is raised on the step thread. SIGTERM and
SIGINT (handlers installed when `run` is on the main thread, restored when
it returns) and `request_stop` end the run after the step in flight, with a
checkpoint, a kohya file and a ``preempted`` row. Not yet ported:
validation grids.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import signal
import threading
import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from ..core.schedule import DDPMSchedule
from ..lora.kohya import save_kohya_safetensors
from ..utils.threads import prefetch_thread
from .distill import DistillConfig, sample_draws, split_microbatches
from .state import TrainState

PREFETCH = 2  # batches the feeder keeps ready


@dataclasses.dataclass
class LoopConfig:
    output_dir: str
    max_train_steps: int
    checkpointing_steps: int = 500
    checkpoints_total_limit: Optional[int] = 5
    log_every: int = 10
    seed: int = 42
    resume: bool = True
    lora_alpha: float = 8.0


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
    adversarial ones over ``schedule`` when there are heads, and the VAE
    posterior's on a batch of pixels, shaped like ``latents_like(batch)``
    (the bundle's: a batch's cached latents, or what its pixels encode to)."""

    def __init__(self, loop_cfg: LoopConfig, frozen, state: TrainState, step: Callable,
                 distill_cfg: DistillConfig, schedule: DDPMSchedule, latents_like: Callable,
                 device: torch.device, grad_accum_steps: int = 1,
                 d_state: Optional[TrainState] = None):
        self.cfg = loop_cfg
        self.frozen = frozen
        self.state = state
        self.d_state = d_state
        self.step = step
        self.distill_cfg = distill_cfg
        self.adv_schedule = schedule if d_state is not None else None
        self.device = torch.device(device)
        self.accum = grad_accum_steps
        self.latents_like = latents_like
        self._stop_requested = False
        self.generator = torch.Generator(self.device).manual_seed(loop_cfg.seed)
        self.ckpt_dir = os.path.join(loop_cfg.output_dir, "checkpoints")
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.global_step = 0
        self.resumed_from: Optional[int] = None
        if loop_cfg.resume:
            self._try_resume()

    def request_stop(self) -> None:
        """End the run after the step in flight, with a checkpoint (any
        thread; the SIGTERM/SIGINT handler of `run` calls it)."""
        self._stop_requested = True

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
        save_kohya_safetensors(
            os.path.join(self.cfg.output_dir, f"pcm_lora_{self.global_step:07d}.safetensors"),
            payload["lora"], self.cfg.lora_alpha)
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

    def _prepared(self, data_iter: Iterator[Dict[str, np.ndarray]]):
        """The data iterator's batches as host tensors (pinned for a CUDA
        run), timed into the feeder's counters; the iterator is closed with
        this generator."""
        it = iter(data_iter)
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    b = next(it)
                except StopIteration:
                    return
                t1 = time.perf_counter()
                b = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
                if self.device.type == "cuda":
                    b = {k: v.pin_memory() for k, v in b.items()}
                self._feed_iter_s += t1 - t0
                self._feed_put_s += time.perf_counter() - t1
                yield b
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()

    def run(self, data_iter: Iterator[Dict[str, np.ndarray]],
            extra_batch: Optional[Dict[str, torch.Tensor]] = None) -> TrainState:
        """Steps until ``max_train_steps`` or a stop request, then a checkpoint.
        ``extra_batch`` is merged into every batch (the uncond embeds)."""
        cfg = self.cfg
        handlers = {}
        if threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGTERM, signal.SIGINT):
                handlers[sig] = signal.signal(sig, lambda signum, frame: self.request_stop())
        self._feed_iter_s = self._feed_put_s = 0.0
        feed = prefetch_thread(self._prepared(data_iter), PREFETCH, "pcm-batch-feeder")
        try:
            self._run_steps(feed, extra_batch)
            if self._stop_requested and self.global_step < cfg.max_train_steps:
                self._log({"preempted": 1})
                print(f"preempted at step {self.global_step}", flush=True)
            if not self.checkpoints() or not self.checkpoints()[-1].endswith(
                    f"step_{self.global_step:07d}.pt"):
                self.save()
        finally:
            feed.close()
            for sig, h in handlers.items():
                signal.signal(sig, h)
        return self.state

    def _next_batch(self, feed: Iterator, extra_batch) -> Dict[str, torch.Tensor]:
        try:
            item = next(feed)
        except StopIteration:
            raise StopIteration("data iterator exhausted before max_train_steps") from None
        batch = {k: v.to(self.device, non_blocking=True) for k, v in item.items()}
        batch.update(extra_batch or {})
        return batch

    def _run_steps(self, feed: Iterator, extra_batch) -> None:
        cfg = self.cfg
        t_last, step_last = time.perf_counter(), self.global_step
        t_data = t_dispatch = 0.0
        while self.global_step < cfg.max_train_steps and not self._stop_requested:
            t0 = time.perf_counter()
            batch = self._next_batch(feed, extra_batch)
            t1 = time.perf_counter()
            t_data += t1 - t0
            draws = []
            for mb in split_microbatches(batch, self.accum):
                draws.append(sample_draws(self.distill_cfg, self.generator, self.latents_like(mb),
                                          self.adv_schedule, posterior="pixel_values" in mb))
            self.state, self.d_state, metrics, counted = self.step(
                self.state, self.d_state, self.frozen, batch, draws, self.global_step)
            self.global_step += counted
            t_dispatch += time.perf_counter() - t1

            if self.global_step % cfg.log_every == 0:
                tf = time.perf_counter()
                row = {k: float(v) for k, v in metrics.items()}  # readback: a device sync
                now = time.perf_counter()
                row["step_ms"] = (now - t_last) * 1000.0 / (self.global_step - step_last)
                t_last, step_last = now, self.global_step
                if self.device.type == "cuda":
                    row["peak_gib"] = torch.cuda.max_memory_allocated(self.device) / 2 ** 30
                row.update(host_data_s=t_data, host_dispatch_s=t_dispatch, fence_s=now - tf,
                           feed_iter_s=self._feed_iter_s, feed_put_s=self._feed_put_s)
                self._feed_iter_s = self._feed_put_s = t_data = t_dispatch = 0.0
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

