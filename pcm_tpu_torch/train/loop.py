"""The training loop (counterpart of `pcm_tpu/train/loop.py:Trainer`):
steps, metrics, checkpoints, resume, validation grids, for
consistency-only and adversarial training.

Each step draws its noise, solver indices and guidance scales (and the
adversarial draws) from one ``torch.Generator`` on the training device,
seeded from ``seed`` and saved with every checkpoint, so a resumed run
continues the same stream. Adversarial training holds the student's state
and the discriminator heads' (``d_state``) and counts global steps itself:
its step (`train/adv.py:build_adv_train_step`) trains D on an even
global step and G on an odd one, each counting one, or both on one batch,
counting two (`pcm_tpu/train/loop.py:359-372`). Metrics are read
back (a device sync) only every ``log_every`` steps and go to
``<output_dir>/metrics.jsonl`` (`utils/logging.py:MetricsLogger`):
``loss`` and ``grad_norm`` (with ``loss_cm`` and ``g_loss`` when
adversarial) after a G update, ``d_loss`` and ``d_grad_norm`` after a D
update, ``prodigy_d`` under Prodigy, ``step_ms`` a global step (validation
excluded). A non-finite ``loss``, ``d_loss`` or ``g_loss`` there raises
FloatingPointError naming the step and the last checkpoint's. Each log row
also holds the host's split of the window (`pcm_tpu/train/loop.py:207-227`):
``host_data_s`` (the step thread waiting for a batch), ``host_dispatch_s``
(the step calls), ``fence_s`` (the metrics readback), ``feed_iter_s`` (the
feeder waiting for the loader), ``feed_put_s`` (the feeder's tensor
conversion and pinning), ``save_s`` (the step thread in `save`),
``save_wait_s`` (of it, waiting for the write before) and ``write_s`` (the
last finished write's seconds on the writer thread).

The row also holds the program's spans since the row before
(`utils/profiling.py`), which tile the step: the Trainer's ``data`` (the wait
for a batch and its copy to the device), ``draws``, ``call`` (the step call)
and ``readback``, and inside a consistency step's call (`train/distill.py`)
its phases ``teacher`` (noising, the CFG teacher forward, the solver step),
``target`` (the target forward and its jump), ``student.forward`` (through
the loss), ``student.backward`` and ``optimizer`` (the microbatches' mean,
the all-reduce, clipping, the norm, the update). Each gives
``<span>_host_s`` (host seconds) and, on the card, ``<span>_device_s`` (the
card's seconds from reaching the span to leaving it, idle included) and,
on steps that follow a readback, ``<span>_lead_s`` (how far the card's end
of the span trailed the host's, at its last close: the card's end maps onto
the host clock through the anchor recorded after the readback before), with
dots as underscores (``student_forward_host_s``). ``step_device_s`` is the
card's time from that anchor to the end of the readback: the steps' time on
the card. ``host_wait_s`` / ``host_waits`` are the seconds and number of the
``wait.<site>`` spans, each around a place where the host blocks until the
card has drained its queue (a pageable copy to the card, a host-group
all-reduce); ``attn_device_s`` / ``attn_calls`` those of the ``attention``
spans (`ops/flash_attention.py`: each forward, recomputed ones included,
and each backward). The counters follow under their own names:
``optimizer_flat_leaves``, the leaves AdamW updated through its flat vector
(`train/state.py`; summed over the updates: the adapter's leaf count a
consistency step).

Every ``validation_steps`` global steps ``validation_fn(frozen, lora,
step)`` returns tagged image batches in [-1, 1] (``{"cfg1": ..., "cfg7.5":
...}``), logged as 4-column grids ``images/validation/<tag>_<step>.png``
and timed into a ``validation_s`` row.

Checkpoints are ``torch.save`` files of {global step, LoRA and its optimizer
state, the heads and theirs, generator state} under
``<output_dir>/checkpoints/``; each save also exports the LoRA as
``<output_dir>/pcm_lora_<step>.safetensors`` in kohya's format (fp16), its
keys under ``kohya_prefix`` (``lora_unet``; SD3's ``lora_transformer``).
Saves are asynchronous, as orbax's manager saves the JAX package's: the
step thread copies the state into a pinned host twin (one allocation, made
before the first step) on the current stream and records an event (the
generator's state is taken there too); one
writer thread at a time waits on the event, writes each file to ``.tmp``
and renames it, and removes the oldest checkpoints past
``checkpoints_total_limit``. The next save, the end of `run` (a stop
request's too) and an error leaving it wait for the writer first, and a
write that failed raises there. A file is complete or absent: resume reads
only renamed ones.

Batches come from a feeder thread that reads the data iterator, turns each
batch into host tensors (pinned for a CUDA run) and keeps `PREFETCH` of
them queued; the step thread copies each to the device ``non_blocking`` on
its own stream. A loader error is raised on the step thread. SIGTERM and
SIGINT (handlers installed when `run` is on the main thread, restored when
it returns) and `request_stop` end the run after the step in flight, with a
checkpoint, a kohya file and a ``preempted`` row.

In a process group (`parallel/mesh.py`) every rank runs this loop on its
block of the global batch. Each step's draws are the global batch's, drawn
on every rank from the same generator (the ranks' generators stay equal),
of which each rank takes its rows (`local_rows`), so a run of N ranks at a
batch of B draws what one process draws at N x B; the step all-reduces the
gradients. Rank 0 alone writes ``metrics.jsonl``, checkpoints, kohya files
and validation grids, and only it keeps a pinned host twin; every rank
resumes from the same checkpoint file (then `replicate` guards that the
states agree). A stop request on any rank stops every rank after the same
step: the ranks agree on the flag before each step over the host group (no
rank waits in a collective that another has left), and rank 0 writes the
``preempted`` row and the save. The run ends at a barrier, after rank 0's
last write.
"""

from __future__ import annotations

import dataclasses
import math
import os
import signal
import threading
import time
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from ..lora.kohya import save_kohya_safetensors
from ..parallel import mesh
from ..utils import profiling
from ..utils.logging import MetricsLogger
from ..utils.threads import prefetch_thread
from .distill import DistillConfig, sample_draws, split_microbatches
from .prodigy import prodigy_d
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
    kohya_prefix: str = "lora_unet"  # the family's (`SD15Bundle.KOHYA_PREFIX`)
    validation_steps: int = 0  # 0: no validation


def _to(tree, device):
    """Tensors of a nested dict/tuple/list moved to ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to(v, device) for v in tree)
    return tree


_ALIGN = 64  # elements between the tensors carved from one pinned allocation


def _pinned_like(tree):
    """Pinned host tensors shaped like the CUDA tensors of ``tree`` (None for
    its other leaves), views into one allocation a dtype (``torch.save``
    takes no views of one storage as two types): a few page-locking calls a
    run, not one a tensor (a SD1.5 Prodigy state is ~2800 tensors)."""
    totals = {}

    def walk(node):
        if isinstance(node, torch.Tensor):
            if node.device.type == "cuda":
                totals[node.dtype] = totals.get(node.dtype, 0) + -(-node.numel() // _ALIGN) * _ALIGN
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (tuple, list)):
            for v in node:
                walk(v)

    walk(tree)
    bufs = {dt: torch.empty(n, dtype=dt, pin_memory=True) for dt, n in totals.items()}
    offsets = dict.fromkeys(totals, 0)

    def carve(node):
        if isinstance(node, torch.Tensor):
            if node.device.type != "cuda":
                return None
            o, n = offsets[node.dtype], node.numel()
            offsets[node.dtype] = o + -(-n // _ALIGN) * _ALIGN
            return bufs[node.dtype][o:o + n].view(node.shape)
        if isinstance(node, dict):
            return {k: carve(v) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return type(node)(carve(v) for v in node)
        return None

    return carve(tree)


def _host_copy(tree, mirror):
    """A host copy of a nested dict/tuple/list of tensors: each CUDA tensor
    copied ``non_blocking`` into its pinned twin in ``mirror`` (`_pinned_like`)
    on the current stream (read it after an event recorded behind the
    copies), each CPU one cloned."""
    if isinstance(tree, torch.Tensor):
        if mirror is None:
            return tree.detach().clone()
        return mirror.copy_(tree.detach(), non_blocking=True)
    if isinstance(tree, dict):
        return {k: _host_copy(v, mirror and mirror[k]) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_host_copy(v, m) for v, m in zip(tree, mirror or [None] * len(tree)))
    return tree


class CheckpointWriter:
    """One write at a time on a thread of its own. `submit` waits for the
    write before it; `wait` joins the one in flight and raises, on the
    caller's thread, the error it met. The thread is not a daemon, so the
    interpreter does not exit under a write."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.seconds = 0.0  # the last finished write's

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def submit(self, write: Callable[[], None]) -> None:
        self.wait()

        def run() -> None:
            t0 = time.perf_counter()
            try:
                write()
            except BaseException as e:  # raised again by `wait`, on the step thread
                self._error = e
            self.seconds = time.perf_counter() - t0

        self._thread = threading.Thread(target=run, name="pcm-checkpoint-writer")
        self._thread.start()


def _layout(tree):
    """Structure and shapes of a nested dict/tuple/list of tensors."""
    if isinstance(tree, torch.Tensor):
        return tuple(tree.shape), tree.dtype
    if isinstance(tree, dict):
        return {k: _layout(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_layout(v) for v in tree)
    return type(tree)


def _replicated(state: Optional[TrainState]) -> Optional[TrainState]:
    """Rank 0's parameters and optimizer state on every rank."""
    if state is None:
        return None
    return dataclasses.replace(state, **mesh.replicate({"params": state.params,
                                                        "opt_state": state.opt_state}))


def _span_row(taken: Dict) -> Dict[str, float]:
    """Row keys of `profiling.take`'s sums (the module docstring's list)."""
    row, spans = {}, taken["spans"]
    waits = [v for k, v in spans.items() if k.startswith(profiling.WAIT)]
    row["host_wait_s"] = sum(v["host_s"] for v in waits)
    row["host_waits"] = sum(v["calls"] for v in waits)
    attn = spans.get("attention", {"calls": 0})
    row["attn_calls"] = attn["calls"]
    if "device_s" in attn:
        row["attn_device_s"] = attn["device_s"]
    for name, v in spans.items():
        if name == "attention" or name.startswith(profiling.WAIT):
            continue
        key = name.replace(".", "_")
        row[key + "_host_s"] = v["host_s"]
        for part in ("device_s", "lead_s"):
            if part in v:
                row[f"{key}_{part}"] = v[part]
    if taken["device_s"] is not None:
        row["step_device_s"] = taken["device_s"]
    row.update(taken["counts"])
    return row


class Trainer:
    """Drives ``step(state, d_state, frozen, batch, draws, global_step) ->
    (state, d_state, metrics, global steps counted)`` to ``max_train_steps``
    global steps. ``d_state`` is the heads' state of an adversarial run,
    else None; the draws are `sample_draws`' for ``distill_cfg``, with the
    adversarial ones over [0, ``adv_span``) when there are heads
    (`train/adv.py:adv_offset_span`), and the VAE posterior's on a batch of
    pixels, shaped like ``latents_like(batch)`` (the bundle's: a batch's
    cached latents, or what its pixels encode to)."""

    def __init__(self, loop_cfg: LoopConfig, frozen, state: TrainState, step: Callable,
                 distill_cfg: DistillConfig, latents_like: Callable, device: torch.device,
                 grad_accum_steps: int = 1, d_state: Optional[TrainState] = None,
                 adv_span: Optional[int] = None):
        self.cfg = loop_cfg
        self.frozen = frozen
        self.state = state
        self.d_state = d_state
        self.step = step
        self.distill_cfg = distill_cfg
        self.adv_span = adv_span
        self.device = torch.device(device)
        self.accum = grad_accum_steps
        self.latents_like = latents_like
        self._stop_requested = False
        self.generator = torch.Generator(self.device).manual_seed(loop_cfg.seed)
        self.rank, self.world = mesh.rank(), mesh.world()
        self.is_main = self.rank == 0  # the one rank that writes
        self.ckpt_dir = os.path.join(loop_cfg.output_dir, "checkpoints")
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.logger = MetricsLogger(loop_cfg.output_dir, is_main=self.is_main)
        self.validation_fn: Optional[Callable[[Any, Any, int], Dict[str, Any]]] = None
        self.writer = CheckpointWriter()
        self._mirror = self._mirror_layout = None  # the pinned host twin of the state
        self.global_step = 0
        self.resumed_from: Optional[int] = None
        self.last_saved: Optional[int] = None  # the step of the newest checkpoint
        if loop_cfg.resume:
            self._try_resume()
        if self.world > 1:  # a guard: every rank built or read the same state
            self.state, self.d_state = _replicated(self.state), _replicated(self.d_state)

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

    def _saved_state(self):
        """The trees a checkpoint holds, and their pinned host twin on a CUDA
        run's writing rank (made at the first call, and again if the layout
        changed)."""
        state = {"lora": self.state.params, "opt_state": self.state.opt_state}
        if self.d_state is not None:
            state.update(d_params=self.d_state.params, d_opt_state=self.d_state.opt_state)
        if (self.is_main and self.device.type == "cuda"
                and self._mirror_layout != _layout(state)):
            self._mirror, self._mirror_layout = _pinned_like(state), _layout(state)
        return state, self._mirror

    def save(self) -> str:
        """Copy the state to the host and hand the files to the writer
        (returns the checkpoint's path; `writer.wait` for the file). Only
        rank 0 writes; the others note the step."""
        step, cfg = self.global_step, self.cfg
        path = os.path.join(self.ckpt_dir, f"step_{step:07d}.pt")
        if not self.is_main:
            self.last_saved = step
            return path
        self.writer.wait()  # the write before, which reads the pinned twin
        state, mirror = self._saved_state()
        payload = {"step": step, "lora_step": self.state.step,
                   "generator": self.generator.get_state(), **_host_copy(state, mirror)}
        if self.d_state is not None:
            payload["d_step"] = self.d_state.step
        copied = None
        if self.device.type == "cuda":
            copied = torch.cuda.Event()
            copied.record()
        kohya = os.path.join(cfg.output_dir, f"pcm_lora_{step:07d}.safetensors")

        def write() -> None:
            if copied is not None:
                copied.synchronize()
            torch.save(payload, path + ".tmp")
            os.replace(path + ".tmp", path)
            save_kohya_safetensors(kohya + ".tmp", payload["lora"], cfg.lora_alpha,
                                   prefix=cfg.kohya_prefix)
            os.replace(kohya + ".tmp", kohya)
            if cfg.checkpoints_total_limit:
                for old in self.checkpoints()[:-cfg.checkpoints_total_limit]:
                    os.remove(old)

        self.writer.submit(write)
        self.last_saved = step
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
        self.global_step = self.resumed_from = self.last_saved = int(ck["step"])
        self.state = TrainState(step=int(ck.get("lora_step", ck["step"])),
                                params=_to(ck["lora"], self.device),
                                opt_state=_to(ck["opt_state"], self.device))
        if self.d_state is not None:
            self.d_state = TrainState(step=int(ck["d_step"]),
                                      params=_to(ck["d_params"], self.device),
                                      opt_state=_to(ck["d_opt_state"], self.device))
        self.generator.set_state(ck["generator"])

    # -- loop -------------------------------------------------------------
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
        self._saved_state()  # pin the host twin before the first step, not in a save
        feed = prefetch_thread(self._prepared(data_iter), PREFETCH, "pcm-batch-feeder")
        try:
            self._run_steps(feed, extra_batch)
            if self._stop_requested and self.global_step < cfg.max_train_steps:
                self.logger.log(self.global_step, {"preempted": 1})
                if self.is_main:
                    print(f"preempted at step {self.global_step}", flush=True)
            if self.last_saved != self.global_step:
                self.save()
        finally:
            try:
                self.writer.wait()
            finally:
                feed.close()
                for sig, h in handlers.items():
                    signal.signal(sig, h)
        mesh.barrier("pcm_run_done")  # the ranks leave after rank 0's last write
        return self.state

    def _draws(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """This rank's rows of the draws of the global batch: the whole
        global batch's drawn at once (so a row's draws depend neither on the
        ranks nor on the accumulation), this rank's block taken."""
        like = self.latents_like(batch)
        glob = like[:1].expand(like.shape[0] * self.world, *like.shape[1:])
        draws = sample_draws(self.distill_cfg, self.generator, glob, self.adv_span,
                             posterior="pixel_values" in batch)
        return mesh.local_rows(draws, self.rank, self.world)

    def _next_batch(self, feed: Iterator, extra_batch) -> Dict[str, torch.Tensor]:
        try:
            item = next(feed)
        except StopIteration:
            raise StopIteration("data iterator exhausted before max_train_steps") from None
        batch = {k: v.to(self.device, non_blocking=True) for k, v in item.items()}
        batch.update(extra_batch or {})
        return batch

    def _validate(self) -> float:
        """The validation grids of this step; returns the call's seconds."""
        t0 = time.perf_counter()
        grids = self.validation_fn(self.frozen, self.state.params, self.global_step)
        for tag, images in grids.items():
            if isinstance(images, torch.Tensor):
                images = images.float().cpu().numpy()
            self.logger.log_images(self.global_step, f"validation/{tag}", images)
        return time.perf_counter() - t0

    def _run_steps(self, feed: Iterator, extra_batch) -> None:
        cfg = self.cfg
        t_last, step_last = time.perf_counter(), self.global_step
        t_data = t_dispatch = t_save = t_wait = 0.0
        while self.global_step < cfg.max_train_steps:
            if mesh.any_rank(self._stop_requested):  # every rank stops after the same step
                self._stop_requested = True
                break
            t0 = time.perf_counter()
            with profiling.span("data"):
                batch = self._next_batch(feed, extra_batch)
            t1 = time.perf_counter()
            t_data += t1 - t0
            with profiling.span("draws"):
                draws = split_microbatches(self._draws(batch), self.accum)
            with profiling.span("call"):
                self.state, self.d_state, metrics, counted = self.step(
                    self.state, self.d_state, self.frozen, batch, draws, self.global_step)
            self.global_step += counted
            t_dispatch += time.perf_counter() - t1

            if self.global_step % cfg.log_every == 0:
                d = prodigy_d(self.state.opt_state)
                if d is not None:
                    metrics = dict(metrics, prodigy_d=d)
                tf = time.perf_counter()
                with profiling.span("readback"):
                    row = {k: float(v) for k, v in metrics.items()}  # a device sync
                now = time.perf_counter()
                spans = profiling.take()
                profiling.anchor()  # the card has nothing queued
                row["step_ms"] = (now - t_last) * 1000.0 / (self.global_step - step_last)
                t_last, step_last = now, self.global_step
                if self.device.type == "cuda":
                    row["peak_gib"] = torch.cuda.max_memory_allocated(self.device) / 2 ** 30
                row.update(host_data_s=t_data, host_dispatch_s=t_dispatch, fence_s=now - tf,
                           feed_iter_s=self._feed_iter_s, feed_put_s=self._feed_put_s,
                           save_s=t_save, save_wait_s=t_wait, write_s=self.writer.seconds,
                           **_span_row(spans))
                self._feed_iter_s = self._feed_put_s = t_data = t_dispatch = t_save = 0.0
                t_wait = 0.0
                self.logger.log(self.global_step, row)
                if self.is_main:
                    print(f"step {self.global_step}: " + " ".join(
                        f"{k}={v:.6g}" for k, v in row.items()), flush=True)
                bad = {k: row[k] for k in ("loss", "d_loss", "g_loss")
                       if k in row and not math.isfinite(row[k])}
                if bad:
                    last = "none" if self.last_saved is None else f"step {self.last_saved}"
                    raise FloatingPointError(f"non-finite loss at step {self.global_step}: "
                                             f"{bad} (last checkpoint: {last})")
            if cfg.checkpointing_steps and self.global_step % cfg.checkpointing_steps == 0:
                ts = time.perf_counter()
                self.writer.wait()
                t_wait += time.perf_counter() - ts
                self.save()
                t_save += time.perf_counter() - ts
            if (self.validation_fn is not None and self.is_main and cfg.validation_steps
                    and self.global_step % cfg.validation_steps == 0):
                seconds = self._validate()
                t_last += seconds  # step_ms leaves validation out
                profiling.take()  # and the spans leave out the sampler's
                profiling.anchor()
                row = {"validation_s": seconds}
                if self.device.type == "cuda":
                    row["peak_gib"] = torch.cuda.max_memory_allocated(self.device) / 2 ** 30
                self.logger.log(self.global_step, row)
                print(f"validation at step {self.global_step}: {seconds:.3f} s", flush=True)
