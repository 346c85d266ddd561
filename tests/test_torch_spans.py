"""The program's spans and counters (`pcm_tpu_torch/utils/profiling.py`),
the row keys the Trainer makes of them (`train/loop.py`) and the
benchmark's readers of those keys (`pcm_bench/layer_metrics/`).

CPU tests, and one test on a CUDA card (marker ``gpu``), which holds the
host's waits that torch's sync debug mode sees in the TINY SD3 flow step and
the TINY SDXL DDIM step to the ``wait.<site>`` spans and the readback:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_spans.py -m gpu -q -s
"""

from __future__ import annotations

import collections
import contextlib
import importlib.util
import json
import os
import pathlib
import sys
import threading
import warnings

import numpy as np
import pytest
import torch

from pcm_tpu_torch.configs import families
from pcm_tpu_torch.configs.families import SD3_CACHED_STEP, SDXL_CACHED_STEP
from pcm_tpu_torch.core.schedule import make_ddpm_schedule, make_flow_schedule
from pcm_tpu_torch.train import distill
from pcm_tpu_torch.train.bundles import adapter_like
from pcm_tpu_torch.train.loop import LoopConfig, Trainer
from pcm_tpu_torch.train.state import TrainState, make_optimizer
from pcm_tpu_torch.utils import profiling

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


class _Clock:
    """A ``time`` stand-in whose ``perf_counter`` reads ``now``."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        return self.now


# ---------------------------------------------------------------------------
# (a) the recorder
# ---------------------------------------------------------------------------


def test_spans_nest_sum_by_name_and_reset(monkeypatch):
    """Durations on a stepped clock: ``outer`` (10 s) holds two ``inner``
    spans (2 + 3 s), so its self time is 5 s; names sum over calls; counters
    add; `take` resets both."""
    clock = _Clock()
    monkeypatch.setattr(profiling, "time", clock)
    rec = profiling.Recorder()
    with rec.span("outer"):
        for d in (2.0, 3.0):
            with rec.span("inner"):
                clock.now += d
            clock.now += 1.0
        clock.now += 3.0
    rec.count("widgets")
    rec.count("widgets", 4)
    got = rec.take()
    assert got["spans"] == {"outer": {"host_s": 10.0, "self_s": 5.0, "calls": 1},
                            "inner": {"host_s": 5.0, "self_s": 5.0, "calls": 2}}
    assert got["counts"] == {"widgets": 5} and got["device_s"] is None
    assert rec.take() == {"spans": {}, "counts": {}, "device_s": None}


def test_spans_of_another_thread_merge(monkeypatch):
    """A span closed on a second thread (as autograd's backward thread
    closes the attention spans) is summed with the first thread's under its
    name, and is no child of the span open on the first thread: the outer
    span's self time leaves out only its own thread's child."""
    clock = _Clock()
    monkeypatch.setattr(profiling, "time", clock)
    rec = profiling.Recorder()

    def worker():
        with rec.span("attention"):
            clock.now += 4.0

    with rec.span("student.backward"):
        with rec.span("attention"):
            clock.now += 1.0
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    spans = rec.take()["spans"]
    assert spans["attention"] == {"host_s": 5.0, "self_s": 5.0, "calls": 2}
    assert spans["student.backward"] == {"host_s": 5.0, "self_s": 4.0, "calls": 1}


def test_no_update_is_lost_across_threads():
    """Eight threads open spans and count at once, with the interpreter
    switching threads as often as it can: every call and count is kept, and
    no span takes another thread's as its parent."""
    rec = profiling.Recorder()

    def work():
        for _ in range(2000):
            with rec.span("attention"):
                rec.count("calls")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    got = rec.take()
    assert got["spans"]["attention"]["calls"] == got["counts"]["calls"] == 16000
    assert got["spans"]["attention"]["self_s"] == pytest.approx(got["spans"]["attention"]["host_s"])


# ---------------------------------------------------------------------------
# (b) the profiler's names
# ---------------------------------------------------------------------------


def test_no_record_function_without_a_profiler(monkeypatch):
    entered = []

    class Counting:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    with profiling.span("outer"), profiling.span("inner"):
        pass
    profiling.take()
    assert entered == []


def test_spans_are_named_on_the_profilers_timeline():
    """Under `torch.profiler`, ``pcm.<name>`` events nest as the spans do."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("call"):
            with profiling.span("teacher"):
                torch.ones(4).sum()
    profiling.take()
    events = {e.name: e for e in prof.events() if e.name.startswith("pcm.")}
    assert set(events) == {"pcm.call", "pcm.teacher"}
    assert events["pcm.teacher"].cpu_parent.name == "pcm.call"


# ---------------------------------------------------------------------------
# (c) the Trainer's rows on the TINY steps
# ---------------------------------------------------------------------------

TRAINER_SPANS = ("data", "draws", "call", "readback")
PHASES = ("teacher", "target", "student_forward", "student_backward", "optimizer")
WAITS = {"sd3": 2, "sdxl": 3}  # a step's pageable copies: the solver's jumps (+ DDIM's scalings)


def _trainer(family: str, device: torch.device, out, steps: int = 3):
    """A Trainer of the TINY ``family`` consistency step (SD3: flow, SDXL:
    DDIM, each at its cached step's solver settings) on a batch of 2 cached
    rows, and the data to feed it: fp32 on the CPU, bf16 with fp16 rows on
    the card, as a latent cache is stored."""
    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    rows = np.float32 if device.type == "cpu" else np.float16
    gen = torch.Generator(device).manual_seed(0)
    rng = np.random.default_rng(0)
    batch = {"latents": rng.standard_normal((2, 8, 8, 4)).astype(rows),
             "prompt_embeds": rng.standard_normal((2, 8, 32)).astype(rows),
             "pooled_embeds": rng.standard_normal((2, 32)).astype(rows)}
    extra = None
    if family == "sd3":
        bundle = families.sd3_bundle(8, dtype=dtype, tiny=True)
        frozen, template = bundle.init(gen, device, modules=("mmdit",))
        recipe = SD3_CACHED_STEP
        tx = make_optimizer(recipe.lr)
        step = distill.build_flow_distill_step(bundle, make_flow_schedule(shift=3.0),
                                               recipe.distill, tx)
        extra = {"uncond_embeds": torch.zeros((2, 8, 32), dtype=dtype, device=device),
                 "uncond_pooled": torch.zeros((2, 32), dtype=dtype, device=device)}
    else:
        bundle = families.sdxl_bundle(8, dtype=dtype, tiny=True)
        frozen, template = bundle.init(gen, device, modules=("unet",))
        recipe = SDXL_CACHED_STEP
        tx = make_optimizer(recipe.lr)
        step = distill.build_ddim_distill_step(bundle, make_ddpm_schedule(), recipe.distill, tx)
        batch["time_ids"] = np.tile(np.asarray(recipe.time_ids, np.float32), (2, 1))
    lora = adapter_like(template, gen)  # b != 0: every factor has a gradient

    def call(state, d_state, frozen_, b, draws, global_step):
        new, metrics = step(state, frozen_, b, draws)
        return new, d_state, metrics, 1

    loop = LoopConfig(str(out), steps, checkpointing_steps=0, log_every=1, seed=5,
                      resume=False)
    trainer = Trainer(loop, frozen, TrainState.create(lora, tx), call, recipe.distill,
                      bundle.latents_like, device)
    trainer.save = lambda: None  # no closing checkpoint
    return trainer, iter([batch] * steps), extra


def _rows(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("family", ["sd3", "sdxl"])
def test_trainer_rows_hold_the_spans(tmp_path, monkeypatch, family):
    """Three steps: every row has each Trainer span's and each phase's host
    seconds, the waits, the attention calls, the adapter's leaves through the
    optimizer's flat vector and no device keys (CPU); a step
    after the first waits ``WAITS[family]`` times (the first also copies the
    solver's tables); the losses and the final adapter are bit-equal to the
    same run with every span a ``nullcontext``: the spans change no number."""
    profiling.take()
    trainer, data, extra = _trainer(family, CPU, tmp_path / "spans")
    trainer.run(data, extra)
    rows = _rows(tmp_path / "spans")
    assert len(rows) == 3
    for row in rows:
        for name in TRAINER_SPANS + PHASES:
            assert row[f"{name}_host_s"] > 0, name
            assert f"{name}_device_s" not in row and f"{name}_lead_s" not in row
        assert "step_device_s" not in row and "attn_device_s" not in row
        assert row["attn_calls"] == rows[0]["attn_calls"] > 0
        assert row["optimizer_flat_leaves"] == len(trainer.state.params) > 0
        assert 0 < row["host_wait_s"] <= row["host_dispatch_s"]
        phases = sum(row[f"{p}_host_s"] for p in PHASES)
        assert phases <= row["call_host_s"] <= row["host_dispatch_s"]
    assert [r["host_waits"] for r in rows[1:]] == [WAITS[family]] * 2
    assert rows[0]["host_waits"] > WAITS[family]
    if family == "sd3":  # a joint attention a layer in the teacher, target, student, backward
        assert rows[0]["attn_calls"] == 4 * 2

    monkeypatch.setattr(profiling, "span", lambda *a, **kw: contextlib.nullcontext())
    plain, data, extra = _trainer(family, CPU, tmp_path / "plain")
    plain.run(data, extra)
    plain_rows = _rows(tmp_path / "plain")
    assert [r["loss"] for r in plain_rows] == [r["loss"] for r in rows]
    assert "teacher_host_s" not in plain_rows[0] and plain_rows[0]["host_waits"] == 0
    for k, v in plain.state.params.items():
        assert torch.equal(v, trainer.state.params[k]), k


# ---------------------------------------------------------------------------
# (d) the benchmark's readers
# ---------------------------------------------------------------------------

READERS = {  # metric -> (row keys summed, a row's value)
    "host_wait_ms.train": ("host_wait_s",),
    "forward_ms.train": ("teacher_device_s", "target_device_s", "student_forward_device_s"),
    "backward_ms.train": ("student_backward_device_s",),
    "optimizer_ms.train": ("optimizer_device_s",),
    "attn_ms.train": ("attn_device_s",),
}


def _reader(metric):
    path = REPO / "pcm_bench" / "layer_metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"test_layer_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("metric", sorted(READERS))
def test_layer_metric_readers(metric):
    """Summed over the window's rows, over its steps, in ms; None for a
    record that is no training run or whose rows lack a key."""
    keys = READERS[metric]
    rows = [{k: 0.010 * (i + 1) * (j + 1) for j, k in enumerate(keys)} for i in range(3)]
    record = {"kind": "train", "steps": 4, "rows": rows}
    want = 1000.0 * sum(r[k] for r in rows for k in keys) / 4
    read = _reader(metric)
    assert read(record) == pytest.approx(want)
    assert read({"kind": "none"}) is None
    assert read({"kind": "train", "steps": 3, "rows": [{"host_dispatch_s": 1.0}] * 3}) is None
    partial = [dict(r) for r in rows]
    del partial[1][keys[-1]]
    assert read(dict(record, rows=partial)) is None
    assert read(dict(record, steps=0, rows=[])) is None


# ---------------------------------------------------------------------------
# on the card: the sync inventory
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["sd3", "sdxl"])
def test_sync_inventory_matches_the_wait_spans(tmp_path, family):
    """Under ``torch.cuda.set_sync_debug_mode("warn")`` the host syncs that
    torch sees in three Trainer steps are the ``wait.<site>`` spans plus the
    readback's two (loss and grad_norm); the rows carry the device keys and
    the Trainer's four spans tile the card's time of the step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    device = torch.device("cuda")
    trainer, data, extra = _trainer(family, device, tmp_path)
    torch.cuda.synchronize()
    profiling.take()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            trainer.run(data, extra)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # the warnings of the syncs (not the notice that turning the mode on gives)
    syncs = [w for w in seen if "called a synchronizing CUDA operation" in str(w.message)]
    rows = _rows(tmp_path)
    waits = [r["host_waits"] for r in rows]
    readbacks = 2 * len(rows)
    sites = collections.Counter(f"{os.path.relpath(w.filename, REPO)}:{w.lineno}" for w in syncs)
    said = (f"{family}: {len(syncs)} syncs seen; wait spans by step {waits}, {readbacks} "
            f"readbacks; by site {dict(sorted(sites.items()))}")
    print("\n" + said)
    assert len(syncs) == sum(waits) + readbacks, said
    assert waits[1:] == [WAITS[family]] * (len(rows) - 1)
    for row in rows[1:]:
        four = sum(row[f"{n}_device_s"] for n in TRAINER_SPANS)
        assert four <= row["step_device_s"] * 1.001
        assert all(f"{n}_lead_s" in row for n in TRAINER_SPANS + PHASES)
        assert row["attn_device_s"] > 0


@pytest.mark.gpu
def test_pending_events_stay_bounded_without_take(monkeypatch):
    """Where nothing calls `take` (a server), the closed spans whose events
    are kept stay under ``MAX_PENDING``: the done ones are read and their
    events reused; `take` still sums every span."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(profiling, "MAX_PENDING", 8)
    rec = profiling.Recorder()
    x = torch.ones(1024, device="cuda")
    for _ in range(50):
        with rec.span("attention", x.device):
            x = x * 1.0001
        assert len(rec._pending) <= 8
    got = rec.take()["spans"]["attention"]
    assert got["calls"] == 50 and got["device_s"] > 0
    # 100 events recorded, at most 2 x (8 + 1) ever made: the rest were reused
    assert sum(len(v) for v in rec._free.values()) <= 18
