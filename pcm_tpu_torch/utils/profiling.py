"""Step-rate accounting, and the program's spans and counters.

`StepTimer` is the counterpart of `pcm_tpu/utils/profiling.py:StepTimer`
(that module's XLA tracing and device timing are not ported: on the card,
CUDA events and `torch.profiler` take their place).

``with span(name):`` times a stretch of the program on the host clock
(``time.perf_counter``) and, on a CUDA device, on the card: a timing event
recorded on the current stream at its start and at its end (from a pool
reused from step to step; recording one adds no sync). Spans nest, per
thread (autograd runs a CUDA backward on a thread of its own): each knows
its parent, so its self time is its duration less its children's. While a
`torch.profiler` records, each span is also a ``record_function`` named
``pcm.<name>``, on the trace's clock beside the kernels it launched; with no
profiler running none is entered. `count` adds to a counter.

`take` returns the sums since the last call and resets them: per span name
its host seconds, self seconds, calls and, on the card, device seconds (end
event less start event: the card's time from reaching the span to leaving
it, idle included). It is called where the card has nothing queued (after a
readback), so every event it reads has completed; it waits for any that has
not, which after a readback are only those recorded since (microseconds).

`anchor` records an event where the card has nothing queued, with the host
time: the event's device time is then that host time, and the device end of
every span opened after it maps onto ``perf_counter`` as ``anchor host time
+ elapsed(anchor, end event)``. A span's lead is that device end less the
host time it closed: positive, the card still had that much queued when the
host left the span; about zero, the card had caught up and waited for the
host. `take` also gives the card's seconds from the anchor to the end of the
last span closed.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

WAIT = "wait."  # prefix of the spans around a host wait on the card
MAX_PENDING = 4096  # closed spans whose events are kept before the done ones are read


class StepTimer:
    """Rolling steps/sec + wall-time accounting over the last ``window`` ticks."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times = []

    def tick(self) -> Dict[str, float]:
        now = time.perf_counter()
        self.times.append(now)
        if len(self.times) > self.window:
            self.times.pop(0)
        if len(self.times) < 2:
            return {}
        dt = (self.times[-1] - self.times[0]) / (len(self.times) - 1)
        return {"step_time_ms": dt * 1000.0, "steps_per_sec": 1.0 / dt}


class _Span:
    """One span's context manager (`Recorder.span`)."""

    __slots__ = ("rec", "name", "device", "parent", "children_s", "anchor", "scope", "start",
                 "end", "t0", "t1")

    def __init__(self, rec: "Recorder", name: str, device: Optional[int]):
        self.rec, self.name, self.device = rec, name, device

    def __enter__(self) -> "_Span":
        rec = self.rec
        stack = rec._stack()
        self.parent = stack[-1] if stack else None
        stack.append(self)
        self.children_s = 0.0
        self.anchor = rec._anchor
        self.scope = None
        if _autograd_profiler._is_profiler_enabled:
            self.scope = torch.profiler.record_function("pcm." + self.name)
            self.scope.__enter__()
        self.start = rec._record(self.device)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        rec = self.rec
        self.end = rec._record(self.device)
        self.t1 = time.perf_counter()
        if self.scope is not None:
            self.scope.__exit__(*exc)
        rec._stack().pop()
        rec._close(self)
        return False


class Recorder:
    """Spans and counters of one process (the module's functions use one)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._free: Dict[int, List[torch.cuda.Event]] = {}  # the event pool, by card
        self._pending: List[_Span] = []  # closed spans whose events are unread
        self._totals: Dict[str, list] = {}  # name -> [host_s, self_s, calls, device_s, lead_s]
        self._counts: Dict[str, int] = {}
        self._anchor = None  # (card, event, host time)
        self._last_end = None  # card seconds from the anchor to the last span's end

    def span(self, name: str, device=None) -> _Span:
        """A span named ``name``; its events go on ``device``'s current
        stream (default: the current CUDA device once CUDA is in use; none
        for a CPU device)."""
        if device is None:
            index = torch.cuda.current_device() if torch.cuda.is_initialized() else None
        else:
            device = torch.device(device)
            index = None if device.type != "cuda" else (
                device.index if device.index is not None else torch.cuda.current_device())
        return _Span(self, name, index)

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n

    def anchor(self) -> None:
        """Record the anchor on the current CUDA device (call it where the
        card has nothing queued); nothing off CUDA."""
        if not torch.cuda.is_initialized():
            return
        device = torch.cuda.current_device()
        event = self._record(device)
        old, self._anchor = self._anchor, (device, event, time.perf_counter())
        if old is not None:
            self._free.setdefault(old[0], []).append(old[1])

    def take(self) -> Dict:
        """``{"spans": {name: {"host_s", "self_s", "calls"[, "device_s"][,
        "lead_s"]}}, "counts": {name: n}, "device_s": float or None}`` since
        the last call; ``lead_s`` (at the span's last close) only for spans
        opened after the current anchor, ``device_s`` the card's seconds from
        the anchor to the end of the last span closed."""
        with self._lock:
            for s in self._pending:
                self._read(s, wait=True)
            self._pending = []
            spans = {}
            for name, (host_s, self_s, calls, device_s, lead_s) in self._totals.items():
                spans[name] = {"host_s": host_s, "self_s": self_s, "calls": calls}
                if device_s is not None:
                    spans[name]["device_s"] = device_s
                if lead_s is not None:
                    spans[name]["lead_s"] = lead_s
            out = {"spans": spans, "counts": self._counts, "device_s": self._last_end}
            self._totals, self._counts, self._last_end = {}, {}, None
        return out

    # -- internals --------------------------------------------------------
    def _stack(self) -> List[_Span]:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _record(self, device: Optional[int]) -> Optional[torch.cuda.Event]:
        if device is None:
            return None
        try:
            event = self._free[device].pop()
        except (KeyError, IndexError):
            event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(device))
        return event

    def _close(self, s: _Span) -> None:
        duration = s.t1 - s.t0
        if s.parent is not None:
            s.parent.children_s += duration
        with self._lock:
            t = self._totals.get(s.name)
            if t is None:
                t = self._totals[s.name] = [0.0, 0.0, 0, None, None]
            t[0] += duration
            t[1] += duration - s.children_s
            t[2] += 1
            if s.end is None:
                return
            self._pending.append(s)
            if len(self._pending) > MAX_PENDING:  # no `take` for a while (e.g. serving)
                self._pending = [p for p in self._pending if not self._read(p, wait=False)]
                while len(self._pending) > MAX_PENDING // 2:
                    self._read(self._pending.pop(0), wait=True)

    def _read(self, s: _Span, wait: bool) -> bool:
        """Fold ``s``'s device time (and lead) into the totals and return its
        events to the pool; False, doing nothing, if not done and not ``wait``."""
        if not s.end.query():
            if not wait:
                return False
            s.end.synchronize()
        t = self._totals[s.name]
        t[3] = (t[3] or 0.0) + s.start.elapsed_time(s.end) / 1000.0
        a = self._anchor
        if a is not None and s.anchor is a and a[0] == s.device:
            since = a[1].elapsed_time(s.end) / 1000.0
            t[4] = a[2] + since - s.t1
            self._last_end = since
        pool = self._free.setdefault(s.device, [])
        pool.append(s.start)
        pool.append(s.end)
        return True


_recorder = Recorder()


def span(name: str, device=None) -> _Span:
    """``with span(name):`` a span of the process's recorder (`Recorder.span`)."""
    return _recorder.span(name, device)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _recorder.count(name, n)


def anchor() -> None:
    """`Recorder.anchor` of the process's recorder."""
    _recorder.anchor()


def take() -> Dict:
    """`Recorder.take` of the process's recorder."""
    return _recorder.take()
