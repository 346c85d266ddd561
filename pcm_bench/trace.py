"""The traced part of a ``--trace 1`` run: `torch.profiler` over a few
steps or batches after the measured window, the benchmark's spans, and the
reduction of the trace to numbers.

`AttentionSpans` puts a ``record_function`` span named `ATTENTION` around
every call of the program's attention entry (``flash_attention`` of
``pcm_tpu_torch.ops``, wherever a module of the program holds it) and a
second one around the autograd backward of each such call: it opens when
the gradient of the call's output arrives and closes when the gradients of
its q, k and v have been computed. Whatever implements attention behind
that entry is then timed against the same work.
"""

from __future__ import annotations

import bisect
import sys
from typing import Dict, List, Optional, Tuple

import torch

ATTENTION = "pcm_bench.attention"
PROGRAM = "pcm_tpu_torch"


class _Token:
    __slots__ = ("span",)

    def __init__(self):
        self.span = None


class _Close(torch.autograd.Function):
    """Identity on q, k, v; its backward closes the call's backward span."""

    @staticmethod
    def forward(ctx, token, q, k, v):
        ctx.token = token
        return q.view_as(q), k.view_as(k), v.view_as(v)

    @staticmethod
    def backward(ctx, gq, gk, gv):
        if ctx.token.span is not None:
            ctx.token.span.__exit__(None, None, None)
            ctx.token.span = None
        return None, gq, gk, gv


class _Open(torch.autograd.Function):
    """Identity on the output; its backward opens the call's backward span."""

    @staticmethod
    def forward(ctx, token, o):
        ctx.token = token
        return o.view_as(o)

    @staticmethod
    def backward(ctx, go):
        ctx.token.span = torch.profiler.record_function(ATTENTION)
        ctx.token.span.__enter__()
        return None, go


class AttentionSpans:
    """Spans around the program's attention entry while installed."""

    def __init__(self):
        self.original = None
        self.patched: List[Tuple[object, str]] = []

    def install(self) -> None:
        ops = sys.modules.get(PROGRAM + ".ops")
        original = getattr(ops, "flash_attention", None)
        if original is None:
            return
        self.original = original

        def spanned(q, k, v, *args, **kwargs):
            differentiable = torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k, v))
            if not differentiable:
                with torch.profiler.record_function(ATTENTION):
                    return original(q, k, v, *args, **kwargs)
            token = _Token()
            q, k, v = _Close.apply(token, q, k, v)
            with torch.profiler.record_function(ATTENTION):
                o = original(q, k, v, *args, **kwargs)
            return _Open.apply(token, o)

        for name, mod in list(sys.modules.items()):
            if (name == PROGRAM or name.startswith(PROGRAM + ".")) and \
                    getattr(mod, "flash_attention", None) is original:
                setattr(mod, "flash_attention", spanned)
                self.patched.append((mod, "flash_attention"))

    def uninstall(self) -> None:
        for mod, name in self.patched:
            setattr(mod, name, self.original)
        self.patched = []


def _union(intervals: List[Tuple[float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    """Covered length of ``intervals`` and the gaps between covered stretches."""
    covered, gaps, end = 0.0, [], None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s))
            covered += e - s
            end = e
        elif e > end:
            covered += e - end
            end = e
    return covered, gaps


def _is_annotation(e) -> bool:
    return bool(getattr(e, "is_user_annotation", False))


def summarize(prof, window_s: float, top: int = 10) -> Dict:
    """``busy_s`` (the union of the device's operations over the trace),
    ``window_s``, ``span_device_s`` (device time of the kernels under each
    benchmark span, outermost spans only), and the breakdown: the device
    operations that took most time and the longest idle gaps by what the
    host was running when each began."""
    dev_type = torch.autograd.DeviceType.CUDA
    cpu_type = torch.autograd.DeviceType.CPU
    events = prof.events()
    device, host = [], []
    for e in events:
        if e.device_type == dev_type and not _is_annotation(e):
            device.append((e.time_range.start, e.time_range.end))
        elif e.device_type == cpu_type:
            host.append(e)
    busy_us, gaps = _union(device)

    spans: Dict[str, float] = {}
    for e in host:
        if e.name != ATTENTION:
            continue
        parent, nested = e.cpu_parent, False
        while parent is not None:
            if parent.name == ATTENTION:
                nested = True
                break
            parent = parent.cpu_parent
        if not nested:
            spans[e.name] = spans.get(e.name, 0.0) + e.device_time_total / 1e6

    ops: Dict[str, float] = {}
    for e in prof.key_averages():
        if e.device_type == dev_type and not _is_annotation(e):
            ops[e.key] = ops.get(e.key, 0.0) + e.self_device_time_total / 1e6
    device_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:top]

    host.sort(key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in host]
    by_host: Dict[str, float] = {}
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:200]:
        i = bisect.bisect_right(starts, g0) - 1
        name = "no host op"
        for j in range(i, max(-1, i - 400), -1):
            if host[j].time_range.end >= g0:
                name = host[j].name
                break
        by_host[name] = by_host.get(name, 0.0) + (g1 - g0) / 1e6
    idle_gaps = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_s": busy_us / 1e6, "window_s": window_s, "span_device_s": spans,
            "breakdown": {"device_ops": [[k[:160], v] for k, v in device_ops],
                          "idle_gaps": [[k[:160], v] for k, v in idle_gaps]}}


class Tracer:
    """The profiler over the traced part of a run (CPU and CUDA activity)
    with the attention spans installed; `stop` returns `summarize`'s dict."""

    def __init__(self, device: torch.device):
        self.device = device
        self.spans = AttentionSpans()
        self.prof = None
        self.t0: Optional[float] = None

    def start(self, now) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.spans.install()
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self.t0 = now()

    def stop(self, now) -> Dict:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        window = now() - self.t0
        self.prof.stop()
        self.spans.uninstall()
        return summarize(self.prof, window)
