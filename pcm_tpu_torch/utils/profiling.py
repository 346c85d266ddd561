"""Step-rate accounting (counterpart of `pcm_tpu/utils/profiling.py:StepTimer`;
that module's XLA tracing and device timing are not ported: on the card,
CUDA events and `torch.profiler` take their place)."""

from __future__ import annotations

import time
from typing import Dict


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
