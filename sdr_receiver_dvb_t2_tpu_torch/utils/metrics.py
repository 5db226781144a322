"""Observability: per-stage throughput/quality counters and profiling hooks.

Replaces the reference's GUI-signal observability (SNR label, frequency/
timing offset indicators, TS stage strings with repeat-count dedup,
main_window.cpp:529-545) with structured counters usable headless, plus
torch.profiler integration for device traces (the reference had none --
SURVEY.md §5 tracing).
"""
from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class StageStats:
    calls: int = 0
    items: int = 0          # samples / cells / bits, stage-defined
    seconds: float = 0.0

    @property
    def rate(self) -> float:
        return self.items / self.seconds if self.seconds > 0 else 0.0


class Metrics:
    """Lightweight hierarchical counters + message dedup."""

    def __init__(self):
        self.stages: dict[str, StageStats] = defaultdict(StageStats)
        self.gauges: dict[str, float] = {}
        self._messages: list[tuple[str, int]] = []

    @contextlib.contextmanager
    def stage(self, name: str, items: int = 0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            s = self.stages[name]
            s.calls += 1
            s.items += items
            s.seconds += time.perf_counter() - t0

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)

    def message(self, text: str) -> None:
        """Dedup consecutive repeats like the reference's TS-stage view."""
        if self._messages and self._messages[-1][0] == text:
            self._messages[-1] = (text, self._messages[-1][1] + 1)
        else:
            self._messages.append((text, 1))

    @property
    def messages(self) -> list[str]:
        return [t if n == 1 else f"{t} (x{n})" for t, n in self._messages]

    def as_dict(self) -> dict:
        return {
            "stages": {k: {"calls": v.calls, "items": v.items,
                           "seconds": round(v.seconds, 6),
                           "rate": round(v.rate, 1)}
                       for k, v in self.stages.items()},
            "gauges": self.gauges,
            "messages": self.messages,
        }

    def to_json(self) -> str:
        return json.dumps(self.as_dict())


@contextlib.contextmanager
def device_trace(logdir: str):
    """torch.profiler trace (CPU and, where there is one, the CUDA device)
    around a block, written to `logdir` for TensorBoard."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        yield
