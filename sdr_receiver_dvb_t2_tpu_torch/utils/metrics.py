"""Observability: per-stage throughput/quality counters and profiling hooks.

Replaces the reference's GUI-signal observability (SNR label, frequency/
timing offset indicators, TS stage strings with repeat-count dedup,
main_window.cpp:529-545) with structured counters usable headless, plus
torch.profiler integration for device traces (the reference had none --
SURVEY.md §5 tracing).

Spans and counters inside the receiver (`span`, `count`) go to one
process-wide `Tracer`, off by default and then free; switched on, it
keeps them in memory on torch.profiler's clock until `dump()`.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import threading
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
            with span("t2." + name):
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
    around a block, written to `logdir` for TensorBoard, with the tracer
    on: the receiver's spans appear in the trace as ranges of their names,
    and the spans and counters are written to `logdir`/TRACE_FILE."""
    import os
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    was_on = TRACER.on
    TRACER.enable()
    try:
        with torch.profiler.profile(
                activities=acts,
                on_trace_ready=torch.profiler.tensorboard_trace_handler(
                    logdir)):
            yield
    finally:
        if not was_on:
            TRACER.disable()
        os.makedirs(logdir, exist_ok=True)
        with open(os.path.join(logdir, TRACE_FILE), "w") as f:
            json.dump(TRACER.dump(clear=not was_on), f)


TRACE_FILE = "t2_trace.json"


class _NullSpan:
    """The span of a tracer that is off: it records nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("tracer", "name", "ids", "id", "parent", "t0", "range")

    def __init__(self, tracer: "Tracer", name: str, ids: dict):
        self.tracer, self.name, self.ids = tracer, name, ids

    def __enter__(self):
        tr = self.tracer
        stack = tr._stack()
        up = stack[-1] if stack else None
        self.parent = up.id if up is not None else None
        if up is not None and up.ids:
            self.ids = {**up.ids, **self.ids}
        self.id = next(tr._ids)
        stack.append(self)
        self.t0 = time.time_ns()
        # a range costs ~10 us and records nothing without a profiler
        self.range = (tr._record_function(self.name) if tr._profiling()
                      else None)
        if self.range is not None:
            self.range.__enter__()
        return self

    def __exit__(self, *exc):
        if self.range is not None:
            self.range.__exit__(None, None, None)
        t1 = time.time_ns()
        self.tracer._stack().pop()
        self.tracer.spans.append((self.id, self.parent, self.name, self.ids,
                                  self.t0, t1))
        return False


class Tracer:
    """The receiver's spans and counters, kept in memory.

    Off (the default), `span` hands back NULL_SPAN and `count` returns at
    once: no allocation, no profiler range, no CUDA event, nothing read
    from a device.  On, a span records its name, the span it opened in
    (per thread), its ids merged over those of the spans around it
    (`step`, `frame`), and its host start and end from `time.time_ns()`;
    while a profiler records, it opens a `torch.profiler` range of its
    name between the two.  An exported trace's event at `ts`
    microseconds, plus the file's `baseTimeNanoseconds`, reads the same
    Unix clock.  A counter adds Python ints on the host and tensors on
    their own device, without waiting for it, into one total per CUDA
    stream (work on two streams never adds into one tensor); `dump` reads
    each device total once."""

    def __init__(self):
        self.on = False
        self._local = threading.local()
        self._record_function = self._profiling = None
        self.clear()

    def clear(self) -> None:
        """Drop every span and counter kept so far."""
        # (id, parent id, name, ids, start ns, end ns), in closing order
        self.spans: list[tuple] = []
        self._ids = itertools.count()
        self._host: dict[str, int] = defaultdict(int)
        self._dev: dict[tuple, object] = {}

    def enable(self) -> None:
        import torch
        self._record_function = torch.autograd.profiler.record_function
        self._profiling = torch.autograd._profiler_enabled
        self.on = True

    def disable(self) -> None:
        self.on = False

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def count(self, name: str, n) -> None:
        """Add `n` (an int, or a one-element integer tensor, summed on its
        device and the current stream there) to counter `name`."""
        if isinstance(n, int):
            self._host[name] += n
            return
        import torch
        key = (name, n.device, torch.cuda.current_stream(n.device).cuda_stream
               if n.is_cuda else None)
        total = self._dev.get(key)
        if total is None:
            self._dev[key] = n.reshape(()).to(torch.int64, copy=True)
        else:
            total.add_(n.reshape(()))

    def counters(self) -> dict:
        """Every counter's total, as ints (reads each device total)."""
        out = dict(self._host)
        for (name, *_), total in self._dev.items():
            out[name] = out.get(name, 0) + int(total)
        return out

    def dump(self, clear: bool = False) -> dict:
        """-> {"clock": "unix_ns", "spans": [{"id", "parent", "name",
        "start_ns", "end_ns", and the span's ids}, ...] in closing order,
        "counters": {name: total}}; with `clear`, then drop them."""
        spans = [{"id": i, "parent": up, "name": name, "start_ns": t0,
                  "end_ns": t1, **ids}
                 for i, up, name, ids, t0, t1 in self.spans]
        out = {"clock": "unix_ns", "spans": spans,
               "counters": self.counters()}
        if clear:
            self.clear()
        return out


TRACER = Tracer()


def span(name: str, step: int | None = None, frame: int | None = None):
    """A context that records span `name` (with its `step` and `frame`
    ids where given) while the tracer is on, and NULL_SPAN otherwise."""
    if not TRACER.on:
        return NULL_SPAN
    ids = {}
    if step is not None:
        ids["step"] = step
    if frame is not None:
        ids["frame"] = frame
    return _Span(TRACER, name, ids)


def count(name: str, n) -> None:
    """Add `n` to counter `name` while the tracer is on."""
    if TRACER.on:
        TRACER.count(name, n)
