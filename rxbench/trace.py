"""Reading a traced run: torch.profiler's device operations over the
window's steps, the harness's own host ranges around its calls into the
program, and CUDA events at the superstep's stage marks.

Host ranges (`record_function`, all named "rx.*"): "rx.step" around each
call of `Superstep.__call__`, "rx.fetch" around the bytes' copy to the
host, and one range per stage while that stage is being enqueued
("rx.frontend", "rx.demod_llr", "rx.ldpc", "rx.fec_tail"), opened and
closed by the program's `mark` calls.  An idle gap of the device is named
by the innermost range open on the host when it began."""
from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict

import torch

from . import roofline

STAGES = ("frontend", "demod_llr", "ldpc", "fec_tail")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10
NAME_CHARS = 120              # a device operation's name, cut for the record


class Marks:
    """The `mark` callback of one step: the stage host ranges, and a CUDA
    event at every stage mark when `timed` (the stage's device time is the
    gap to the event before)."""

    def __init__(self, timed: bool):
        self.timed = timed
        self.events = []
        self.open = None

    def _record(self, stage):
        if self.timed:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append((stage, ev))

    def start(self):
        self._record("start")
        self._enter("frontend")

    def _enter(self, stage):
        self.open = torch.autograd.profiler.record_function(f"rx.{stage}")
        self.open.__enter__()

    def _exit(self):
        if self.open is not None:
            self.open.__exit__(None, None, None)
            self.open = None

    def __call__(self, stage):
        self._record(stage)
        self._exit()
        self._enter("fec_tail" if stage == "ldpc" else "ldpc")

    def finish(self):
        self._exit()

    def stage_ms(self) -> dict:
        """Device ms by stage of the step (after a synchronize)."""
        out = defaultdict(float)
        for (_, e0), (stage, e1) in zip(self.events, self.events[1:]):
            out[stage] += e0.elapsed_time(e1)
        return out


class Profile:
    """The traced steps of a window, in sessions of torch.profiler, each
    read and dropped before the next: their device seconds and idle gaps
    summed.  `steps` is the indices of the steps traced (the caller's)."""

    # host ranges that name idle gaps: those whose names start with
    # PREFIX, in two families that each hold ranges following one another
    # (INNER: the stage ranges), the innermost family searched first
    PREFIX = "rx."
    INNER = STAGES

    def __init__(self):
        self.busy = self.wall = self.k1 = 0.0
        self.by_op = defaultdict(float)
        self.idle = defaultdict(float)
        self.steps = []
        self._open = None

    def run(self, run_steps):
        """Run `run_steps()` under torch.profiler and add its trace."""
        self.begin()
        run_steps()
        self.end()

    def begin(self):
        """Start a profiling session (`end` closes and reads it)."""
        from torch.profiler import ProfilerActivity
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
        window = torch.autograd.profiler.record_function("rx.window")
        window.__enter__()
        self._open = (prof, window, time.perf_counter())

    def end(self):
        prof, window, t0 = self._open
        self._open = None
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.wall += time.perf_counter() - t0
        window.__exit__(None, None, None)
        prof.__exit__(None, None, None)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        self._add(events)

    def _add(self, events):
        dev = [e for e in events
               if e.get("cat") in DEVICE_CATS and "dur" in e]
        notes = [e for e in events if e.get("cat") == "user_annotation"]
        win = next((e for e in notes if e.get("name") == "rx.window"), None)
        host = [e for e in notes
                if str(e.get("name", "")).startswith(self.PREFIX)]
        for e in dev:
            self.by_op[e["name"][:NAME_CHARS]] += e["dur"] * 1e-6
            if roofline.is_k1(e["name"]):
                self.k1 += e["dur"] * 1e-6
        # busy: the union of the device operations' intervals
        spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in dev)
        busy, gaps = 0.0, []
        lo = win["ts"] if win else (spans[0][0] if spans else 0.0)
        hi = lo + (win["dur"] if win else 0.0)
        cur = lo
        for s, t in spans:
            if s > cur:
                gaps.append((cur, s))
            if t > cur:
                busy += t - max(s, cur)
                cur = t
        if hi > cur:
            gaps.append((cur, hi))
        self.busy += busy * 1e-6
        # name each gap by the innermost host range open at its start:
        # the stage ranges follow one another, and so do "rx.step" and
        # "rx.fetch", so one search in each family finds it
        cut = len(self.PREFIX)
        families = [sorted((e["ts"], e["ts"] + e["dur"], e["name"])
                           for e in host
                           if (e["name"][cut:] in self.INNER) == inner)
                    for inner in (True, False)]
        families[1] = [r for r in families[1] if r[2] != "rx.window"]
        for s, t in gaps:
            name = f"outside any {self.PREFIX[:-1]} range"
            for fam in families:
                i = bisect.bisect_right(fam, (s, float("inf"), "")) - 1
                if i >= 0 and fam[i][0] <= s < fam[i][1]:
                    name = fam[i][2]
                    break
            self.idle[name] += (t - s) * 1e-6

    def result(self) -> dict:
        """-> {"busy_s": seconds in which a device operation ran,
        "window_s": the traced wall time, "k1_s": K1's device seconds,
        "device_ops": the TOP operations by device seconds, "idle_gaps":
        the device's idle seconds by the host range open when each gap
        began, the TOP largest, "steps": the steps traced}."""
        def top(d):
            return [[k, v] for k, v in sorted(d.items(),
                                              key=lambda kv: -kv[1])[:TOP]]
        return {"busy_s": self.busy, "window_s": self.wall,
                "k1_s": self.k1, "device_ops": top(self.by_op),
                "idle_gaps": top(self.idle), "steps": list(self.steps)}
