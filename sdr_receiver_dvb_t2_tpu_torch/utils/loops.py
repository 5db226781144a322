"""Control-loop primitives (DSP parity with the reference's loop_filters.hh):
proportional-integral loop filter with anti-windup and an exponential
averager, written as pure (state, x) -> (state, y) steps usable in a loop
over torch tensors on a device or plain Python on host.

The batch receive chain replaces per-sample loops with per-block feed-forward
estimation (SURVEY.md §7), but tracking applications (long-capture SCO/CPE
smoothing across frames, AGC) still want these classical loops.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class PIState:
    integrator: float = 0.0


@dataclass
class PILoopFilter:
    """PI filter parameterized like the reference (damping, normalized
    bandwidth, gain) with anti-windup clamping (loop_filters.hh:20-54)."""
    bandwidth: float
    damping: float = 0.7071
    gain: float = 1.0
    clamp: float = np.inf

    def __post_init__(self):
        bw = self.bandwidth
        d = self.damping
        denom = 1.0 + 2.0 * d * bw + bw * bw
        self.kp = 4.0 * d * bw / denom / self.gain
        self.ki = 4.0 * bw * bw / denom / self.gain

    def step(self, state: PIState, error: float) -> tuple[PIState, float]:
        integ = state.integrator + self.ki * error
        integ = float(np.clip(integ, -self.clamp, self.clamp))
        out = self.kp * error + integ
        return PIState(integ), out

    def scan_fn(self):
        """(integ, err) -> (integ', out) on torch tensors, for a loop."""
        kp, ki, cl = self.kp, self.ki, self.clamp

        def f(integ, err):
            import torch
            integ = torch.clamp(integ + ki * err, -cl, cl)
            return integ, kp * err + integ
        return f


@dataclass
class ExponentialAverager:
    """One-pole smoother (DC tracker), loop_filters.hh:56-73."""
    alpha: float

    def step(self, state: complex, x: complex) -> tuple[complex, complex]:
        s = state + self.alpha * (x - state)
        return s, s

    def run(self, xs: np.ndarray, init: complex = 0.0) -> np.ndarray:
        out = np.empty_like(xs)
        s = init
        a = self.alpha
        for i, x in enumerate(xs):
            s = s + a * (x - s)
            out[i] = s
        return out
