"""Timing of a data-dependent chain, the microbenches' one clock.

Each step's input is the last step's output (`step(state) -> state`), so
no call can overlap or skip another.  On the card the steps are timed with
CUDA events on the current stream; on the CPU (the tests' tiny sizes) with
the host clock, which no device number is ever taken from.
"""
from __future__ import annotations

import time

import torch


def chain_ms(step, state, reps: int, device):
    """Mean ms of one step over `reps` steps after one warm-up step.
    -> (ms, the last state)."""
    state = step(state)
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            state = step(state)
        return 1e3 * (time.perf_counter() - t0) / reps, state
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        state = step(state)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, state


def probe(x) -> torch.Tensor:
    """One element of a tensor (or of the first tensor of a nest) as a
    finite f32 (0 where it is not): the data dependence a chain step
    carries forward, which never turns its input into inf or NaN."""
    while isinstance(x, (list, tuple)):
        x = x[0]
    x = x.reshape(-1)[:1]
    x = (x.real if x.is_complex() else x).float()
    return torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)


def differing(a: torch.Tensor, b: torch.Tensor) -> int:
    """Elements where a and b are not bit for bit equal, NaN equal to NaN
    in the same place (random inputs to an equalizer can make a channel
    estimate of 0); every element when the shapes differ."""
    if a.shape != b.shape:
        return max(a.numel(), b.numel())
    return int((~((a == b) | (a.isnan() & b.isnan()))).sum())
