"""The comparison that decides `correct`, and its control.

Numbers compared, each with its limit (the workload file's `limits`; an
exact comparison has the limit 0):

- `bad_frames`: frames of the window, every step and every frame, whose
  64-bit byte hash differs from the truth's or whose BCH-clean count is
  below the frame's FEC blocks (the FEC tail's verdicts and bytes);
- `byte_errors`: BB bytes differing from the truth, over every frame of
  steps drawn from the seed (the bytes the host received);
- `ldpc_bit_errors`: decoded codeword bits differing from the transmitted
  codewords, over the sampled frames of the check steps (`Superstep.decode`);
- `frontend_err`: ||program - reference|| / ||reference|| of the sampled
  frames' symbol planes (`Superstep.frontend`) over the carriers the
  receiver demodulates, each symbol first turned by the common phase and
  shifted by the delay that the receiver's pilots take out
  (`reference.band_err`), worst frame.  The reference front end
  runs on the generator's true tracking state, so an error of the
  program's tracking state counts here by what it leaves within a symbol;
- `llr_err`: the same, unaligned, for their LLRs (`Superstep.mf.syms`),
  the reference chained from its own front end, worst frame;
- `timing_err_samples`: the largest distance, over a frame's read
  positions, between where the program's tracking state [cfo_hz, ratio,
  pos0] reads the raw samples and where the true state does.

The check steps are the timed entry itself (`Superstep.__call__` at the
timed F, every frame kept), run once per pool entry after the window with
the program's stage functions wrapped to keep the sampled frames' outputs.
The control puts the reference in the program's place one precision below
what the configuration states: float8 (e4m3) wherever it states bfloat16,
and the tracking state in bfloat16 where it states float32.  It has to
come out not correct."""
from __future__ import annotations

import numpy as np
import torch

from . import reference
from .gen import synth

EXACT = ("bad_frames", "byte_errors", "ldpc_bit_errors")
TOLERANCE = ("frontend_err", "llr_err", "timing_err_samples")
CONTROL_DTYPE = torch.float8_e4m3fn
CONTROL_TRACK_DTYPE = torch.bfloat16


def control_track() -> list[float]:
    """The control's tracking state: the true one rounded to bfloat16."""
    return [float(torch.tensor(v, dtype=torch.float64).to(
        CONTROL_TRACK_DTYPE)) for v in synth.TRUTH]


def timing_err(track, p) -> float:
    """The largest |position(track) - position(truth)| in raw samples over
    the read positions k * ratio + pos0 of one frame, k from 0 to the
    frame's length (`track`: [cfo_hz, ratio, pos0, ...]; the distance is
    linear in k, so largest at an end)."""
    d_ratio = float(track[1]) - synth.TRUTH[1]
    d_pos0 = float(track[2]) - synth.TRUTH[2]
    return max(abs(d_pos0), abs(d_pos0 + d_ratio * p.frame_samples))


def capture(prog, raw, frames: list[int]) -> dict:
    """One step of `prog` on `raw` with the superstep's front end, LLR
    stage and decoder wrapped to keep frames `frames`' outputs.
    -> {"planes": [(S, fft) complex, class order], "llrs": [(n, B) f32],
    "bits": [(n, B) uint8], "track": the tracking state as floats}."""
    step = prog.step
    got = {"planes": [], "llrs": [], "bits": {}, "track": prog.track_host}
    fe, syms, dec = step.frontend, step.mf.syms, step.decode
    calls = [0]

    def frontend(*a, **k):
        out = fe(*a, **k)
        (sr, si), _, _ = out
        got["planes"] = [torch.complex(sr[f].float(), si[f].float())
                         for f in frames]
        return out

    def llr_stage(*a, **k):
        out = syms(*a, **k)
        got["llrs"] = [out[:, :, f].float() for f in frames]
        return out

    def decode(*a, **k):
        out = dec(*a, **k)
        fi, calls[0] = calls[0], calls[0] + 1
        if fi in frames:
            got["bits"][fi] = (out[0] if isinstance(out, tuple) else out
                               ).clone()
        return out

    step.frontend, step.mf.syms, step.decode = frontend, llr_stage, decode
    try:
        prog(raw)
    finally:
        step.frontend, step.decode = fe, dec
        del step.mf.syms
    got["bits"] = [got["bits"].get(f) for f in frames]
    return got


class LayerCheck:
    """Reference readings of sampled frames: the reference front end from
    the raw planes and the generator's true tracking state, the reference
    LLRs from that front end, and the transmitted codewords."""

    def __init__(self, inputs):
        self.inputs = inputs
        self.demod = reference.Demod(inputs.p, inputs.plp,
                                     inputs.base.cellmap, inputs.device)
        p = inputs.p
        self.band = (p.left_nulls, p.left_nulls + p.k_total)
        order = reference.symbol_order(p)
        self.natural = torch.from_numpy(np.argsort(order)).to(inputs.device)

    def reference(self, entry: int, frame: int, quant=None,
                  track=synth.TRUTH):
        """-> (planes (S, fft) complex128, LLRs (n, B) float64) on tracking
        state `track`."""
        raw = self.inputs.pool[entry]
        planes = reference.frontend(raw[0][frame], raw[1][frame], frame,
                                    track, self.inputs.p, synth.FS,
                                    quant=quant)
        return planes, self.demod.llrs(planes, self.inputs.inv_nvar,
                                       quant=quant)

    def numbers(self, entry: int, frames: list[int], got=None,
                control: bool = False) -> dict:
        """The layer numbers over `frames` of pool entry `entry`: the
        program's (`got` from `capture`) or, with control, the control's
        (the reference on the bfloat16 tracking state, its stored
        intermediates in float8)."""
        out = {"frontend_err": 0.0, "llr_err": 0.0, "ldpc_bit_errors": 0}
        cw = self.inputs.base.codewords
        for i, f in enumerate(frames):
            planes, llrs = self.reference(entry, f)
            if control:
                p_got, l_got = self.reference(entry, f, quant=CONTROL_DTYPE,
                                              track=control_track())
            else:
                # an output the step never produced reads as wrong
                p_got = (got["planes"][i][self.natural]
                         if len(got["planes"]) > i else None)
                l_got = got["llrs"][i] if len(got["llrs"]) > i else None
                truth = cw[self.inputs.slots[entry][f]].T
                bits = got["bits"][i]
                out["ldpc_bit_errors"] += (
                    truth.size if bits is None else int(
                        (bits.cpu().numpy() != truth).sum()))
            out["frontend_err"] = worst(out["frontend_err"],
                                        reference.band_err(p_got, planes,
                                                           *self.band))
            out["llr_err"] = worst(out["llr_err"],
                                   reference.rel_err(l_got, llrs))
        out["timing_err_samples"] = timing_err(
            control_track() if control else got["track"], self.inputs.p)
        if control:
            del out["ldpc_bit_errors"]
        return out


def worst(a, b):
    """The worse of two readings, None standing for no reading; NaN is the
    worst of all."""
    if a is None or b != b:
        return b
    if a != a:
        return a
    return max(a, b)


def window_numbers(inputs, records, kept) -> dict:
    """bad_frames over every window step (`records`: (entry, hashes,
    BCH-clean counts)) and byte_errors over the kept steps ((entry, bytes)
    pairs)."""
    bad = 0
    for entry, sums, oks in records:
        bad += int((np.any(sums != inputs.hashes[entry], axis=1)
                    | (oks != inputs.nb)).sum())
    errs = 0
    for entry, byts in kept:
        errs += int((byts != inputs.truth_bytes(entry)).sum())
    return {"bad_frames": bad, "byte_errors": errs}


def verdict(numbers: dict, limits: dict, exact=EXACT,
            tolerance=TOLERANCE) -> tuple[bool, dict]:
    """-> (every number within its limit, {name: {"value", "limit"}}):
    the names of `exact` at the limit 0, those of `tolerance` at the
    workload file's."""
    table = {}
    for name in exact + tolerance:
        if name in numbers:
            table[name] = {"value": numbers[name],
                           "limit": 0 if name in exact else limits[name]}
    ok = all(v["value"] <= v["limit"] for v in table.values())  # NaN fails
    return ok, table
