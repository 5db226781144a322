"""Faults planted under the timed path of a CPU run of the harness, for
the tests: each must make `correct` come out false.  The first four are
the superstep's (`cells.Program`), the rest the live path's
(`stream.Program`).

    python -c "from rxbench.tests import faults; faults.drive('<fault>', argv)"
"""
from __future__ import annotations

import sys

import torch

from rxbench import run


def ldpc_flip(prog):
    """The decoder's output corrupted: one bit of every decode flipped."""
    dec = prog.step.decode

    def bad(*a, **k):
        bits, it = dec(*a, **k)
        bits = bits.clone()
        bits[0, 0] ^= 1
        return bits, it
    prog.step.decode = bad


def state_unchanged(prog):
    """Every step returns the state of the first one."""
    issue, first = prog.issue, []

    def stale(*a, **k):
        if not first:
            first.append(issue(*a, **k))
        return first[0]
    prog.issue = stale


def half_batch(prog):
    """Half of the frames left out: their results are the other half's."""
    issue = prog.issue

    def half(*a, **k):
        sums, oks, iters, kept = issue(*a, **k)
        h = sums.shape[0] // 2
        sums, oks, kept = sums.clone(), oks.clone(), kept.clone()
        n = sums.shape[0] - h
        sums[h:], oks[h:], kept[h:] = (sums[:n].clone(), oks[:n].clone(),
                                        kept[:n].clone())
        return sums, oks, iters, kept
    prog.issue = half


def byte_altered(prog):
    """One byte of each frame altered where the byte pack produces it."""
    pack = prog.step.bb_pack

    def altered(bits):
        out = pack(bits).clone()
        out[0, 0] ^= 1
        return out
    prog.step.bb_pack = altered


def ts_byte_altered(prog):
    """Live path: one byte of each frame's BB frames altered where the
    device receiver produces them (after BCH, before the TS framer)."""
    from sdr_receiver_dvb_t2_tpu_torch.ops import fec_device
    bch = fec_device.bch_correct_batch

    def altered(*a, **k):
        bb = bch(*a, **k).copy()
        bb[0, 80 + 8 * 20] ^= 1
        return bb
    fec_device.bch_correct_batch = altered


def frame_dropped_at_seam(prog):
    """Live path: the capture's loop goes on from its second frame after
    the seam, so one frame is lost there."""
    prog.device.restart = int(round(prog.frame_raw))


def batch_half_decoded(prog):
    """Live path: the batched decode decodes the first half of its frames
    and reports them all done."""
    batch = prog.rx.decode_frames_batch

    def half(x, starts, *a, **k):
        done = batch(x, starts[:len(starts) // 2], *a, **k)
        return len(starts) if done else 0
    prog.rx.decode_frames_batch = half


def frames_unchanged(prog):
    """Live path: every frame hands the TS framer the first frame's
    decoded bits."""
    push, first = prog.rx._push_plp, []

    def stale(plp, dyn, plps, bits, *a, **k):
        if not first:
            first.append(bits)
        return push(plp, dyn, plps, first[0], *a, **k)
    prog.rx._push_plp = stale


FAULTS = {f.__name__: f for f in (ldpc_flip, state_unchanged, half_batch,
                                  byte_altered, ts_byte_altered,
                                  frame_dropped_at_seam, batch_half_decoded,
                                  frames_unchanged)}


def drive(fault: str | None, argv: list[str]) -> int:
    """A whole run on the CPU, the fault planted (None: none)."""
    torch.set_num_threads(2)
    return run.main(argv, device="cpu",
                    patch=FAULTS[fault] if fault else None)


if __name__ == "__main__":
    sys.exit(drive(sys.argv[1] or None, sys.argv[2:]))
