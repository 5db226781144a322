"""The F-frame receive superstep: raw impaired device-rate samples ->
per-frame BB-frame byte hashes, BCH-clean counts and LDPC sweep counts.

Port of `one_superstep` in the repository's `bench.py` (the JAX product's
main path): the sample-domain front end emits class-ordered bf16 symbols,
the fused path turns them into (N, B, F) bf16 LLRs, and a per-frame loop
runs the layered LDPC decoder (the CUDA kernel on the card) with the
SNR-steered first-check floor, the BCH gate, the descramble + byte pack
and a slot-weighted 64-bit hash.  Everything stays on the device; the
caller fetches the small results and reassembles the TS on the host
(`bbframe.TSAssembler`).

Where one frame's decode needs more CTAs than the card holds at once
(`ldpc_layered.decodes_overlap`: the UK HD mode's 202 blocks on an H100's
132 SMs), each launch of the decoder ends in a wave that leaves SMs idle.
The frames' decodes and tails then run on SIDE_STREAMS side streams in
turn, so that one frame's last wave and the launches that return at once
after its exit vote share the card with the next frame's CTAs.  Every
frame's work is the same as on one stream.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..dvbt2.params import PLPParams, T2Params

from .._device import DeviceConst
from ..ops import fec_device
from ..ops import frontend_device as fdev
from ..ops.ldpc_layered import (decodes_overlap,
                                make_adaptive_decoder_nb_fused_io)
from ..utils.metrics import count, span
from .fusedpath import MultiFramePath

# below ~25 dB (inv_nvar < 316) convergence takes >= 10 sweeps, so the
# first syndrome check moves to sweep 8
FLOOR_INV_NVAR = 316.0
FLOOR_SWEEPS = 8
# the JAX bench's decoder: up to 24 sweeps, syndrome after every sweep,
# reversed layer order
MAX_SWEEPS = 24
HALF = 8          # Farrow resampler half-width (17 taps)
# side streams the frames' decodes and tails take in turn where decodes
# overlap (3 ran the 19 dB step ~1% faster than 2 on an H100; PERF.md)
SIDE_STREAMS = 3


def hash_weights(kb8: int, num_blocks: int, seed: int = 0xDB72) -> np.ndarray:
    """(2, kb8, B) int32 weights of the slot-sensitive 64-bit frame hash
    (the JAX bench's draw)."""
    wrng = np.random.default_rng(seed)
    return wrng.integers(-2**31, 2**31, (2, kb8, num_blocks),
                         dtype=np.int64).astype(np.int32)


def expected_hash(rows: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """Host expectation of one frame's hash: rows (B, kb8) BB bytes ->
    (2,) int32, the wrapping int32 sum of bytes x weights."""
    r = rows.astype(np.int64).T
    with np.errstate(over="ignore"):
        return (r[None] * weights.astype(np.int64)).astype(np.int32).sum(
            axis=(1, 2), dtype=np.int32)


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    return ((x + 2**31) % 2**32 - 2**31).to(torch.int32)


class Superstep:
    """fn(raw_r, raw_i (F, n_raw), inv_nvar, track (4,), keep=())
      -> (hashes (F, 2) int32, ok counts (F,) int32, total sweeps () int32,
          BB bytes (len(keep), kb8, B) uint8, row r frame keep[r]'s).

    `track` is the tracking state [cfo_hz, ratio, pos0, phase0] the front
    end corrects with (estimated by the product's acquisition); DC and IQ
    imbalance are estimated inside the step.  `weights` (2, kb8, B) int32
    are the hash weights (`hash_weights`).  `mark`, when given, is called
    with a stage's name ("frontend", "demod_llr", "ldpc", "fec_tail") each
    time that stage's work has been enqueued (a profiler records an event
    there; the LDPC and the tail report once per frame, on the stream
    that ran the frame).

    While the tracer of `utils/metrics` is on, a step records the spans
    "t2.step" (id `step`), "t2.frontend", "t2.demod_llr" and, per frame
    (id `frame`), "t2.ldpc" and "t2.fec_tail" with its parts
    "t2.fec_tail.bch", ".pack" and ".hash"; the decoder adds the LDPC
    counters (`ops/ldpc_layered.lockstep_counts`) and the step the
    counter "ldpc.overlapped_decodes": its frames decoded on side streams
    (F where decodes overlap, else 0)."""

    def __init__(self, p: T2Params, plp: PLPParams, num_blocks: int,
                 n_frames: int, fs: float, weights: np.ndarray):
        self.p, self.plp = p, plp
        self.num_blocks, self.n_frames = num_blocks, n_frames
        self.mf = MultiFramePath(p, plp, num_blocks, n_frames,
                                 llr_dtype=torch.bfloat16)
        self.frontend = fdev.make_frontend_symbols(
            p.len_frame, p.symbol_size, p.guard_size, fs, half=HALF,
            sym_order=self.mf.demod.sym_order, out_dtype=torch.bfloat16)
        self.decode = make_adaptive_decoder_nb_fused_io(
            plp.fec_frame, plp.rate, max_iters=MAX_SWEEPS, check_every=1,
            batch=num_blocks, layer_order="reversed")
        self.bch_check = fec_device.make_bch_check_nb(plp.fec_frame,
                                                      plp.rate)
        self.bb_pack = fec_device.make_bb_bytes_nb(plp.fec_frame, plp.rate)
        self.weights = DeviceConst(weights.astype(np.int64))
        self.steps = 0    # steps run: the `step` id of their spans
        self._code = self.decode.tab
        self._sides = {}  # device -> its side streams, or () for none

    def __call__(self, raw_r, raw_i, inv_nvar, track, keep=(), mark=None):
        mark = mark or (lambda stage: None)
        step = self.steps
        self.steps += 1
        with span("t2.step", step=step):
            return self._step(raw_r, raw_i, inv_nvar, track, keep, mark)

    def _step(self, raw_r, raw_i, inv_nvar, track, keep, mark):
        rows = {}                          # frame -> its rows of `kept`
        for r, fi in enumerate(keep):
            if not 0 <= fi < self.n_frames:
                raise IndexError(f"keep: frame {fi} of {self.n_frames}")
            rows.setdefault(fi, []).append(r)
        dev = raw_r.device
        n_bch = self.plp.fec.n_bch
        with span("t2.frontend"):
            (sr, si), _, _ = self.frontend(raw_r, raw_i, track[0], track[1],
                                           track[2], track[3])
        mark("frontend")
        with span("t2.demod_llr"):
            inv = torch.as_tensor(inv_nvar, dtype=torch.float32, device=dev)
            # frame-major (F, N, B): each decode then reads a contiguous
            # (N, B) block instead of a stride-F gather of its own.  On the
            # card K7 writes the LLRs in this layout, so nothing is copied;
            # on the CPU this is one copy
            llrs = self.mf.syms(sr, si, inv).permute(2, 0, 1).contiguous()
            min_it = torch.where(inv >= FLOOR_INV_NVAR, 0, FLOOR_SWEEPS).to(
                torch.int32)
            wb = self.weights.on(dev)
        mark("demod_llr")
        sides = self._side_streams(dev)
        count("ldpc.overlapped_decodes", self.n_frames if sides else 0)
        kb8 = self.plp.fec.k_bch // 8
        # uint8, not the pack's int32: a quarter of the bytes for the
        # caller to copy to the host.  Allocated on the caller's stream
        # before the side streams wait for it, so each may write its rows.
        kept = torch.empty((len(keep), kb8, self.num_blocks),
                           dtype=torch.uint8, device=dev)
        caller = torch.cuda.current_stream(dev) if sides else None
        for side in sides:
            side.wait_stream(caller)       # the LLRs, min_it, the weights
        sums, oks, its = [], [], []
        for fi in range(self.n_frames):
            with (torch.cuda.stream(sides[fi % len(sides)]) if sides
                  else contextlib.nullcontext()):
                with span("t2.ldpc", frame=fi):
                    bits, it = self.decode(llrs[fi], min_it)
                    its.append(it)
                mark("ldpc")
                with span("t2.fec_tail", frame=fi):
                    with span("t2.fec_tail.bch"):
                        ok = self.bch_check(bits[:n_bch])
                        oks.append(ok.sum(dtype=torch.int32))
                    with span("t2.fec_tail.pack"):
                        byts = self.bb_pack(bits)        # (kb8, B) int32
                    with span("t2.fec_tail.hash"):
                        sums.append(_wrap_i32((byts.long()[None] * wb).sum(
                            (1, 2))))
                    for r in rows.get(fi, ()):
                        kept[r].copy_(byts)
                mark("fec_tail")
        if sides:
            for side in sides:
                caller.wait_stream(side)
            # the caller's stream reads them: the allocator keeps each
            # block from its side stream until that read is done
            for t in (*sums, *oks, *its):
                t.record_stream(caller)
        return (torch.stack(sums), torch.stack(oks),
                torch.stack(its).sum(dtype=torch.int32), kept)

    def _side_streams(self, dev) -> tuple:
        """The side streams of `dev` where decodes overlap there, else ()
        (on the CPU, and where the card holds a frame's decode at once)."""
        sides = self._sides.get(dev)
        if sides is None:
            sides = self._sides[dev] = (
                tuple(torch.cuda.Stream(dev) for _ in range(SIDE_STREAMS))
                if decodes_overlap(self._code, self.num_blocks, dev)
                else ())
        return sides
