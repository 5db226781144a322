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
"""
from __future__ import annotations

import numpy as np
import torch

from ..dvbt2.params import PLPParams, T2Params

from .._device import DeviceConst
from ..ops import fec_device
from ..ops import frontend_device as fdev
from ..ops.ldpc_layered import (make_adaptive_decoder_nb_fused_io,
                                make_decoder_nb)
from ..utils.metrics import span
from .fusedpath import MultiFramePath

# below ~25 dB (inv_nvar < 316) convergence takes >= 10 sweeps, so the
# first syndrome check moves to sweep 8
FLOOR_INV_NVAR = 316.0
FLOOR_SWEEPS = 8
# the bench's decoder: up to 24 sweeps, syndrome after every sweep,
# reversed layer order
MAX_SWEEPS = 24
HALF = 8          # Farrow resampler half-width (17 taps)


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
          BB bytes (len(keep), kb8, B) int32 of the frames in `keep`).

    `track` is the tracking state [cfo_hz, ratio, pos0, phase0] the front
    end corrects with (estimated by the product's acquisition); DC and IQ
    imbalance are estimated inside the step.  `weights` (2, kb8, B) int32
    are the hash weights (`hash_weights`).  `mark`, when given, is called
    with a stage's name ("frontend", "demod_llr", "ldpc", "fec_tail") each
    time that stage's work has been enqueued (a profiler records an event
    there; the LDPC and the tail report once per frame).

    While the tracer of `utils/metrics` is on, a step records the spans
    "t2.step" (id `step`), "t2.frontend", "t2.demod_llr" and, per frame
    (id `frame`), "t2.ldpc" and "t2.fec_tail" with its parts
    "t2.fec_tail.bch", ".pack" and ".hash"; the decoder adds the LDPC
    counters (`ops/ldpc_layered.lockstep_counts`).

    `fixed_iters` > 0 swaps the adaptive decoder (K1) for `fixed_iters`
    sweeps of the fixed one (`make_decoder_nb`: K3 at C2/3), which ignores
    the floor; the sweep count is then `fixed_iters` per frame."""

    def __init__(self, p: T2Params, plp: PLPParams, num_blocks: int,
                 n_frames: int, fs: float, weights: np.ndarray,
                 fixed_iters: int = 0):
        self.p, self.plp = p, plp
        self.num_blocks, self.n_frames = num_blocks, n_frames
        self.mf = MultiFramePath(p, plp, num_blocks, n_frames,
                                 llr_dtype=torch.bfloat16)
        self.frontend = fdev.make_frontend_symbols(
            p.len_frame, p.symbol_size, p.guard_size, fs, half=HALF,
            sym_order=self.mf.demod.sym_order, out_dtype=torch.bfloat16)
        self.fixed_iters = fixed_iters
        if fixed_iters:
            self.decode = make_decoder_nb(plp.fec_frame, plp.rate,
                                          iters=fixed_iters, batch=num_blocks)
        else:
            self.decode = make_adaptive_decoder_nb_fused_io(
                plp.fec_frame, plp.rate, max_iters=MAX_SWEEPS,
                check_every=1, batch=num_blocks, layer_order="reversed")
        self.bch_check = fec_device.make_bch_check_nb(plp.fec_frame,
                                                      plp.rate)
        self.bb_pack = fec_device.make_bb_bytes_nb(plp.fec_frame, plp.rate)
        self.weights = DeviceConst(weights.astype(np.int64))
        self.steps = 0    # steps run: the `step` id of their spans

    def __call__(self, raw_r, raw_i, inv_nvar, track, keep=(), mark=None):
        mark = mark or (lambda stage: None)
        step = self.steps
        self.steps += 1
        with span("t2.step", step=step):
            return self._step(raw_r, raw_i, inv_nvar, track, keep, mark)

    def _step(self, raw_r, raw_i, inv_nvar, track, keep, mark):
        dev = raw_r.device
        n_bch = self.plp.fec.n_bch
        with span("t2.frontend"):
            (sr, si), _, _ = self.frontend(raw_r, raw_i, track[0], track[1],
                                           track[2], track[3])
        mark("frontend")
        with span("t2.demod_llr"):
            inv = torch.as_tensor(inv_nvar, dtype=torch.float32, device=dev)
            # one frame-major copy (F, N, B): each decode then reads a
            # contiguous (N, B) block instead of a stride-F gather of its
            # own
            llrs = self.mf.syms(sr, si, inv).permute(2, 0, 1).contiguous()
            min_it = torch.where(inv >= FLOOR_INV_NVAR, 0, FLOOR_SWEEPS).to(
                torch.int32)
            wb = self.weights.on(dev)
            iters = torch.zeros((), dtype=torch.int32, device=dev)
        mark("demod_llr")
        sums, oks, kept = [], [], {}
        for fi in range(self.n_frames):
            with span("t2.ldpc", frame=fi):
                if self.fixed_iters:
                    bits, it = self.decode(llrs[fi]), self.fixed_iters
                else:
                    bits, it = self.decode(llrs[fi], min_it)
            mark("ldpc")
            with span("t2.fec_tail", frame=fi):
                with span("t2.fec_tail.bch"):
                    ok = self.bch_check(bits[:n_bch])
                    oks.append(ok.sum(dtype=torch.int32))
                with span("t2.fec_tail.pack"):
                    byts = self.bb_pack(bits)            # (kb8, B) int32
                with span("t2.fec_tail.hash"):
                    sums.append(_wrap_i32((byts.long()[None] * wb).sum(
                        (1, 2))))
                iters = iters + it
                if fi in keep:
                    kept[fi] = byts
            mark("fec_tail")
        kept_bytes = (torch.stack([kept[fi] for fi in keep]) if keep else
                      torch.zeros((0,) + byts.shape, dtype=torch.int32,
                                  device=dev))
        return torch.stack(sums), torch.stack(oks), iters, kept_bytes
