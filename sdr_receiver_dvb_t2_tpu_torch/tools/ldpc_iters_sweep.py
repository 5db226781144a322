#!/usr/bin/env python
"""Sweep-count study of the fixed-sweep layered decoder K3 (`make_core`
"vmem", bf16 c2v) at the bench's 256QAM C2/3 NORMAL point, B=128:
post-LDPC bit errors and failed codewords against SNR (17-21 dB) at 6, 8,
10 and 14 sweeps.  After the JAX repository's `tools/ldpc_iters_sweep.py`.

256QAM cells through an AWGN channel give exact max-log LLRs (per axis,
y0 on I, y1 on Q, ...) on the host; the decodes run on the card.  A row
with no residual errors at a sweep count says that count is safe for a
fixed-sweep decode there.

Usage: python -m sdr_receiver_dvb_t2_tpu_torch.tools.ldpc_iters_sweep
[--snr 17 17.5 18 19 21] [--iters 6 8 10 14]
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from .._device import resolve
from ..dvbt2 import tables
from ..dvbt2.params import CodeRate, Constellation, FECFrame
from ..ops import ldpc_layered as ll
from ..utils.benchgen import codewords

SNRS = (17.0, 17.5, 18.0, 19.0, 21.0)
ITERS = (6, 8, 10, 14)


class QAM256Channel:
    """Codewords as 256QAM cells with exact max-log LLRs after AWGN."""

    def __init__(self, cw: np.ndarray, rng):
        m = 8
        half = m // 2
        self.levels = (tables._gray_levels(m) * tables.NORM_FACTOR[
            Constellation.QAM256]).astype(np.float64)
        words = np.arange(len(self.levels))
        self.masks = np.stack([(words >> (half - 1 - b)) & 1
                               for b in range(half)]).astype(bool)
        self.b, self.rng, self.half = cw.shape[0], rng, half
        bits = cw.reshape(self.b, -1, m)
        self.si = self._axis_to_sym(bits[:, :, 0::2])
        self.sq = self._axis_to_sym(bits[:, :, 1::2])
        self.es = float(np.mean(self.si ** 2 + self.sq ** 2))

    def _axis_to_sym(self, axbits):
        idx = np.zeros(axbits.shape[:2], np.int64)
        for b in range(self.half):
            idx = (idx << 1) | axbits[:, :, b]
        return self.levels[idx]

    def _ax_llr(self, r, nvar):
        d2 = (r[..., None] - self.levels) ** 2
        out = []
        for b in range(self.half):
            d0 = np.min(np.where(self.masks[b], 1e30, d2), axis=-1)
            d1 = np.min(np.where(self.masks[b], d2, 1e30), axis=-1)
            out.append((d1 - d0) / nvar)
        return np.stack(out, axis=-1)

    def llrs(self, snr_db: float) -> np.ndarray:
        """(B, N) f32 LLRs of one noise draw at `snr_db`."""
        nvar = self.es / (10.0 ** (snr_db / 10.0))
        ri = self.si + self.rng.normal(0, np.sqrt(nvar / 2), self.si.shape)
        rq = self.sq + self.rng.normal(0, np.sqrt(nvar / 2), self.sq.shape)
        li, lq = self._ax_llr(ri, nvar), self._ax_llr(rq, nvar)
        # per-cell bit order y0(I), y1(Q), y2(I), ...
        return np.stack([li, lq], axis=-1).reshape(self.b, -1).astype(
            np.float32)


def run(frame=FECFrame.NORMAL, rate=CodeRate.C2_3, batch: int = 128,
        snrs=SNRS, iters=ITERS, device="cuda", log=print) -> list:
    """-> one row per SNR: {"snr", "it<k>": {"bit_errors",
    "failed_codewords"}}."""
    dev = resolve(device, "ldpc_iters_sweep")
    cw = codewords(frame, rate, batch, 42)
    ch = QAM256Channel(cw, np.random.default_rng(42))
    rows = []
    for snr in snrs:
        v = torch.from_numpy(np.ascontiguousarray(ch.llrs(snr).T)).to(dev)
        row = {"snr": snr}
        for it in iters:
            dec = ll.make_decoder_nb(frame, rate, it, batch, variant="vmem")
            hard = dec(v).cpu().numpy().T
            row[f"it{it}"] = {"bit_errors": int((hard != cw).sum()),
                              "failed_codewords":
                                  int((hard != cw).any(axis=1).sum())}
        log(f"snr={snr:5.1f}  " + "  ".join(
            f"it{it}: {row[f'it{it}']['bit_errors']}be/"
            f"{row[f'it{it}']['failed_codewords']}cw" for it in iters))
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--snr", type=float, nargs="*", default=list(SNRS))
    ap.add_argument("--iters", type=int, nargs="*", default=list(ITERS))
    args = ap.parse_args(argv)
    print(json.dumps(run(snrs=args.snr, iters=args.iters)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
