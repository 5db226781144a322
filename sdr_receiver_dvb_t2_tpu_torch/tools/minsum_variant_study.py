#!/usr/bin/env python
"""Convergence study: offset against normalized (scaled) min-sum at the
bench's operating point (NORMAL C2/3, unrotated 256QAM demapped LLRs at
19 dB), over the layered stepper `ops/ldpc_layered.build_layered_stepper`
(f32 messages) and `qc_syndrome_ok`.  After the JAX repository's
`tools/minsum_variant_study.py`, whose NumPy mirror of the schedule the
stepper replaces (the same schedule: tables, rolls, argmin leave-one-out).

Reports per correction rule the sweeps each codeword needs to be clean,
their mean, p90 and the batch maximum (what a lockstep kernel pays), and
the failures.

Usage: python -m sdr_receiver_dvb_t2_tpu_torch.tools.minsum_variant_study
[--snr 19] [--blocks 64] [--max-iters 30] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .._device import resolve
from ..dvbt2.params import CodeRate, Constellation, FECFrame, PLPParams
from ..ops import ldpc_layered as ll
from ..ops.ldpc_tables import llrs_to_qc

FRAME, RATE = FECFrame.NORMAL, CodeRate.C2_3
VARIANTS = (("offset0.50  (shipped)", 0.50, 1.0),
            ("offset0.30", 0.30, 1.0),
            ("scale0.750", 0.0, 0.750),
            ("scale0.875", 0.0, 0.875),
            ("off0.25+s0.9", 0.25, 0.9),
            # larger effective offsets: the LLRs scale with inv_nvar, so
            # 0.5 is a few % of the typical magnitude at 19 dB
            ("offset1.00", 1.00, 1.0),
            ("offset2.00", 2.00, 1.0),
            ("offset4.00", 4.00, 1.0))


def layered_minsum_iters(llrs_nat, offset, scale, max_iters, dev):
    """Layered decode of (B, N) natural-order LLRs -> sweeps to clean
    (B,) int64 (max_iters+1 = never clean)."""
    tab = ll.qc_tables(FRAME, RATE)
    step = ll.build_layered_stepper(FRAME, RATE, offset=offset, scale=scale)
    ti, tp = (torch.from_numpy(a).to(dev)
              for a in llrs_to_qc(tab, llrs_nat))
    b = llrs_nat.shape[0]
    c2v = torch.zeros((tab.q, tab.degmax + 2, 360, b), device=dev)
    done = np.full(b, max_iters + 1, np.int64)
    clean_prev = np.zeros(b, bool)
    for it in range(1, max_iters + 1):
        ti, tp, c2v = step(ti, tp, c2v)
        clean = ll.qc_syndrome_ok(FRAME, RATE, ti, tp).cpu().numpy()
        done[clean & ~clean_prev] = it
        clean_prev = clean
        if clean.all():
            break
    return done


def run(snr=19.0, blocks=64, max_iters=30, seed=0, variants=VARIANTS,
        device="cuda", log=lambda m: print(m, file=sys.stderr)) -> dict:
    """-> {variant: {"fails", "mean", "p90", "batchmax"}}."""
    from ..rx import decode as rxdecode
    from ..tx import fec as txfec
    dev = resolve(device, "minsum_variant_study")
    plp = PLPParams(constellation=Constellation.QAM256, rate=RATE,
                    fec_frame=FRAME, rotated=False, num_blocks_max=blocks,
                    time_il_length=1)
    rng = np.random.default_rng(seed)
    bb = rng.integers(0, 2, (blocks, plp.fec.k_bch)).astype(np.uint8)
    cells = txfec.plp_encode(plp, bb)
    pwr = float(np.mean(np.abs(cells) ** 2))
    nvar = pwr * 10 ** (-snr / 10.0)
    noisy = (cells + rng.normal(0, np.sqrt(nvar / 2), cells.shape)
             + 1j * rng.normal(0, np.sqrt(nvar / 2), cells.shape))
    llr_v = rxdecode.llr_demap(plp, noisy.astype(np.complex64), nvar)
    llrs = rxdecode.bits_from_llrs(plp, llr_v)
    out = {}
    for name, off, sc in variants:
        t0 = time.time()
        iters = layered_minsum_iters(llrs, off, sc, max_iters, dev)
        fails = int((iters > max_iters).sum())
        shown = np.minimum(iters, max_iters)
        out[name] = {"fails": fails, "mean": float(shown.mean()),
                     "p90": float(np.percentile(shown, 90)),
                     "batchmax": int(shown.max())}
        log(f"[{name}] fails {fails}/{blocks}; iters mean "
            f"{shown.mean():.2f} p90 {np.percentile(shown, 90):.0f} "
            f"batchmax {shown.max()} ({time.time() - t0:.1f}s)")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--snr", type=float, default=19.0)
    ap.add_argument("--blocks", type=int, default=64)
    ap.add_argument("--max-iters", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    run(args.snr, args.blocks, args.max_iters, args.seed,
        device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
