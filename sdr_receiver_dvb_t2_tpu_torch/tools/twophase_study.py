#!/usr/bin/env python
"""Two-phase LDPC decode study at the bench's 19 dB operating point
(256QAM C2/3 NORMAL, rotated), over the layered stepper
`ops/ldpc_layered.build_layered_stepper` on the card.  After the JAX
repository's `tools/twophase_study.py`.

The adaptive kernels pay the batch's maximum: all 128 codewords of a frame
sweep until the slowest is clean.  Two schemes attack the gap between
that maximum and the per-codeword mean:

  A. survivor compaction: every codeword runs k1 sweeps, then the
     unconverged ones are gathered into dense 128-codeword batches and
     finished from their posterior totals with zeroed messages;
  B. difficulty-sorted batches: predict each codeword's difficulty before
     decoding (EVM, LLR reliability, the first syndrome weight), sort, and
     fill batches in that order.

Each is reported in sweeps per 128-codeword batch, the unit of the
kernels' sweeps per frame.  `--variants` compares min-sum variants under
the kernels' bf16 message precision; `--schedules` compares layer orders.
The demapped LLRs come from the host's exact max-log demapper
(`rx/decode.llr_demap`, minutes for 512 blocks); the decodes run on the
card in seconds.

Usage: python -m sdr_receiver_dvb_t2_tpu_torch.tools.twophase_study
[--snr 19] [--blocks 512] [--max-iters 30] [--k1 8 10 11] [--variants |
--schedules] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .._device import resolve
from ..dvbt2 import tables
from ..dvbt2.params import CodeRate, Constellation, FECFrame, PLPParams
from ..ops import ldpc_layered as ll
from ..ops.ldpc_tables import llrs_to_qc

FRAME, RATE = FECFrame.NORMAL, CodeRate.C2_3
BATCH = 128


def err(msg):
    print(msg, file=sys.stderr)


def to_bf16(x: np.ndarray) -> np.ndarray:
    """f32 values rounded to bf16, as the kernels' input stage rounds."""
    return torch.from_numpy(x).bfloat16().float().numpy()


def decode_study(llrs_nat: np.ndarray, max_iters: int, record_at, dev,
                 label="", offset=0.5, scale=1.0, c2v_dtype=None,
                 layer_order=None, log=err):
    """Sweep-by-sweep decode of (B, N) natural-order LLRs.  -> (sweeps to
    clean (B,) int64, max_iters+1 where never clean; snapshots {k: (ti,
    tp)}; the first syndrome weight (B,))."""
    tab = ll.qc_tables(FRAME, RATE)
    step = ll.build_layered_stepper(FRAME, RATE, offset=offset, scale=scale,
                                    c2v_dtype=c2v_dtype,
                                    layer_order=layer_order)
    ti, tp = (torch.from_numpy(a).to(dev)
              for a in llrs_to_qc(tab, llrs_nat))
    b = llrs_nat.shape[0]
    c2v = torch.zeros((tab.q, tab.degmax + 2, 360, b), device=dev)
    synd0 = ll.qc_syndrome_weight(FRAME, RATE, ti, tp).cpu().numpy()
    iters = np.full(b, max_iters + 1, np.int64)
    prev_clean = np.zeros(b, bool)
    snaps = {}
    t0 = time.time()
    it = 0
    for it in range(1, max_iters + 1):
        ti, tp, c2v = step(ti, tp, c2v)
        clean = (ll.qc_syndrome_weight(FRAME, RATE, ti, tp) == 0
                 ).cpu().numpy()
        iters[clean & ~prev_clean] = it
        prev_clean = clean
        if it in record_at:
            snaps[it] = (ti, tp)
        if clean.all() and not any(s > it for s in record_at):
            break
    log(f"  [{label}] {it} sweeps in {time.time() - t0:.1f}s")
    return iters, snaps, synd0


def batch_cost(iters, order, bsz=BATCH):
    """Sweeps per batch when codewords are batched (in `order`) `bsz` at
    a time and each batch pays its maximum."""
    it = iters[order]
    nb = len(it) // bsz
    return float(np.mean([it[i * bsz:(i + 1) * bsz].max()
                          for i in range(nb)]))


def demapped(snr: float, blocks: int, seed: int):
    """-> (plp, noisy cells (blocks, cpf) with the Q-delay undone, the
    noise variance, (blocks, N) natural-order LLRs)."""
    from ..rx import decode as rxdecode
    from ..tx import fec as txfec
    plp = PLPParams(constellation=Constellation.QAM256, rate=RATE,
                    fec_frame=FRAME, num_blocks_max=blocks,
                    time_il_length=1)   # rotated, like the bench
    rng = np.random.default_rng(seed)
    bb = rng.integers(0, 2, (blocks, plp.fec.k_bch)).astype(np.uint8)
    cells = txfec.plp_encode(plp, bb)
    pwr = float(np.mean(np.abs(cells) ** 2))
    nvar = pwr * 10 ** (-snr / 10.0)
    noisy = (cells + rng.normal(0, np.sqrt(nvar / 2), cells.shape)
             + 1j * rng.normal(0, np.sqrt(nvar / 2), cells.shape)
             ).astype(np.complex64)
    # undo the cyclic Q-delay (per codeword) before pairing I/Q for demap
    if plp.rotated:
        noisy = (noisy.real + 1j * np.roll(noisy.imag, -1, axis=-1)
                 ).astype(np.complex64)
    lls = []
    for i in range(0, blocks, 64):
        lv = rxdecode.llr_demap(plp, noisy[i:i + 64], nvar)
        lls.append(rxdecode.bits_from_llrs(plp, lv))
    return plp, noisy, nvar, np.concatenate(lls)


def _fails_line(itv, max_iters, rs, bsz):
    fl = int((itv > max_iters).sum())
    iv = np.minimum(itv, max_iters)
    cost = np.mean([batch_cost(iv, rs.permutation(len(iv)), bsz)
                    for _ in range(200)])
    return fl, iv, cost


def run(snr=19.0, blocks=512, max_iters=30, k1=(8, 10, 11), seed=0,
        study="schemes", device="cuda", bsz=BATCH, log=err) -> dict:
    """study: "schemes" (A and B), "variants" or "schedules".  -> the
    numbers printed, by line label."""
    dev = resolve(device, "twophase_study")
    tab = ll.qc_tables(FRAME, RATE)
    plp, noisy, nvar, llrs = demapped(snr, blocks, seed)
    rs = np.random.default_rng(1)
    res = {}
    if study == "schedules":
        q = tab.q
        llrs_q = to_bf16(llrs)
        orders = [
            ("natural", list(range(q))),
            ("reversed", list(range(q))[::-1]),
            ("evens-odds", list(range(0, q, 2)) + list(range(1, q, 2))),
            ("stride4", [t for r in range(4) for t in range(r, q, 4)]),
            ("rand7", list(np.random.default_rng(7).permutation(q))),
            ("rand13", list(np.random.default_rng(13).permutation(q))),
        ]
        for name, order in orders:
            itv, _, _ = decode_study(llrs_q, max_iters, (), dev,
                                     label=f"sched:{name}",
                                     c2v_dtype=torch.bfloat16,
                                     layer_order=order, log=log)
            fl, iv, cost = _fails_line(itv, max_iters, rs, bsz)
            res[name] = {"fails": fl, "mean": float(iv.mean()),
                         "max": int(iv.max()), "batch_cost": float(cost)}
            log(f"[S:{name:11s}] fails {fl}; mean {iv.mean():.2f} "
                f"max {iv.max()}; batch cost {cost:.2f} sweeps/frame")
        return res

    if study == "variants":
        llrs_q = to_bf16(llrs)
        bf = torch.bfloat16
        for name, off, sc, dt, lv in [
                ("f32 shipped  off0.5", 0.5, 1.0, None, llrs),
                ("bf16c2v      off0.5", 0.5, 1.0, bf, llrs_q),
                ("bf16c2v      off0.0", 0.0, 1.0, bf, llrs_q),
                ("bf16c2v sc0.875 off0", 0.0, 0.875, bf, llrs_q),
                ("bf16c2v sc0.75  off0", 0.0, 0.75, bf, llrs_q),
                ("bf16c2v sc0.875 off.25", 0.25, 0.875, bf, llrs_q),
                ("bf16c2v      off1.0", 1.0, 1.0, bf, llrs_q),
                ("bf16c2v llr/8 off.0625", 0.0625, 1.0, bf, llrs_q / 8.0),
        ]:
            itv, _, _ = decode_study(lv, max_iters, (), dev, label=name,
                                     offset=off, scale=sc, c2v_dtype=dt,
                                     log=log)
            fl, iv, cost = _fails_line(itv, max_iters, rs, bsz)
            res[name.strip()] = {"fails": fl, "mean": float(iv.mean()),
                                 "max": int(iv.max()),
                                 "batch_cost": float(cost)}
            log(f"[V:{name:22s}] fails {fl}; mean {iv.mean():.2f} "
                f"p90 {np.percentile(iv, 90):.0f} max {iv.max()}; "
                f"batch cost {cost:.2f} sweeps/frame")
        return res

    # ---- predictors available before any decoding ----
    pts = tables.constellation_points(plp.constellation)
    phi = tables.ROTATION_ANGLE[plp.constellation]
    evm = np.empty(blocks)
    for i in range(0, blocks, 64):
        dr = (noisy[i:i + 64] * np.exp(-1j * phi)).reshape(-1)
        d2 = np.abs(dr[:, None] - pts[None, :]) ** 2
        evm[i:i + 64] = d2.min(axis=1).reshape(min(64, blocks - i),
                                               -1).sum(axis=1)
    absl = np.abs(llrs)
    pred = {"evm_sum": evm,
            "neg_mean_absllr": -absl.mean(axis=1),
            "n_lowllr<2": (absl < 2.0).sum(axis=1).astype(np.float64),
            "n_lowllr<5": (absl < 5.0).sum(axis=1).astype(np.float64)}
    k1s = sorted(k1)
    iters, snaps, synd0 = decode_study(llrs, max_iters, k1s, dev,
                                       label="baseline", log=log)
    pred["synd0"] = synd0.astype(np.float64)
    fails = int((iters > max_iters).sum())
    it = np.minimum(iters, max_iters)
    log(f"{blocks} codewords @ {snr:g} dB, fails {fails}; per-codeword "
        f"iters: mean {it.mean():.2f} p50 {np.percentile(it, 50):.0f} "
        f"p90 {np.percentile(it, 90):.0f} p99 {np.percentile(it, 99):.0f} "
        f"max {it.max()}")
    rand_cost = np.mean([batch_cost(it, rs.permutation(len(it)), bsz)
                         for _ in range(200)])
    oracle = batch_cost(it, np.argsort(it, kind="stable"), bsz)
    res.update(fails=fails, mean=float(it.mean()), random_cost=rand_cost,
               oracle_cost=oracle)
    log(f"[today]   random-batch cost {rand_cost:.2f} sweeps/frame")
    log(f"[oracleB] true-iter-sorted  {oracle:.2f} sweeps/frame "
        f"({(rand_cost - oracle) / rand_cost:.1%} saving = scheme B upper "
        f"bound)")
    # ---- scheme B: predictor-sorted batching ----
    from scipy import stats as sstats
    for name, pv in pred.items():
        rho = sstats.spearmanr(pv, it).statistic
        cost = batch_cost(it, np.argsort(pv, kind="stable"), bsz)
        res[f"B:{name}"] = {"spearman": float(rho), "cost": cost}
        log(f"[B:{name:16s}] spearman {rho:+.3f} -> sorted cost "
            f"{cost:.2f} sweeps/frame ({(rand_cost - cost) / rand_cost:.1%}"
            f" saving)")
    # ---- scheme A: survivor compaction with restart ----
    for k in k1s:
        surv = iters > k
        ns = int(surv.sum())
        if ns == 0:
            log(f"[A:k1={k}] no survivors")
            continue
        ti_s, tp_s = (a.cpu().numpy() for a in snaps[k])
        q, g, kk = tab.q, tab.n_groups, tab.k
        ti_n = ti_s[:g].transpose(2, 0, 1).reshape(blocks, kk)
        tp_n = tp_s.transpose(2, 1, 0).reshape(blocks, 360 * q)
        post = np.concatenate([ti_n, tp_n], axis=1)[surv]
        it2, _, _ = decode_study(post, max_iters, (), dev,
                                 label=f"A:k1={k} restart {ns}cw", log=log)
        f2 = int((it2 > max_iters).sum())
        it2c = np.minimum(it2, max_iters)
        nb2 = max(1, int(np.ceil(ns / bsz)))
        it2p = np.concatenate([it2c, np.zeros(nb2 * bsz - ns, np.int64)])
        c2 = np.mean([batch_cost(it2p, rs.permutation(len(it2p)), bsz)
                      for _ in range(50)])
        total = k + nb2 * c2 * bsz / blocks
        res[f"A:k1={k}"] = {"survivors": ns, "fails": f2, "total": total}
        log(f"[A:k1={k}] survivors {ns}/{blocks} ({ns / blocks:.1%}); "
            f"phase-2 restart iters mean {it2c.mean():.2f} max "
            f"{it2c.max()} fails {f2}; total {total:.2f} sweeps/frame "
            f"({(rand_cost - total) / rand_cost:.1%} saving)")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--snr", type=float, default=19.0)
    ap.add_argument("--blocks", type=int, default=512)
    ap.add_argument("--max-iters", type=int, default=30)
    ap.add_argument("--k1", type=int, nargs="*", default=[8, 10, 11])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--variants", action="store_true",
                    help="min-sum variants under the kernels' bf16 message "
                         "precision instead of schemes A/B")
    ap.add_argument("--schedules", action="store_true",
                    help="layer orders instead of schemes A/B")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    study = ("variants" if args.variants else
             "schedules" if args.schedules else "schemes")
    run(args.snr, args.blocks, args.max_iters, args.k1, args.seed, study,
        args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
