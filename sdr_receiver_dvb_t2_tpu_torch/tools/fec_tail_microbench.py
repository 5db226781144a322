#!/usr/bin/env python
"""FEC-tail timing on the card: F decodes and their BCH check, byte pack
and hash, per frame against frame groups.  After the JAX repository's
`tools/fec_tail_microbench.py`.

Per F-frame step over a data-dependent chain (CUDA events):

  decode         F decodes by K2 (`ops/ldpc_layered.
                 make_adaptive_decoder_nb_fused`: f32 LLRs, bf16 c2v, exit
                 checked every 2 sweeps, 24 at most; JAX's dtype=bf16 is
                 its c2v precision)
  tail_perframe  + per frame: the GF(2) BCH check
                 (`ops/fec_device.make_bch_check_nb`), the descramble and
                 byte pack (`make_bb_bytes_nb`) and a 64-bit byte hash
  tail_batched   + the same over groups of G frames, bits stacked (G*B)
                 columns wide: one product, one pack, one hash per group

The codewords are BCH- and LDPC-encoded random frames, so every one must
pass the BCH check, and the per-frame and grouped hashes must agree.

Usage: python -m sdr_receiver_dvb_t2_tpu_torch.tools.fec_tail_microbench
[--frames 96] [--group 8] [--batch 128] [--sigma 0.5] [--reps 4]
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from .._device import resolve
from ..dvbt2 import bch, ldpc as ldpcmod
from ..dvbt2.params import CodeRate, FECFrame, fec_params
from ..ops import fec_device
from ..ops import ldpc_layered as ll
from .timing import chain_ms

VARIANTS = ("decode", "tail_perframe", "tail_batched")


def bch_codewords(frame: FECFrame, rate: CodeRate, b: int, rng):
    """(b, n) random BB frames, BCH- then LDPC-encoded."""
    fec = fec_params(frame, rate)
    bb = rng.integers(0, 2, (b, fec.k_bch)).astype(np.uint8)
    return ldpcmod.encode(ldpcmod.get_code(frame, rate),
                          bch.encode(frame, bb, fec.t_bch))


def steps(frame, rate, f: int, group: int, batch: int, wb: torch.Tensor):
    """{variant: fn(lf (F, n, B) f32) -> (acc () int64, sweeps () int32,
    BCH-clean codewords () int64)}."""
    n_bch = fec_params(frame, rate).n_bch
    decode = ll.make_adaptive_decoder_nb_fused(frame, rate, max_iters=24,
                                               check_every=2, batch=batch)
    bch_check = fec_device.make_bch_check_nb(frame, rate)
    bb_pack = fec_device.make_bb_bytes_nb(frame, rate)

    def tail(bits):
        ok = bch_check(bits[:n_bch])
        h = (bb_pack(bits)[None].long() * wb[:, :, None]).sum((1, 2))
        return h[0] + h[1], ok.sum()

    def run(lf, grouped=None):
        acc = torch.zeros((), dtype=torch.int64, device=lf.device)
        good = torch.zeros_like(acc)
        it_tot = torch.zeros((), dtype=torch.int32, device=lf.device)
        grp = []
        for fi in range(f):
            bits, it = decode(lf[fi])
            it_tot = it_tot + it
            if grouped is None:
                acc = acc + bits[:8, :8].long().sum()
                continue
            grp.append(bits)
            if len(grp) == grouped or fi == f - 1:
                h, ok = tail(torch.cat(grp, 1))
                acc, good = acc + h, good + ok
                grp = []
        return acc, it_tot, good

    return {"decode": run,
            "tail_perframe": lambda lf: run(lf, 1),
            "tail_batched": lambda lf: run(lf, group)}


def run(frame=FECFrame.NORMAL, rate=CodeRate.C2_3, frames: int = 96,
        group: int = 8, batch: int = 128, sigma: float = 0.5, reps: int = 4,
        device="cuda", log=print) -> dict:
    """-> {variant: {"ms_per_frame", "sweeps_per_frame"}, "bch_clean":
    {variant: clean codewords of the F*B}, "hash_equal": bool}."""
    dev = resolve(device, "fec_tail_microbench")
    rng = np.random.default_rng(1)
    cw = bch_codewords(frame, rate, batch, rng)
    kb8 = fec_params(frame, rate).k_bch // 8
    llr = (2.2 * (1 - 2.0 * cw)
           + rng.normal(0, sigma, cw.shape)).astype(np.float32)
    lf0 = np.broadcast_to(llr.T[None], (frames,) + llr.T.shape).copy()
    lf0 += rng.normal(0, 1e-3, lf0.shape).astype(np.float32)
    wb = torch.from_numpy(rng.integers(-2**31, 2**31, (2, kb8),
                                       dtype=np.int64)).to(dev)
    lf0 = torch.from_numpy(lf0).to(dev)
    out, acc_of, clean = {}, {}, {}
    for name, fn in steps(frame, rate, frames, group, batch, wb).items():
        acc, it, good = fn(lf0)
        acc_of[name], clean[name] = int(acc), int(good)

        def step(lf, fn=fn):
            a, _, _ = fn(lf)
            lf[0, 0, :1] += a.float() * 1e-30      # the chain's dependence
            return lf
        ms, _ = chain_ms(step, lf0.clone(), reps, dev)
        out[name] = {"ms_per_frame": ms / frames,
                     "sweeps_per_frame": int(it) / frames}
        log(f"[fec tail] {name:13s} {ms / frames:.4f} ms/frame "
            f"({int(it) / frames:.1f} sweeps/frame)")
    out["bch_clean"] = {k: clean[k] for k in VARIANTS[1:]}
    out["hash_equal"] = acc_of["tail_perframe"] == acc_of["tail_batched"]
    out["codewords"] = frames * batch
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=96)
    ap.add_argument("--group", type=int, default=8)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--sigma", type=float, default=0.5,
                    help="LLR noise; 0.5 ~ the clean bench's sweeps")
    ap.add_argument("--reps", type=int, default=4)
    args = ap.parse_args(argv)
    out = run(frames=args.frames, group=args.group, batch=args.batch,
              sigma=args.sigma, reps=args.reps)
    print(json.dumps(out))
    ok = out["hash_equal"] and all(
        v == out["codewords"] for v in out["bch_clean"].values())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
