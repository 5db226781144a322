#!/usr/bin/env python
"""Stage split of the production demod + LLR path (`rx/fusedpath.
MultiFramePath`, the class-ordered symbol entry the bench runs) at bench
scale on the card: F=128 frames at the headline mode (32K, PP7 extended,
256QAM C2/3 NORMAL, 128 blocks, bf16).  After the JAX repository's
`tools/demod_split_microbench.py`.

Times nested prefixes of the path over a data-dependent chain (CUDA
events); consecutive differences give each stage's cost:

  fft    : the FFT head to carrier-major (n, S, F) planes
  carr   : + the fftshift and active-carrier slice (`carriers`): no
           work on the SISO comp-first route the bench runs, whose row
           tables carry the fftshift (its eq gathers straight from the
           head's output); a `_to_carriers` copy on the MISO route
  slices : + the per-class symbol views (`class_views`)
  eq     : + pilot estimate, smoother, interpolation, one-tap EQ, paired
           (total, 2F) layout (`equalize`, over `_eq_class_comp`)
  gather : + the PLP composed cell gather (the tail's `_comp_cm`)
  llr    : eq + the LLR tail (`tails`: the gather, rotation, max-log
           LLRs, bit deinterleave; on the card one launch of K7, which
           gathers for itself, so the tail's cost is llr - eq): the path's
           output, held equal to `MultiFramePath.syms`

Two FFT heads: "cufft" (`fusedpath.fft_carrier_major`, the receive path's
own) and "k6" (the matmul FFT: stage 1 by the K6 kernel,
`ops/fft_stage1.Stage1`, then `mxu_fft.stage2_carrier_major`).

Usage: python -m sdr_receiver_dvb_t2_tpu_torch.tools.demod_split_microbench
[F] [--reps 4]
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from .._device import resolve
from ..ops import fft_stage1, mxu_fft
from ..rx import fusedpath
from .timing import chain_ms, differing, probe

STAGES = ("fft", "carr", "slices", "eq", "gather", "llr")
HEADS = ("cufft", "k6")
INV_NVAR = 100.0


def head_fn(name: str, n: int, dtype):
    """fn(sym_r, sym_i) -> (n, S, F) planar spectra of the named head."""
    if name == "cufft":
        return lambda sr, si: fusedpath.fft_carrier_major(sr, si, dtype)
    if name == "k6":
        stage = fft_stage1.Stage1(n)
        return lambda sr, si: mxu_fft.stage2_carrier_major(*stage(sr, si), n)
    raise ValueError(f"head {name!r} is not one of {HEADS}")


def prefix(mf: fusedpath.MultiFramePath, head, stage: str):
    """fn(sym_r, sym_i, inv_nvar) -> the output of the path up to `stage`,
    built from the path's own stages on its class-ordered route (the one
    `MultiFramePath.syms` takes)."""
    if stage not in STAGES:
        raise ValueError(f"stage {stage!r} is not one of {STAGES}")

    def run(sym_r, sym_i, inv_nvar):
        xkr, xki = head(sym_r, sym_i)
        if stage == "fft":
            return xkr, xki
        xr, xi, wrapped = mf.carriers(xkr, xki, ordered=True)
        if stage == "carr":
            return xr, xi
        xs = mf.class_views(xr, xi, ordered=True)
        if stage == "slices":
            return xs
        both = mf.equalize(xs, wrapped)
        if stage == "eq":
            return both
        if stage == "gather":
            return both[mf._tails[0]._comp_cm.on(both.device)]
        return mf.tails(both, inv_nvar)[0][0]

    return run


def run(p, plp, num_blocks: int, f: int, reps: int = 4, device="cuda",
        log=print) -> dict:
    """Every prefix of every head on seeded (F, len_frame, fft) f32 symbol
    planes in class order.  -> {head: {stage: ms per F-frame step}}, with
    "llr_equals_path": whether the cuFFT head's llr prefix equals
    `MultiFramePath.syms` on the same input, bit for bit (checked before
    the timed chains touch the input)."""
    dev = resolve(device, "demod_split_microbench")
    mf = fusedpath.MultiFramePath(p, plp, num_blocks, f,
                                  llr_dtype=torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(0)
    shape = (f, p.len_frame, p.fft_size)
    sym_r = torch.randn(shape, generator=gen, device=dev)
    sym_i = torch.randn(shape, generator=gen, device=dev)
    got = prefix(mf, head_fn("cufft", p.fft_size, torch.bfloat16), "llr")(
        sym_r, sym_i, INV_NVAR)
    ndiff = differing(got, mf.syms(sym_r, sym_i, INV_NVAR))
    out = {"llr_equals_path": ndiff == 0, "llr_differing": ndiff,
           "llr_nan": int(got.isnan().sum())}
    del got
    for name in HEADS:
        head = head_fn(name, p.fft_size, torch.bfloat16)
        out[name] = {}
        for stage in STAGES:
            fn = prefix(mf, head, stage)

            def step(st, fn=fn):
                sr, si = st
                sd = probe(fn(sr, si, INV_NVAR))
                sr[0, 0, :1] += sd * 1e-20       # the chain's dependence
                return sr, si
            ms, _ = chain_ms(step, (sym_r, sym_i), reps, dev)
            out[name][stage] = ms
            log(f"[demod split {name}] {stage:6s} {ms:9.3f} ms per "
                f"{f}-frame step ({ms / f:.4f} ms/frame)")
    return out


def deltas(split: dict) -> dict:
    """{stage: ms} of one head -> each stage's own cost (the difference
    of consecutive prefixes)."""
    prev, d = 0.0, {}
    for s in STAGES:
        d[s] = split[s] - prev
        prev = split[s]
    return d


def main(argv=None) -> int:
    from ..utils.benchgen import headline_mode
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("frames", nargs="?", type=int, default=128)
    ap.add_argument("--reps", type=int, default=4)
    args = ap.parse_args(argv)
    p, plp = headline_mode(128)
    out = run(p, plp, 128, args.frames, args.reps)
    for h in HEADS:
        print(f"[demod split {h}] per stage, ms/frame: " + "  ".join(
            f"{s} {v / args.frames:.4f}" for s, v in deltas(out[h]).items()))
    print(json.dumps(out))
    return 0 if out["llr_equals_path"] else 1


if __name__ == "__main__":
    sys.exit(main())
