#!/usr/bin/env python
"""Stage timing of the fused receive path from frame bodies (the
`MultiFramePath.planes` entry: natural symbol order, GI in the body) on
the card.  After the JAX repository's `tools/path_microbench.py`.

Nested prefixes of the path over a data-dependent chain (CUDA events);
the difference between consecutive prefixes is the added stage's cost:

  fft    : GI strip + the f32 cuFFT head to carrier-major planes + the
           fftshift and active-carrier slice (`_to_carriers`)
  trans  : fft + the carrier-major planes made contiguous (the transpose
           the JAX tool times; the path makes no such copy, so the later
           prefixes read fft's planes in place and trans - fft is the
           copy alone)
  demod  : fft + per-class pilot equalize (`class_views`, `equalize` over
           `_eq_class_planar`) into the paired (total, 2F) layout
  cells  : + the PLP composed cell gather
  llrs   : demod + the LLR tail (`tails`: the gather, rotation, max-log
           LLRs, bit deinterleave; on the card K7, which gathers for
           itself, so the tail's cost is llrs - demod): the path's output,
           held equal to `MultiFramePath(bodies, inv_nvar)`

and beside them `mxu`: the same carriers through the matmul FFT (K6 stage
1, `ops/fft_stage1.Stage1`, then `mxu_fft.stage2_carrier_major`), bf16.

Usage: python -m sdr_receiver_dvb_t2_tpu_torch.tools.path_microbench [F]
[--reps 8]  (default F=8 at the headline mode)
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

STAGES = ("fft", "mxu", "trans", "demod", "cells", "llrs")
INV_NVAR = 1000.0


def prefix(mf: fusedpath.MultiFramePath, stage: str, stage1=None):
    """fn(body_r, body_i, inv_nvar) -> the output of the path up to
    `stage`, from the path's own stages."""
    p, f = mf.p, mf.n_frames

    def syms(b):
        return b.reshape(f, p.len_frame, p.symbol_size)[:, :, p.guard_size:]

    def run(body_r, body_i, inv_nvar):
        sr, si = syms(body_r), syms(body_i)
        if stage == "mxu":
            xkr, xki = mxu_fft.stage2_carrier_major(*stage1(sr, si),
                                                    p.fft_size)
            return mf.carriers(xkr, xki, ordered=False)[:2]
        xkr, xki = fusedpath.fft_carrier_major(sr, si, mf.llr_dtype)
        xr, xi, wrapped = mf.carriers(xkr, xki, ordered=False)
        if stage == "fft":
            return xr, xi
        if stage == "trans":
            return xr.contiguous(), xi.contiguous()
        both = mf.equalize(mf.class_views(xr, xi, ordered=False), wrapped)
        if stage == "demod":
            return both
        if stage == "cells":
            return both[mf._tails[0]._comp_cm.on(both.device)]
        return mf.tails(both, inv_nvar)[0][0]

    return run


def run(p, plp, num_blocks: int, f: int, reps: int = 8, device="cuda",
        log=print) -> dict:
    """Every prefix on seeded bodies (normal, sigma 0.3).  -> {stage: ms
    per F-frame step, "llrs_equal_path": bool}."""
    if p.fft_size not in mxu_fft._FACTORS:
        raise ValueError(f"no matmul FFT for n={p.fft_size}")
    dev = resolve(device, "path_microbench")
    mf = fusedpath.MultiFramePath(p, plp, num_blocks, f)
    gen = torch.Generator(device=dev).manual_seed(0)
    shape = (f, p.len_frame * p.symbol_size)
    body_r = 0.3 * torch.randn(shape, generator=gen, device=dev)
    body_i = 0.3 * torch.randn(shape, generator=gen, device=dev)
    stage1 = fft_stage1.Stage1(p.fft_size)
    got = prefix(mf, "llrs")(body_r, body_i, INV_NVAR)
    ndiff = differing(got, mf(torch.stack([body_r, body_i], -1), INV_NVAR))
    out = {"llrs_equal_path": ndiff == 0, "llrs_differing": ndiff}
    del got
    for stage in STAGES:
        fn = prefix(mf, stage, stage1)

        def step(st, fn=fn):
            br, bi = st
            br[0, :1] += probe(fn(br, bi, INV_NVAR)) * 1e-20
            return br, bi
        ms, _ = chain_ms(step, (body_r, body_i), reps, dev)
        out[stage] = ms
        log(f"[path] {stage:5s} {ms:9.3f} ms per {f}-frame step "
            f"({ms / f:.4f} ms/frame)")
    return out


def main(argv=None) -> int:
    from ..utils.benchgen import headline_mode
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("frames", nargs="?", type=int, default=8)
    ap.add_argument("--reps", type=int, default=8)
    args = ap.parse_args(argv)
    p, plp = headline_mode(128)
    out = run(p, plp, 128, args.frames, args.reps)
    print(json.dumps(out))
    return 0 if out["llrs_equal_path"] else 1


if __name__ == "__main__":
    sys.exit(main())
