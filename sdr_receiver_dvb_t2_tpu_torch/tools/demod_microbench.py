#!/usr/bin/env python
"""The per-class equalizer's cost drilled into (the `demod` stage of
`tools/path_microbench.py`), on the card at the headline mode.  After the
JAX repository's `tools/demod_microbench.py`.

Progressively larger sub-pipelines over every symbol class of
`rx/fusedpath.FusedFrameDemod`, on (k_total, S, F) f32 carrier planes,
each timed over a data-dependent chain (CUDA events):

  slice : the strided class slices, made contiguous
  pilot : + pilot rows times 1/ref (`fusedpath.class_pilot_est`)
  interp: + the linear-interpolation stencil on every carrier -> channel
  div   : + the one-tap equalizer as a complex division (torch complex)
  rdiv  : the division replaced by the conjugate product and one real
          reciprocal (the planar form the path uses)
  comp  : + the composed data-row gather (the full demod stage)

Usage: python -m sdr_receiver_dvb_t2_tpu_torch.tools.demod_microbench [F]
[--reps 8]  (default F=32)
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from .._device import resolve
from ..rx import fusedpath
from .timing import chain_ms, probe

MODES = ("slice", "pilot", "interp", "div", "rdiv", "comp")


class _Stencil:
    """A class's full-carrier interpolation stencil on one device."""

    def __init__(self, c, dev):
        il, ir, w = c.stencil
        self.il = torch.as_tensor(il, dtype=torch.int64, device=dev)
        self.ir = torch.as_tensor(ir, dtype=torch.int64, device=dev)
        self.w = torch.as_tensor(w, dtype=torch.float32,
                                 device=dev).reshape(-1, 1)
        self.comp = torch.as_tensor(c.comp_rows, dtype=torch.int64,
                                    device=dev)


def classes_fn(consts, stencils, xr, xi, mode: str) -> list:
    """The sub-pipeline `mode` over every class -> its outputs."""
    outs = []
    for cc, st in zip(consts, stencils):
        c = cc.c
        sl = slice(c.start, c.start + c.step * (c.count - 1) + 1, c.step)
        xcr = xr[:, sl].reshape(xr.shape[0], -1).contiguous()
        xci = xi[:, sl].reshape(xi.shape[0], -1).contiguous()
        if mode == "slice":
            outs.append(xcr)
            continue
        epr, epi = fusedpath.class_pilot_est(cc, xcr, xci)
        if mode == "pilot":
            outs.append(epr)
            continue
        chr_ = epr[st.il] * (1.0 - st.w) + epr[st.ir] * st.w
        chi_ = epi[st.il] * (1.0 - st.w) + epi[st.ir] * st.w
        if mode == "interp":
            outs.append(chr_)
            continue
        if mode == "div":
            outs.append(torch.complex(xcr, xci) / torch.complex(chr_, chi_))
            continue
        inv = 1.0 / (chr_ * chr_ + chi_ * chi_)
        eqr = (xcr * chr_ + xci * chi_) * inv
        eqi = (xci * chr_ - xcr * chi_) * inv
        if mode == "rdiv":
            outs.append(eqr)
            continue
        outs.append(torch.cat([eqr[st.comp], eqi[st.comp]]))
    return outs


def run(p, f: int, reps: int = 8, device="cuda", log=print) -> dict:
    """-> {mode: ms per F-frame step} on seeded carrier planes; "div_rdiv
    _max_rel": the two equalizer forms' largest difference relative to
    the cells' peak, over the cells both give finite (they must agree;
    a random input can make a channel estimate of 0)."""
    dev = resolve(device, "demod_microbench")
    demod = fusedpath.get_fused_demod(p)
    consts = demod.consts(f)
    stencils = [_Stencil(cc.c, dev) for cc in consts]
    gen = torch.Generator(device=dev).manual_seed(0)
    shape = (p.k_total, p.len_frame, f)
    xr = torch.randn(shape, generator=gen, device=dev)
    xi = torch.randn(shape, generator=gen, device=dev)
    # checked before the timed chains touch the input
    rel = []
    for d, r in zip(classes_fn(consts, stencils, xr, xi, "div"),
                    classes_fn(consts, stencils, xr, xi, "rdiv")):
        ok = d.real.isfinite() & r.isfinite()
        rel.append(float((d.real - r)[ok].abs().max()
                         / d.real[ok].abs().max()))
    out = {"div_rdiv_max_rel": max(rel)}
    for mode in MODES:
        def step(st, mode=mode):
            a, b = st
            a[0, 0, :1] += probe(classes_fn(consts, stencils, a, b,
                                            mode)) * 1e-20
            return a, b
        ms, _ = chain_ms(step, (xr, xi), reps, dev)
        out[mode] = ms
        log(f"[demod] {mode:6s} {ms:9.3f} ms per {f}-frame step "
            f"({ms / f:.4f} ms/frame)")
    return out


def main(argv=None) -> int:
    from ..utils.benchgen import headline_mode
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("frames", nargs="?", type=int, default=32)
    ap.add_argument("--reps", type=int, default=8)
    args = ap.parse_args(argv)
    p, _ = headline_mode(128)
    print(json.dumps(run(p, args.frames, args.reps)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
