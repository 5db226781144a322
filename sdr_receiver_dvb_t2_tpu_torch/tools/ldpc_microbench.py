#!/usr/bin/env python
"""The fixed-sweep layered decoders K3 ("vmem": bf16 c2v) and K4 ("hbm":
f32 c2v) against each other on the card: ms per decode over a
data-dependent chain (CUDA events), us per layer step, coded Mbit/s, and
the hard decisions against the transmitted codewords.  After the JAX
repository's `tools/ldpc_microbench.py`; the per-layer and per-code
measurements of the kernel body are `tools/ldpc_layer_bench.py`'s.

Usage: python -m sdr_receiver_dvb_t2_tpu_torch.tools.ldpc_microbench
[vmem|hbm ...] [--iters 10] [--batch 128] [--reps 8]
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from .._device import resolve
from ..dvbt2.params import CodeRate, FECFrame
from ..ops import ldpc_layered as ll
from ..utils.benchgen import codewords
from .timing import chain_ms

VARIANTS = ("vmem", "hbm")


def run(variants=VARIANTS, frame=FECFrame.NORMAL, rate=CodeRate.C2_3,
        iters: int = 10, batch: int = 128, reps: int = 8, device="cuda",
        log=print) -> dict:
    """-> {variant: {"ms", "us_per_layer_step", "mbit_s",
    "decode_exact"}} on LLRs 6(1-2c) + N(0, 1)."""
    dev = resolve(device, "ldpc_microbench")
    tab = ll.qc_tables(frame, rate)
    cw = codewords(frame, rate, batch, 0)
    rng = np.random.default_rng(0)
    llr = (6.0 * (1 - 2.0 * cw)
           + rng.normal(0, 1.0, cw.shape)).astype(np.float32)
    v0 = torch.from_numpy(np.ascontiguousarray(llr.T)).to(dev)
    out = {}
    for variant in variants:
        dec = ll.make_decoder_nb(frame, rate, iters, batch, variant=variant)
        exact = bool(np.array_equal(dec(v0).cpu().numpy().T, cw))

        def step(v, dec=dec):
            # the next input depends on this decode's bits
            return v0 + dec(v).float() * 1e-12
        ms, _ = chain_ms(step, v0, reps, dev)
        out[variant] = {"ms": ms,
                        "us_per_layer_step": 1e3 * ms / (iters * tab.q),
                        "mbit_s": batch * tab.n / ms / 1e3,
                        "decode_exact": exact}
        log(f"[ldpc {variant}] {ms:.3f} ms/decode  "
            f"{out[variant]['us_per_layer_step']:.3f} us/layer-step  "
            f"{out[variant]['mbit_s']:.0f} Mbit/s coded  "
            f"decode-exact={exact}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", default=list(VARIANTS))
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--reps", type=int, default=8)
    args = ap.parse_args(argv)
    out = run(args.variants, iters=args.iters, batch=args.batch,
              reps=args.reps)
    print(json.dumps(out))
    return 0 if all(v["decode_exact"] for v in out.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
