#!/usr/bin/env python
"""Equivalence gate on the card: the f32-message layered kernel K4 against
the f32 layered reference `ops/ldpc_layered.build_layered_decoder` (the
port of JAX's XLA schedule), bit for bit.  After the JAX repository's
`tools/hbm_vmem_equivalence.py`, which needed the TPU because interpret
mode ignored the HBM kernel's aliasing; here K4 is a CUDA kernel that
exists only on the card.

Cases: SHORT C1/2 and NORMAL C2/3, B=128, 8 sweeps, at an SNR where every
codeword starts with raw bit errors.  Gates: raw errors present, the
reference's decode equal to the transmitted codewords, K4's hard bits
equal to the reference's.  K4's wrapper returns bits only (the kernel
keeps its totals on chip), so bits are what is compared; the VMEM-resident
K3 has no f32-message mode in the port (the TPU's f32 K3 fitted only the
SHORT codes), so the JAX tool's "vmem" column has no counterpart.

    python -m sdr_receiver_dvb_t2_tpu_torch.tools.hbm_vmem_equivalence

Exit 0 = equivalent; 1 with a report otherwise; 2 without a card.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from .._device import resolve
from ..dvbt2.params import CodeRate, FECFrame
from ..ops import ldpc_layered as ll
from ..ops.ldpc_tables import llrs_to_qc, qc_to_bits
from ..utils.benchgen import codewords

CASES = ((FECFrame.SHORT, CodeRate.C1_2, 128, 8),
         (FECFrame.NORMAL, CodeRate.C2_3, 128, 8))
SEED = 0xEC0DE


def run(cases=CASES, device="cuda",
        log=lambda m: print(m, file=sys.stderr)) -> list:
    """-> one record per case: {"case", "raw_errors", "corrected",
    "k4_equal", "differing_bits", "ok"}.  On the CPU K4 runs its plain
    version (the tests)."""
    dev = resolve(device, "hbm_vmem_equivalence")
    out = []
    for i, (frame, rate, batch, iters) in enumerate(cases):
        tab = ll.qc_tables(frame, rate)
        cw = codewords(frame, rate, batch, SEED + i)
        rng = np.random.default_rng(SEED + i)
        llr = (2.2 * (1 - 2.0 * cw)
               + rng.normal(0, 1.0, cw.shape)).astype(np.float32)
        raw_err = int(((llr < 0) != cw).sum())
        ti, tp = (torch.from_numpy(a).to(dev) for a in llrs_to_qc(tab, llr))
        rti, rtp = ll.build_layered_decoder(frame, rate, iters)(ti, tp)
        ref = qc_to_bits(tab, rti.cpu().numpy(), rtp.cpu().numpy())
        k4 = ll.make_decoder_nb(frame, rate, iters, batch, variant="hbm")
        got = k4(torch.from_numpy(np.ascontiguousarray(llr.T)).to(dev)
                 ).cpu().numpy().T
        ndiff = int((got != ref).sum())
        corrected = bool(np.array_equal(ref, cw))
        rec = {"case": f"{frame.name}/{rate.name} B={batch} iters={iters}",
               "raw_errors": raw_err, "corrected": corrected,
               "k4_equal": ndiff == 0, "differing_bits": ndiff}
        rec["ok"] = raw_err > 0 and corrected and ndiff == 0
        log(f"[{rec['case']}] K4 bits == f32 layered reference: "
            f"{ndiff == 0} ({ndiff} differing bits); raw bit errors "
            f"{raw_err}; decoded == transmitted: {corrected}")
        out.append(rec)
    return out


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("ERROR: this gate runs on the card (K4 is a CUDA kernel)",
              file=sys.stderr)
        return 2
    recs = run()
    bad = [r["case"] for r in recs if not r["ok"]]
    if bad:
        print(f"FAIL: {len(bad)} case(s) not equivalent: {bad}",
              file=sys.stderr)
        return 1
    print("OK: K4 bit-identical to the f32 layered reference on the card, "
          "every case corrected", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
