"""BER validation: the layered decoders (10 sweeps; f32 totals, bf16 c2v,
natural and reversed layer order) against the 25-iteration flooding
decoder near the code's threshold.

Port of the repository's `tools/ber_validation.py`, with the same data
(one `default_rng(0)` sequence: B random codewords, BPSK, then AWGN at
each sigma in turn) and the same decoders:

  layered10_f32       `make_decoder_natural` (K3, or K4 where
                      `vmem_fit_bytes` says so)
  flood25_bf16        the flooding decoder, 25 iterations, bf16
  layered10_bf16      the JAX tool's `make_decoder_nb(dtype=bf16)`: K3,
                      which is also `make_core`'s choice for
                      layered10_f32 at NORMAL C2/3, B=128 (and SHORT
                      C2/3, B=8), so the column is the same decoder, run
                      once
  layered10_bf16_rev  `make_adaptive_decoder_nb_fused_io`, reversed
                      layers, checked once after 10 sweeps (K1)

It is evidence that the fast layered schedule, the reduced precision and
the production's reversed layer order cost no BER at the operating point.

`--profile` prints instead the device time of the sharded step's decoder
(`parallel/sharding.py`: f32 flooding, 4 iterations, F=8 frames of 128
codewords at NORMAL C2/3) on the card, in all and by operator.

    python -m sdr_receiver_dvb_t2_tpu_torch.tools.ber_validation \\
        [--device cuda|cpu] [--profile]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .._device import resolve
from ..dvbt2 import ldpc as L
from ..dvbt2.params import CodeRate, FECFrame
from ..ops import ldpc as fldpc
from ..ops import ldpc_layered as qldpc

SIGMAS = (0.74, 0.78, 0.82, 0.88)   # around the C2/3 BPSK threshold
BATCH = 128
ITERS = 10
PROFILE_BATCH = 8 * BATCH       # the sharded step's codewords at F=8
PROFILE_ITERS = 4               # and its flooding iterations


def ber_inputs(frame: FECFrame, rate: CodeRate, batch: int, sigmas):
    """-> (codewords (B, N) uint8, [LLRs (B, N) f32 for each sigma])."""
    code = L.get_code(frame, rate)
    rng = np.random.default_rng(0)
    info = rng.integers(0, 2, (batch, code.k)).astype(np.uint8)
    cw = L.encode(code, info)
    tx = (1.0 - 2.0 * cw).astype(np.float32)
    llrs = [(2.0 / sigma ** 2) * (tx + sigma * rng.normal(
        0, 1.0, (batch, code.n))).astype(np.float32) for sigma in sigmas]
    return cw, llrs


def decoders(frame: FECFrame, rate: CodeRate, batch: int) -> dict:
    """{name: fn(llrs (B, N) tensor) -> bits (B, N) uint8 tensor}."""
    natural = qldpc.make_decoder_natural(frame, rate, ITERS, batch)
    flood = fldpc.make_decoder(frame, rate, iters=25, dtype=torch.bfloat16)
    nb_rev = qldpc.make_adaptive_decoder_nb_fused_io(
        frame, rate, max_iters=ITERS, check_every=ITERS, batch=batch,
        dtype=torch.bfloat16, layer_order="reversed")
    return {
        "layered10_f32": natural,
        "flood25_bf16": flood,
        "layered10_bf16": natural,
        "layered10_bf16_rev": lambda llr: nb_rev(llr.T)[0].T,
    }


def ber_table(frame: FECFrame, rate: CodeRate, batch: int, sigmas,
              device) -> list[dict]:
    """-> one row per sigma: {"sigma": s, name: bit error rate, ...}; a
    decoder that stands in two columns runs once."""
    cw, llrs = ber_inputs(frame, rate, batch, sigmas)
    decs = decoders(frame, rate, batch)
    rows = []
    for sigma, llr in zip(sigmas, llrs):
        x = torch.from_numpy(llr).to(device)
        row, ber = {"sigma": sigma}, {}
        for name, dec in decs.items():
            if dec not in ber:
                ber[dec] = float((dec(x).cpu().numpy() != cw).mean())
            row[name] = ber[dec]
        rows.append(row)
    return rows


def flood_profile(frame: FECFrame, rate: CodeRate, batch: int, iters: int):
    """The f32 flooding decoder on the card at (batch, N), on random LLRs
    (fixed iterations: its work does not depend on the data).  -> (ms per
    call by CUDA events over 3 calls after a warm-up, [(operator, device
    ms, calls)] of one call by torch.profiler, largest first)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from .fft_microbench import cuda_ms

    dec = fldpc.make_decoder(frame, rate, iters=iters, dtype=torch.float32)
    llrs = torch.randn((batch, L.get_code(frame, rate).n), device="cuda")
    ms = cuda_ms(lambda: dec(llrs), reps=3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        dec(llrs)
        torch.cuda.synchronize()
    ops = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CPU
                  and e.self_device_time_total > 0), key=lambda o: -o[1])
    return ms, ops


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--profile", action="store_true",
                    help="time the sharded step's flooding decoder on the "
                         "card instead")
    args = ap.parse_args(argv)
    if args.profile:
        args.device = "cuda"
    resolve(args.device, "ber_validation", cli=True)
    if args.profile:
        ms, ops = flood_profile(FECFrame.NORMAL, CodeRate.C2_3,
                                PROFILE_BATCH, PROFILE_ITERS)
        print(f"f32 flooding decoder, NORMAL C2/3, ({PROFILE_BATCH}, "
              f"64800), {PROFILE_ITERS} iterations: {ms:.2f} ms per call; "
              f"by operator (one call, {sum(o[1] for o in ops):.2f} ms): "
              + "; ".join(f"{k} {t:.2f} ms x{n}" for k, t, n in ops[:8]),
              flush=True)
        return 0
    for row in ber_table(FECFrame.NORMAL, CodeRate.C2_3, BATCH,
                         SIGMAS, args.device):
        print(f"sigma={row['sigma']}: " + "  ".join(
            f"{k}={v:.2e}" for k, v in row.items() if k != "sigma"),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
