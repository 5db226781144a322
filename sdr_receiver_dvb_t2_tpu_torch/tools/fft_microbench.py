#!/usr/bin/env python
"""FFT stage microbench on the card at (F frames, 60 symbols, 32K): what
does the receive path's FFT head cost, by which route?  After the JAX
repository's `tools/fft_microbench.py`.

Variants, each timed with CUDA events on the same seeded input and each
held against an f64 FFT of that input:

  copy            a device copy of the f32 planes (the memory roofline)
  cufft           torch.fft.fft in f32, then the bf16 cast and the
                  carrier-major transpose: what `rx/fusedpath.py` does today
  matmul bf16     `mxu_fft.fft_carrier_major_planar(dtype=bfloat16)`
  matmul f32      the same at f32
  k6 + stage 2    stage 1 and the twiddle through the CUDA kernel K6
                  (`ops/fft_stage1.py`), then the stage-2 einsum
  stage 1 alone   K6, its plain version, and the same function through
                  torch.matmul in bf16 (the library yardstick)

Usage: python -m sdr_receiver_dvb_t2_tpu_torch.tools.fft_microbench [F]
(default F=32; needs a CUDA device).
"""
from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch

from ..ops import fft_stage1, mxu_fft

S, N = 60, 32768
REPS = 5       # timed calls per variant (2 for the slow plain version)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of `fn` over `reps` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def stage1_matmul_bf16(yr, yi, w1r_t, w1i_t, twr, twi):
    """Stage 1 and the twiddle with library calls only: four bf16
    torch.matmul products (f32 accumulation, bf16 stored, so a_r and a_i
    round to bf16 before the twiddle, which K6 avoids), then the twiddle."""
    ar = torch.matmul(w1r_t, yr) - torch.matmul(w1i_t, yi)
    ai = torch.matmul(w1r_t, yi) + torch.matmul(w1i_t, yr)
    return ar * twr - ai * twi, ar * twi + ai * twr


def _rel_err(out_r, out_i, ref) -> float:
    """RMS error of a carrier-major (n, S', F') result against the f64
    spectrum, relative to the spectrum's RMS."""
    got = out_r.double().cpu().numpy() + 1j * out_i.double().cpu().numpy()
    return float(np.sqrt(np.mean(np.abs(got - ref) ** 2)
                         / np.mean(np.abs(ref) ** 2)))


def run(f: int) -> dict:
    """All variants at (f, 60, 32768) on the current CUDA device.
    -> {variant: {"ms": per call, "rel_err": vs the f64 FFT}}."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    xr_h = rng.normal(size=(f, S, N)).astype(np.float32)
    xi_h = rng.normal(size=(f, S, N)).astype(np.float32)
    xr, xi = torch.from_numpy(xr_h).to(dev), torch.from_numpy(xi_h).to(dev)
    xr16, xi16 = xr.bfloat16(), xi.bfloat16()
    # the f64 reference on the first frame's first 4 symbols, carrier-major
    ref = np.fft.fft(xr_h[:1, :4].astype(np.float64)
                     + 1j * xi_h[:1, :4].astype(np.float64), axis=-1)
    ref = np.ascontiguousarray(ref.transpose(2, 1, 0))       # (n, 4, 1)
    stage = fft_stage1.Stage1(N)

    def cufft(a, b):
        z = torch.fft.fft(torch.complex(a, b), dim=-1)
        return (z.real.to(torch.bfloat16).permute(2, 1, 0).contiguous(),
                z.imag.to(torch.bfloat16).permute(2, 1, 0).contiguous())

    def k6_full(a, b):
        return mxu_fft.stage2_carrier_major(*stage.kernel(a, b), N)

    variants = {
        "copy f32 (roofline)": (lambda a, b: (a.clone(), b.clone()), None),
        "cufft f32 + bf16 cast + transpose": (cufft, (xr, xi)),
        "matmul fft bf16": (lambda a, b: mxu_fft.fft_carrier_major_planar(
            a, b, N, dtype=torch.bfloat16), (xr16, xi16)),
        "matmul fft f32": (lambda a, b: mxu_fft.fft_carrier_major_planar(
            a, b, N, dtype=torch.float32), (xr, xi)),
        "k6 stage 1 + stage-2 einsum": (k6_full, (xr16, xi16)),
    }
    out = {}
    for name, (fn, small) in variants.items():
        args = (xr, xi) if small is None else small
        ms = cuda_ms(lambda: fn(*args), REPS)
        err = None
        if small is not None:
            o_r, o_i = fn(args[0][:1, :4], args[1][:1, :4])
            err = _rel_err(o_r, o_i, ref)
        out[name] = {"ms": ms, "rel_err": err}
    # stage 1 alone: the kernel, its plain version, the library route
    yr, yi = stage._input(xr16, xi16)
    tabs = stage.tables(dev)
    out["stage 1: k6 kernel"] = {
        "ms": cuda_ms(lambda: fft_stage1.fft_stage1_cuda(yr, yi, *tabs),
                      REPS), "rel_err": None}
    out["stage 1: plain (f32 matmul)"] = {
        "ms": cuda_ms(lambda: fft_stage1.stage1_plain(yr, yi, *tabs), 2),
        "rel_err": None}
    out["stage 1: torch.matmul bf16"] = {
        "ms": cuda_ms(lambda: stage1_matmul_bf16(yr, yi, *tabs), REPS),
        "rel_err": None}
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("no CUDA device: this tool measures the FFT on the card")
        return 1
    f = int(argv[0]) if argv else 32
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(f"FFT microbench at ({f}, {S}, {N}); ms per {f}-frame call, "
          f"relative RMS error against an f64 FFT")
    gb = 2 * f * S * N * 4 / 1e9
    for name, r in run(f).items():
        err = "" if r["rel_err"] is None else f"  err {r['rel_err']:.2e}"
        extra = (f"  ({2e3 * gb / r['ms']:.0f} GB/s read+write)"
                 if name.startswith("copy") else "")
        print(f"  {name:36s} {r['ms']:9.3f} ms  "
              f"{r['ms'] / f:7.4f} ms/frame{err}{extra}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
