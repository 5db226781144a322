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
                  (`ops/fft_stage1.py`), then `mxu_fft.stage2_carrier_major`
  stage 1 alone   K6, its plain version, and the same function through
                  torch.matmul in bf16 (the library yardstick)

Also: `check_factors` (K6 against its plain version at every n and at
ragged symbol counts), `profile_route` (a route's device events by
torch.profiler) and `k6_profile` (where K6's time goes, from the kernel's
own clock); `--profile` runs both, on the K6 route and the bf16 matmul FFT.

Usage: python -m sdr_receiver_dvb_t2_tpu_torch.tools.fft_microbench [F]
[--profile]  (default F=32; needs a CUDA device).
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


def routes(stage) -> dict:
    """{route: (fn(a, b) on (F, S, N) planes -> carrier-major planes, input
    dtype)} of the FFT head; "copy" returns its input's copy."""
    def cufft(a, b):
        z = torch.fft.fft(torch.complex(a, b), dim=-1)
        return (z.real.to(torch.bfloat16).permute(2, 1, 0).contiguous(),
                z.imag.to(torch.bfloat16).permute(2, 1, 0).contiguous())

    def k6_full(a, b):
        return mxu_fft.stage2_carrier_major(*stage.kernel(a, b), N)

    f32, bf16 = torch.float32, torch.bfloat16
    return {
        "copy f32 (roofline)": (lambda a, b: (a.clone(), b.clone()), f32),
        "cufft f32 + bf16 cast + transpose": (cufft, f32),
        "matmul fft bf16": (lambda a, b: mxu_fft.fft_carrier_major_planar(
            a, b, N, dtype=bf16), bf16),
        "matmul fft f32": (lambda a, b: mxu_fft.fft_carrier_major_planar(
            a, b, N, dtype=f32), f32),
        "k6 stage 1 + stage 2": (k6_full, bf16),
    }


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
    variants = {name: (fn, (xr16, xi16) if dt == torch.bfloat16
                       else (xr, xi), not name.startswith("copy"))
                for name, (fn, dt) in routes(stage).items()}
    out = {}
    for name, (fn, args, checked) in variants.items():
        ms = cuda_ms(lambda: fn(*args), REPS)
        err = None
        if checked:
            o_r, o_i = fn(args[0][:1, :4], args[1][:1, :4])
            err = _rel_err(o_r, o_i, ref)
        out[name] = {"ms": ms, "rel_err": err}
    # stage 1 alone: the kernel, its plain version, the library route
    yr, yi = stage._input(xr16, xi16)
    tabs, packed = stage.tables(dev), stage.packed(dev)
    out["stage 1: k6 kernel"] = {
        "ms": cuda_ms(lambda: fft_stage1.fft_stage1_cuda(yr, yi, *packed),
                      REPS), "rel_err": None}
    out["stage 1: plain (f32 matmul)"] = {
        "ms": cuda_ms(lambda: fft_stage1.stage1_plain(yr, yi, *tabs), 2),
        "rel_err": None}
    out["stage 1: torch.matmul bf16"] = {
        "ms": cuda_ms(lambda: stage1_matmul_bf16(yr, yi, *tabs), REPS),
        "rel_err": None}
    return out


def check_factors(log=print) -> list:
    """K6 against its plain version on the card within
    `fft_stage1.compare`, at every n of `mxu_fft._FACTORS`: 2 frames of 3
    symbols, and 139 symbols, a count that leaves the persistent grid's
    last round ragged (the grid has at most 132 CTAs); plus 7 symbols at
    n = 32768, fewer than the grid.  Raises on a disagreement.
    -> one record per case."""
    cases = [(n, shape) for n in sorted(mxu_fft._FACTORS)
             for shape in ((2, 3), (1, 139))] + [(N, (1, 7))]
    records = []
    for n, (f, s) in cases:
        gen = torch.Generator(device="cuda").manual_seed(n + s)
        xr = torch.randn((f, s, n), generator=gen, device="cuda")
        xi = torch.randn((f, s, n), generator=gen, device="cuda")
        stage = fft_stage1.Stage1(n)
        got, ref = stage.kernel(xr, xi), stage.plain(xr, xi)
        torch.cuda.synchronize()
        res = [fft_stage1.compare(g, r) for g, r in zip(got, ref)]
        rec = {"n": n, "symbols": f * s,
               "max_abs_err": max(r["max_abs_err"] for r in res),
               "frac_differ": max(r["frac_differ"] for r in res),
               "n_beyond": sum(r["n_beyond"] for r in res),
               "ok": all(r["ok"] for r in res),
               **fft_stage1.plan(stage.n1, stage.n2, f * s)}
        log(f"[K6 factors] n={n} ({stage.n1} x {stage.n2}), {f * s} "
            f"symbols: max |diff| {rec['max_abs_err']:.4g}, "
            f"{100 * rec['frac_differ']:.4f}% differ, {rec['n_beyond']} "
            f"beyond the tolerance; launch {rec['ctas']} CTAs x "
            f"{rec['warpgroups']} warpgroups, tile {rec['tile']}, "
            f"{rec['stages']} stages, {rec['smem']} B shared")
        if not rec["ok"]:
            raise RuntimeError(f"K6 disagrees with its plain version at "
                               f"n={n}, {f * s} symbols")
        records.append(rec)
    return records


def profile_route(f: int, name: str, log=print) -> list:
    """torch.profiler over one call of route `name` (of `routes`) at (f,
    60, 32768) after a warm-up.  Prints the 12 longest and returns all
    device events (kernels and copies) by self device time:
    [(name, calls, ms)]."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn, dt = routes(fft_stage1.Stage1(N))[name]
    gen = torch.Generator(device="cuda").manual_seed(1)
    xr = torch.randn((f, S, N), generator=gen, device="cuda").to(dt)
    xi = torch.randn((f, S, N), generator=gen, device="cuda").to(dt)
    fn(xr, xi)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn(xr, xi)
        torch.cuda.synchronize()
    events = sorted(((e.key, e.count, e.self_device_time_total / 1e3)
                     for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda r: -r[2])
    log(f"[profile {name}] F={f}: device time "
        f"{sum(r[2] for r in events):.3f} ms in {len(events)} kinds of "
        f"device events")
    for key, calls, ms in events[:12]:
        log(f"  {ms:9.3f} ms  x{calls:<3d} {key[:110]}")
    return events


K6_PARTS = ("W1^T bands' load", "ring waits", "products (rest of the loop)",
            "epilogue")


def k6_profile(f: int, log=print) -> dict:
    """Where K6's time goes at (f, 60, 32768): the -DK6_PROFILE build, in
    which thread 0 of every consumer warpgroup sums the cycles of the
    parts of `K6_PARTS` (`g_prof` in csrc/fft_stage1.cu).  Its output is
    held to the plain version within `compare`, and its time to the
    regular build's.  -> {"ms", "ms_profiled", "items", part: share of the
    consumers' cycles, ...}."""
    import ctypes

    from .. import _build
    gen = torch.Generator(device="cuda").manual_seed(2)
    xr = torch.randn((f, S, N), generator=gen, device="cuda")
    xi = torch.randn((f, S, N), generator=gen, device="cuda")
    stage = fft_stage1.Stage1(N)
    yr, yi = stage._input(xr, xi)
    packed = stage.packed("cuda")
    ms = cuda_ms(lambda: fft_stage1.fft_stage1_cuda(yr, yi, *packed), REPS)
    with _build.variant("fft_stage1", "-DK6_PROFILE"):
        lib = _build.load("fft_stage1")
        lib.fft_stage1_profile.argtypes = [ctypes.c_void_p]
        out = (ctypes.c_ulonglong * 6)()
        ms_prof = cuda_ms(
            lambda: fft_stage1.fft_stage1_cuda(yr, yi, *packed), REPS)
        lib.fft_stage1_profile(out)                   # clear
        got = fft_stage1.fft_stage1_cuda(yr, yi, *packed)
        err = lib.fft_stage1_profile(out)
    if err != 0:
        raise RuntimeError(f"fft_stage1_profile: CUDA error {err}")
    ref = stage.plain(xr, xi)
    if not all(fft_stage1.compare(g, r)["ok"] for g, r in zip(got, ref)):
        raise RuntimeError("the -DK6_PROFILE build of K6 is wrong")
    total = max(int(out[4]), 1)
    rec = {"ms": ms, "ms_profiled": ms_prof, "items": int(out[5]),
           **{part: out[i] / total for i, part in enumerate(K6_PARTS)}}
    log(f"[K6 profile] F={f}: {ms:.3f} ms ({ms_prof:.3f} ms profiled), "
        f"{rec['items']} warpgroup items; share of the consumers' cycles: "
        + ", ".join(f"{part} {100 * rec[part]:.1f}%" for part in K6_PARTS))
    return rec


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("no CUDA device: this tool measures the FFT on the card")
        return 1
    flags = {a for a in argv if a.startswith("--")}
    args = [a for a in argv if not a.startswith("--")]
    f = int(args[0]) if args else 32
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
    if "--profile" in flags:
        for name in ("k6 stage 1 + stage 2", "matmul fft bf16"):
            profile_route(f, name)
        k6_profile(f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
