"""The layered LDPC kernels on every DVB-T2 code, and what one layer costs.

Run on a machine with an NVIDIA GPU:
`python -m sdr_receiver_dvb_t2_tpu_torch.tools.ldpc_layer_bench`.

Two parts, both also called by `chip_smoke.py`:

- `check_all_codes`: the CUDA kernel body against its plain PyTorch
  version, tolerance 0 on bits and sweep counts, on all 13 codes at a small
  batch: 3 fixed sweeps in natural order (K3's door, and K4's), the
  adaptive exit in reversed order at a noise level where the batch needs
  several sweeps (K2's door), and one explicit non-monotone permutation of
  the layers at SHORT C1/2 (row degrees 2..5, 8 layers in which an info
  group repeats) and NORMAL C5/6 (degree 20, the most shared memory), and
  the adaptive exit at B=160 on two SHORT codes, where the batch exceeds
  what the card holds at once and every chunk is a launch of its own.
  Between them the cases run every kernel compiled for one row degree
  and every layer body of the mixed-degree kernel.
- `layer_times`: per-sweep slope and fixed part of a decode from fixed
  sweep counts (CUDA events), at the main path's batch and at a batch of 8
  codewords, where 8 CTAs have the card to themselves: that slope over q is
  the latency of one layer's gather, scan, barrier and write-back, the
  dependency-chain floor of a one-CTA-per-codeword layered schedule.

`main` also prints `layer_profile`: the cycles one warp spends in the
barrier-delimited parts of a layer, read from a -DLDPC_PROFILE build.
"""
from __future__ import annotations

import numpy as np
import torch

from ..dvbt2.ldpc import _TABLE_KEY
from ..dvbt2.params import CodeRate, FECFrame
from ..ops import ldpc_layered as ll
from ..utils import benchgen
from .fft_microbench import cuda_ms

# Approximate decoding thresholds of the codes on a +-1 channel with noise
# deviation sigma, as 20 log10(1 / sigma) in dB (the DVB-S2 QPSK Es/N0
# figures of the same LDPC codes; the SHORT codes' true rates are lower).
THRESHOLD_DB = {"C1_4": -2.35, "C1_2": 1.0, "C3_5": 2.23, "C2_3": 3.1,
                "C3_4": 4.03, "C4_5": 4.68, "C5_6": 5.18}
MARGIN_DB = 0.9       # above the threshold: several sweeps, then converged
CHECK_BATCH = 8
PERMUTED = ((FECFrame.SHORT, CodeRate.C1_2), (FECFrame.NORMAL, CodeRate.C5_6))
# more codewords than an H100 has SMs: the adaptive exit cannot keep the
# batch resident and takes one launch per chunk
LARGE_BATCH = 160
LARGE = ((FECFrame.SHORT, CodeRate.C1_2), (FECFrame.SHORT, CodeRate.C2_3))
# `layer_times`: batches (the main path's, and one that leaves every CTA an
# SM and the memory system to itself), fixed sweep counts, channel noise and
# timed calls per point
BATCHES = (128, CHECK_BATCH)
SWEEPS = (1, 5, 13)
SIGMA = 0.65
REPS = 10


def all_codes() -> list:
    return sorted(_TABLE_KEY, key=lambda c: (c[0].name, c[1].name))


def sigma_for(rate: CodeRate) -> float:
    return 10.0 ** (-(THRESHOLD_DB[rate.name] + MARGIN_DB) / 20.0)


def channel_llrs(cw: np.ndarray, sigma: float, rng, dtype,
                 device="cuda") -> torch.Tensor:
    """(B, n) codewords -> (n, B) LLRs of the +-1 channel on `device`.
    sigma 0 is the clean channel, scaled as at sigma 0.5."""
    y = 1.0 - 2.0 * cw
    if sigma > 0:
        y = y + rng.normal(0.0, sigma, cw.shape)
    llr = 2.0 * y / (sigma or 0.5) ** 2
    return torch.from_numpy(np.ascontiguousarray(llr.T, np.float32)).to(
        device, dtype)


def permuted_order(q: int) -> list:
    """An explicit layer order that is neither ascending nor descending:
    the even layers upwards, then the odd ones downwards.  It contains
    every kind of neighbour: t then t+2, t then t-2, the turn from the last
    even to the last odd layer, and a first layer (0) that follows layer 1
    across the sweep boundary."""
    order = list(range(0, q, 2)) + list(range(1, q, 2))[::-1]
    assert sorted(order) == list(range(q))
    return order


def cases(frame: FECFrame, rate: CodeRate) -> list:
    """The checks one code gets -> [(label, door, layer order, batch)].
    Door "vmem" (K3) or "hbm" (K4): 3 fixed sweeps in natural order; door
    "adaptive" (K2): the adaptive exit in the given order."""
    out = [(f"3 sweeps natural ({door})", door, None, CHECK_BATCH)
           for door in ("vmem", "hbm")]
    out.append(("adaptive reversed", "adaptive", "reversed", CHECK_BATCH))
    if (frame, rate) in PERMUTED:
        out.append(("adaptive permuted", "adaptive",
                    permuted_order(ll.qc_tables(frame, rate).q), CHECK_BATCH))
    if (frame, rate) in LARGE:
        out.append((f"adaptive reversed at B={LARGE_BATCH} (a launch per "
                    "chunk)", "adaptive", "reversed", LARGE_BATCH))
    return out


def _same(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.int() - b.int()).abs().max())


def check_all_codes(log=print) -> list:
    """Every case of every code (see `cases` and the module docstring) on
    the card.  Raises on the first disagreement; -> one record per case."""
    records = []
    for idx, (frame, rate) in enumerate(all_codes()):
        tab = ll.qc_tables(frame, rate)
        rng = np.random.default_rng(200 + idx)
        kernel = f"degree {ll.uniform_degree(tab) or 'mixed'}"
        sent, llrs = {}, {}
        for label, door, order, batch in cases(frame, rate):
            if batch not in llrs:
                seed = (100 if batch == CHECK_BATCH else 300) + idx
                sent[batch] = benchgen.codewords(frame, rate, batch,
                                                 seed=seed)
                llrs[batch] = channel_llrs(sent[batch], sigma_for(rate), rng,
                                           torch.float32)
            v = llrs[batch]
            rec = {"case": label, "code": f"{frame.name} {rate.name}",
                   "kernel": kernel}
            if door == "adaptive":
                dec = ll.make_adaptive_decoder_nb_fused(
                    frame, rate, max_iters=24, check_every=2,
                    layer_order=order)
                kb, kit = dec.kernel(v, 0)
                pb, pit = dec.plain(v, 0)
                ok_cw = int((kb.cpu().numpy().T == sent[batch]).all(axis=1)
                            .sum())
                rec.update(
                    max_abs_err=max(_same(kb, pb), abs(int(kit) - int(pit))),
                    sweeps=int(kit), decoded=f"{ok_cw}/{batch}")
                if int(pit) < 3:
                    raise RuntimeError(
                        f"{label} at {rec['code']}: the batch converged in "
                        f"{int(pit)} sweeps; the case does not exercise "
                        "stored messages")
            else:
                dec = ll.make_decoder_nb(frame, rate, iters=3, batch=batch,
                                         variant=door)
                rec["max_abs_err"] = _same(dec.kernel(v), dec.plain(v))
            records.append(rec)
            log(f"[all codes] {rec['code']} B={batch} {label}: max |diff| "
                f"{rec['max_abs_err']} (tolerance 0)"
                + "".join(f", {k} {rec[k]}"
                          for k in ("sweeps", "decoded", "kernel")
                          if k in rec))
            if rec["max_abs_err"] != 0:
                raise RuntimeError(f"{label} at {rec['code']}: the kernel "
                                   "disagrees with its plain version")
    return records


def line_fit(points) -> tuple[float, float]:
    """Least-squares (slope, intercept) of [(x, y), ...]."""
    x = np.array([p[0] for p in points], dtype=np.float64)
    y = np.array([p[1] for p in points], dtype=np.float64)
    slope, fixed = np.polyfit(x, y, 1)
    return float(slope), float(fixed)


def layer_times(frame: FECFrame, rate: CodeRate, variant: str) -> list:
    """Fixed-exit decodes (K3's door, or K4's with variant "hbm") at each
    batch of BATCHES and sweep count of SWEEPS -> [{batch, ms by sweeps,
    ms_per_sweep, fixed_ms, us_per_layer}]."""
    tab = ll.qc_tables(frame, rate)
    out = []
    for b in BATCHES:
        cw = benchgen.codewords(frame, rate, b, seed=31)
        v = channel_llrs(cw, SIGMA, np.random.default_rng(32), torch.float32)
        pts = []
        for n in SWEEPS:
            dec = ll.make_decoder_nb(frame, rate, iters=n, batch=b,
                                     variant=variant)
            pts.append((n, cuda_ms(lambda: dec.kernel(v), REPS)))
        slope, fixed = line_fit(pts)
        out.append({"batch": b, "ms": dict(pts), "ms_per_sweep": slope,
                    "fixed_ms": fixed, "us_per_layer": 1e3 * slope / tab.q})
    return out


def layer_times_line(frame, rate, variant: str, r: dict) -> str:
    """One record of `layer_times` as a line of text."""
    ms = ", ".join(f"{n} sweeps {t:.4f} ms" for n, t in r["ms"].items())
    return (f"[layer times] {frame.name} {rate.name} {variant} "
            f"B={r['batch']}: {ms}; {r['ms_per_sweep']:.4f} ms per sweep + "
            f"{r['fixed_ms']:.4f} ms fixed; {r['us_per_layer']:.3f} us per "
            f"layer")


def layer_profile(frame: FECFrame, rate: CodeRate, variant: str) -> dict:
    """Where one layer's time goes, from the kernel's own clock: a build
    with -DLDPC_PROFILE in which thread 0 of CTA 0 sums the cycles it
    spends in the four barrier-delimited parts of every layer, over the
    most sweeps of SWEEPS at the main path's batch.
    -> mean cycles per layer by part, and the layers counted."""
    import ctypes

    from .. import _build
    batch, sweeps = BATCHES[0], SWEEPS[-1]
    cw = benchgen.codewords(frame, rate, batch, seed=31)
    v = channel_llrs(cw, sigma_for(rate), np.random.default_rng(32),
                     torch.float32)
    dec = ll.make_decoder_nb(frame, rate, iters=sweeps, batch=batch,
                             variant=variant)
    with _build.variant("ldpc_layered", "-DLDPC_PROFILE"):
        lib = _build.load("ldpc_layered")
        lib.ldpc_layered_profile.argtypes = [ctypes.c_void_p]
        out = (ctypes.c_ulonglong * 5)()
        lib.ldpc_layered_profile(out)            # clear
        dec.kernel(v)
        torch.cuda.synchronize()
        lib.ldpc_layered_profile(out)
    n = max(int(out[4]), 1)
    parts = ("gather, scan, stores", "barrier 1", "write-back", "barrier 2")
    return {"layers": int(out[4]),
            **{p: out[i] / n for i, p in enumerate(parts)}}


def ptxas_by_kernel(build_log: str) -> list:
    """nvcc's `-Xptxas -v` report as one line per function: its template
    arguments (input or c2v type, ARGMIN, row degree), registers and
    spills."""
    import re
    import shutil
    import subprocess
    rows, sym = {}, None
    for ln in build_log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )([^'\s]+)", ln)
        if m:
            sym = m.group(1)
        elif sym and ("registers" in ln or "spill" in ln):
            rows.setdefault(sym, []).append(
                ln.replace("ptxas info    :", "").strip())
    names = list(rows)
    if names and shutil.which("c++filt"):
        names = subprocess.run(["c++filt", *names], capture_output=True,
                               text=True, check=True).stdout.splitlines()
    short = [re.sub(r"^void |\(anonymous namespace\)::|_INTERNAL_\w+::", "",
                    name).split("(")[0] for name in names]
    return [f"{name}: " + "; ".join(rows[sym])
            for name, sym in zip(short, rows)]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this tool measures on the card")
    import subprocess
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    from .. import _build
    _build.load("ldpc_layered")
    for line in ptxas_by_kernel(_build.build_log("ldpc_layered")):
        print(f"[build] {line}", flush=True)
    check_all_codes()
    for frame, rate, variant in ((FECFrame.NORMAL, CodeRate.C2_3, "vmem"),
                                 (FECFrame.NORMAL, CodeRate.C3_5, "hbm"),
                                 (FECFrame.NORMAL, CodeRate.C5_6, "vmem"),
                                 (FECFrame.SHORT, CodeRate.C1_2, "vmem")):
        for r in layer_times(frame, rate, variant):
            print(layer_times_line(frame, rate, variant, r), flush=True)
        prof = layer_profile(frame, rate, variant)
        print(f"[layer profile] {frame.name} {rate.name} {variant} "
              f"B={BATCHES[0]}, "
              f"cycles of CTA 0's first warp per layer over "
              f"{prof.pop('layers')} layers: "
              + ", ".join(f"{k} {c:.0f}" for k, c in prof.items()),
              flush=True)


if __name__ == "__main__":
    main()
