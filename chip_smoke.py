#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments: `python3 chip_smoke.py`.
It builds the port's CUDA kernels from `sdr_receiver_dvb_t2_tpu_torch/csrc`
and drives the port's two main paths at the headline mode: 32K FFT,
GI 1/128, PP7 extended carriers, 59 data symbols, 256QAM C2/3 NORMAL FEC,
B=128 codewords per frame.

Phases (each prints its lines; any failure raises and exits non-zero):
  1. the card's name and power limit; build the kernels.
  2. each layered LDPC kernel against its plain PyTorch version on
     synthetic codewords, tolerance 0 on bits and sweep counts, both timed
     with CUDA events:
       K1 (bf16 LLRs, adaptive, check every sweep) and K2 (f32 LLRs,
       adaptive, check every 2 sweeps), NORMAL C2/3, B=128, reversed
       layers, 24 sweeps max: clean, sigma 0.65, sigma 0.74, and sigma
       0.65 with a floor of 8;
       K3 (fixed, bf16 c2v) at NORMAL C2/3 and K4 (fixed, f32 c2v) at
       NORMAL C3/5, B=128, natural order, each reached through
       `make_decoder_nb`'s automatic choice: 12 sweeps at sigma 0.65, and
       6 sweeps beyond the code's threshold (sigma 0.74 at C2/3, 0.82 at
       C3/5), where some codewords must stay undecoded.
  3. the superstep: F frames modulated on the host (T2Modulator), impaired
     on the card (CFO +1.2 kHz, SCO +22 ppm, DC, IQ imbalance, int16 ADC),
     tracking state estimated by T2Receiver.refine_acquire on a 2-frame
     capture, then the superstep at clean and at 20 dB.  Gates: every
     codeword BCH-clean, per-frame hashes equal to the host expectation,
     the TS reassembled from all frames bit-exact, K1 launched.
  4. the receiver: `DeviceT2Receiver(device="cuda")` on a host-modulated
     capture of the headline mode: `receive()` at CFO +1.2 kHz and 20 dB
     (K2), `receive()` with adaptive=False on the clean capture (K3), the
     same at NORMAL C3/5 (K4), and the streaming batched path through
     `io.devices.StreamingReceiver` at 30 dB.  Gates: every frame decoded,
     no TS errors, the TS a bit-exact prefix of the transmitted one, the
     route's kernel launched, at least one batched superstep, and no jax
     module loaded.
The second-to-last line is a JSON record of the kernels; the last line is
{"ok": true, "device": {...}}.
"""
import argparse
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

NUM_BLOCKS = 128
PALLAS = "sdr_receiver_dvb_t2_tpu/ops/ldpc_pallas.py"
SOURCE = "sdr_receiver_dvb_t2_tpu_torch/csrc/ldpc_layered.cu"
# the noise cases of the adaptive kernels: (label, sigma, traced floor)
NOISE_CASES = (("clean", 0.0, 0), ("sigma 0.65", 0.65, 0),
               ("sigma 0.74", 0.74, 0), ("sigma 0.65 floor 8", 0.65, 8))


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps):
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


def kernel_wrappers():
    """{name: the launch-counting wrapper} of K1-K4."""
    from sdr_receiver_dvb_t2_tpu_torch.ops import ldpc_layered as ll
    return {"K1": ll.ldpc_layered_cuda, "K2": ll.ldpc_layered_adaptive_cuda,
            "K3": ll.ldpc_layered_vmem_cuda, "K4": ll.ldpc_layered_hbm_cuda}


def phase_build():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    from sdr_receiver_dvb_t2_tpu_torch import _build
    t0 = time.time()
    _build.load("ldpc_layered")
    regs = [ln.strip() for ln in _build.build_log("ldpc_layered").splitlines()
            if "registers" in ln]
    log(f"[build] ldpc_layered.cu in {time.time() - t0:.2f} s; ptxas: "
        + " | ".join(regs))


def _llrs(cw, sigma, rng, dtype):
    """(B, n) codewords -> (n, B) channel LLRs on the card in `dtype`."""
    y = 1.0 - 2.0 * cw
    if sigma > 0:
        y = y + rng.normal(0.0, sigma, cw.shape)
    llr = 2.0 * y / max(sigma, 0.5) ** 2
    return torch.from_numpy(np.ascontiguousarray(llr.T, np.float32)).to(
        "cuda", dtype)


def _diff(a, b):
    return int((a.int() - b.int()).abs().max())


def phase_adaptive(tag, dec, code, dtype, seed):
    """An adaptive kernel (K1 or K2) against its plain version on the
    noise cases; tolerance 0 (bits and sweep counts are integers).
    -> (worst |diff|, (kernel ms, plain ms) at sigma 0.65)."""
    from sdr_receiver_dvb_t2_tpu_torch.utils import benchgen
    cw = benchgen.codewords(*code, NUM_BLOCKS, seed=seed)
    rng = np.random.default_rng(seed)
    worst, timed = 0, None
    for label, sigma, floor in NOISE_CASES:
        v = _llrs(cw, sigma, rng, dtype)
        kb, kit = dec.kernel(v, floor)
        pb, pit = dec.plain(v, floor)
        torch.cuda.synchronize()
        err = max(_diff(kb, pb), abs(int(kit) - int(pit)))
        worst = max(worst, err)
        ok_cw = int((kb.cpu().numpy().T == cw).all(axis=1).sum())
        k_ms = cuda_ms(lambda: dec.kernel(v, floor), 5)
        p_ms = cuda_ms(lambda: dec.plain(v, floor), 1)
        log(f"[{tag} vs plain] {code[0].name} {code[1].name} B={NUM_BLOCKS} "
            f"{label}: sweeps kernel {int(kit)} plain {int(pit)}, max |diff| "
            f"{err} (tolerance 0), {ok_cw}/{NUM_BLOCKS} codewords decoded; "
            f"kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms")
        if err != 0:
            raise RuntimeError(f"{tag} disagrees with its plain version "
                               f"({label})")
        if label == "sigma 0.65":
            timed = (k_ms, p_ms)
    return worst, timed


def phase_fixed(tag, rate, variant, sigma_hard, seed):
    """A fixed-iteration kernel (K3 or K4) through `make_decoder_nb`'s
    automatic choice against its plain version, tolerance 0 on bits: 12
    sweeps at sigma 0.65 (timed), and 6 sweeps at `sigma_hard`, beyond the
    code's threshold, where codewords must stay undecoded (bits that have
    not settled on the transmitted word show any numerical difference).
    -> (worst |diff|, (kernel ms, plain ms) at sigma 0.65)."""
    from sdr_receiver_dvb_t2_tpu.dvbt2.params import FECFrame
    from sdr_receiver_dvb_t2_tpu_torch.ops import ldpc_layered
    from sdr_receiver_dvb_t2_tpu_torch.utils import benchgen
    cw = benchgen.codewords(FECFrame.NORMAL, rate, NUM_BLOCKS, seed=seed)
    rng = np.random.default_rng(seed)
    worst, timed = 0, None
    for sigma, sweeps in ((0.65, 12), (sigma_hard, 6)):
        dec = ldpc_layered.make_decoder_nb(FECFrame.NORMAL, rate,
                                           iters=sweeps, batch=NUM_BLOCKS)
        if dec.core.variant != variant:
            raise RuntimeError(f"make_decoder_nb chose {dec.core.variant} "
                               f"at NORMAL {rate.name}, expected {variant}")
        v = _llrs(cw, sigma, rng, torch.float32)
        kb, pb = dec.kernel(v), dec.plain(v)
        torch.cuda.synchronize()
        err = _diff(kb, pb)
        worst = max(worst, err)
        wrong = kb.cpu().numpy().T != cw
        ok_cw = int((~wrong).all(axis=1).sum())
        line = (f"[{tag} vs plain] NORMAL {rate.name} B={NUM_BLOCKS} sigma "
                f"{sigma}, auto choice {variant!r} (c2v "
                f"{dec.core.c2v_dtype}), {sweeps} sweeps: max |diff| {err} "
                f"(tolerance 0), {ok_cw}/{NUM_BLOCKS} codewords decoded, "
                f"{int(wrong.sum())} bits off the transmitted words")
        if sweeps == 12:
            timed = (cuda_ms(lambda: dec.kernel(v), 5),
                     cuda_ms(lambda: dec.plain(v), 1))
            line += f"; kernel {timed[0]:.3f} ms, plain {timed[1]:.3f} ms"
        log(line)
        if err != 0:
            raise RuntimeError(f"{tag} disagrees with its plain version "
                               f"(sigma {sigma})")
        if sigma == sigma_hard and ok_cw == NUM_BLOCKS:
            raise RuntimeError(f"{tag}: every codeword decoded at sigma "
                               f"{sigma}; the check does not discriminate")
    return worst, timed


def phase_kernels():
    from sdr_receiver_dvb_t2_tpu.dvbt2.params import CodeRate
    from sdr_receiver_dvb_t2_tpu_torch.ops import ldpc_layered as ll
    from sdr_receiver_dvb_t2_tpu_torch.utils import benchgen
    _, plp = benchgen.headline_mode(NUM_BLOCKS)
    code = (plp.fec_frame, plp.rate)
    return {
        "K1": phase_adaptive("K1", ll.make_adaptive_decoder_nb_fused_io(
            *code, max_iters=24, check_every=1, batch=NUM_BLOCKS,
            layer_order="reversed"), code, torch.bfloat16, 5),
        "K2": phase_adaptive("K2", ll.make_adaptive_decoder_nb_fused(
            *code, max_iters=24, check_every=2, batch=NUM_BLOCKS,
            layer_order="reversed"), code, torch.float32, 6),
        "K3": phase_fixed("K3", CodeRate.C2_3, "vmem", 0.74, 7),
        "K4": phase_fixed("K4", CodeRate.C3_5, "hbm", 0.82, 8),
    }


def phase_slice(n_frames):
    from sdr_receiver_dvb_t2_tpu_torch.ops import ldpc_layered
    from sdr_receiver_dvb_t2_tpu_torch.rx import superstep as ss_mod
    from sdr_receiver_dvb_t2_tpu_torch.utils import benchgen as bg

    t0 = time.time()
    p, plp = bg.headline_mode(NUM_BLOCKS)
    ts, frames, rows = bg.modulate(p, plp, n_frames)
    log(f"[slice] modulated {n_frames} frames x {p.frame_samples} samples "
        f"on the host in {time.time() - t0:.1f} s")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)

    t0 = time.time()
    track, (cfo, ratio, pos0) = bg.estimate_tracking(frames, 10 ** -2.0, gen,
                                                     "cuda")
    log(f"[slice] acquisition at 20 dB in {time.time() - t0:.1f} s: cfo "
        f"{cfo:+.2f} Hz (err {cfo - bg.CFO_HZ:+.3f}), sco "
        f"{(ratio - 1) * 1e6:+.3f} ppm (err {(ratio - 1 - bg.SCO) * 1e6:+.3f}"
        f"), frame start {pos0:.2f} "
        f"(err {pos0 - ss_mod.HALF * (1 + bg.SCO):+.2f})")

    weights = ss_mod.hash_weights(plp.fec.k_bch // 8, NUM_BLOCKS)
    expect = np.stack([ss_mod.expected_hash(rows[f], weights)
                       for f in range(n_frames)])
    step = ss_mod.Superstep(p, plp, NUM_BLOCKS, n_frames, bg.FS, weights)
    points = (("clean", 0.0, 10 ** 3.3), ("20 dB", 10 ** -2.0, 100.0))
    raws = {lab: bg.impaired(frames, nv, gen, "cuda")
            for lab, nv, _ in points}
    keep = tuple(range(n_frames))

    counts = _zero_counts()
    results = {lab: step(*raws[lab], inv, track, keep=keep)
               for lab, _, inv in points}
    torch.cuda.synchronize()
    launches = _read_counts(counts)
    if launches["K1"] == 0:
        raise RuntimeError("the superstep never launched K1")

    for lab, _, inv in points:
        sums, oks, iters, byts = (r.cpu().numpy() for r in results[lab])
        got = bg.reassemble_ts(byts)
        ts_ok = (len(got) >= (n_frames - 1) * len(ts) // n_frames
                 and np.array_equal(got, ts[:len(got)]))
        hash_ok = bool((sums == expect).all())
        bch_ok = bool((oks == NUM_BLOCKS).all())
        dt = cuda_ms(lambda: step(*raws[lab], inv, track), 3)
        log(f"[slice {lab}] BCH clean {oks.min()}..{oks.max()}/{NUM_BLOCKS}"
            f"; hashes {'ok' if hash_ok else 'FAIL'} x{n_frames}; TS "
            f"bit-exact={ts_ok} ({len(got)} of {len(ts)} bytes); LDPC "
            f"{float(iters) / n_frames:.2f} sweeps/frame; superstep "
            f"{dt:.2f} ms = {dt / n_frames:.3f} ms/frame")
        if not (bch_ok and hash_ok and ts_ok):
            raise RuntimeError(f"slice gate failed at {lab}")

    # the kernel on the main path's own LLRs (frame 0, 20 dB)
    (sr, si), _, _ = step.frontend(*raws["20 dB"], track[0], track[1],
                                   track[2], track[3])
    llr0 = step.mf.syms(sr, si, 100.0)[:, :, 0].contiguous()
    kb, kit = step.decode.kernel(llr0, 8)
    pb, pit = step.decode.plain(llr0, 8)
    err = max(_diff(kb, pb), abs(int(kit) - int(pit)))
    log(f"[slice] K1 on frame-0 LLRs at 20 dB: sweeps kernel {int(kit)} "
        f"plain {int(pit)}, max |diff| {err} (tolerance 0)")
    if err != 0:
        raise RuntimeError("K1 disagrees with its plain version on the "
                           "main path's LLRs")
    return launches, err


def _zero_counts():
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    return wrappers


def _read_counts(wrappers):
    return {k: fn.launches for k, fn in wrappers.items()}


def _timed_decodes(rx):
    """Wrap rx._decode_frame to record each per-frame decode's wall time
    (it ends in a host read-back, so the device work is inside)."""
    spent = []
    inner = rx._decode_frame

    def wrapped(*a, **kw):
        t0 = time.perf_counter()
        ok = inner(*a, **kw)
        spent.append(time.perf_counter() - t0)
        return ok
    rx._decode_frame = wrapped
    return spent


def _ts_gate(label, ts_got, ts_ref, frames, n_frames, ts_errors):
    exact = len(ts_got) > 0 and np.array_equal(ts_got, ts_ref[:len(ts_got)])
    log(f"[receiver {label}] frames decoded {frames}/{n_frames}, TS errors "
        f"{ts_errors}, TS bit-exact={exact} ({len(ts_got)} of {len(ts_ref)} "
        f"bytes)")
    if frames != n_frames or ts_errors != 0 or not exact:
        raise RuntimeError(f"receiver gate failed ({label})")


def run_receive(label, rx, y, ts, n_frames, kernel):
    """One `receive()` route with the counts zeroed just before it; gates
    and the per-frame path's time.  -> the route's launch counts."""
    spent = _timed_decodes(rx)
    counts = _zero_counts()
    t0 = time.perf_counter()
    res = rx.receive(y)
    wall = time.perf_counter() - t0
    launches = _read_counts(counts)
    _ts_gate(label, res.ts, ts, res.stats.frames_decoded, n_frames,
             res.stats.ts_errors)
    iters = [it for s in res.stats.plp_stats.values() for it in s.ldpc_iters]
    log(f"[receiver {label}] per-frame path (demod, LLRs, LDPC, host L1, "
        f"BCH and TS) {1e3 * np.mean(spent[1:]):.2f} ms/frame over frames "
        f"2-{len(spent)}, first frame {1e3 * spent[0]:.2f} ms (with the "
        f"table builds); receive() {wall:.2f} s with host acquisition; SNR "
        f"{np.mean(res.stats.snr_db):.2f} dB; launches {launches}"
        + (f"; LDPC sweeps/frame {np.mean(iters):.2f}" if iters else ""))
    if launches[kernel] == 0:
        raise RuntimeError(f"receiver route {label} never launched {kernel}")
    return launches


def phase_receiver(p, plp, plp_k4, n_frames, device, seed=11):
    """The port's DeviceT2Receiver on `device`: receive() at 20 dB (K2),
    adaptive=False on the clean capture (K3) and at `plp_k4`'s code (K4),
    and the streaming batched path.  -> launch counts summed over the
    routes."""
    from sdr_receiver_dvb_t2_tpu.io import devices
    from sdr_receiver_dvb_t2_tpu.tx.modulator import apply_cfo, awgn
    from sdr_receiver_dvb_t2_tpu_torch.rx.device_receiver import \
        DeviceT2Receiver
    from sdr_receiver_dvb_t2_tpu_torch.utils import benchgen as bg

    t0 = time.time()
    ts, frames, _ = bg.modulate(p, plp, n_frames, seed=seed)
    clean = np.concatenate(frames)
    ts4, frames4, _ = bg.modulate(p, plp_k4, 3, seed=seed + 1)
    log(f"[receiver] modulated {n_frames} frames at {plp.rate.name} and 3 "
        f"at {plp_k4.rate.name} on the host in {time.time() - t0:.1f} s")
    total = {k: 0 for k in kernel_wrappers()}

    def add(launches):
        for k, v in launches.items():
            total[k] += v

    noisy = awgn(apply_cfo(clean, bg.CFO_HZ), 20.0, seed=seed)
    add(run_receive("20 dB, adaptive", DeviceT2Receiver(device=device),
                    noisy, ts, n_frames, "K2"))
    add(run_receive("clean, adaptive=False",
                    DeviceT2Receiver(device=device, adaptive=False),
                    clean, ts, n_frames, "K3"))
    add(run_receive(f"clean {plp_k4.rate.name}, adaptive=False",
                    DeviceT2Receiver(device=device, adaptive=False),
                    np.concatenate(frames4), ts4, 3, "K4"))

    rx = DeviceT2Receiver(device=device, stream_batch=2)
    got = []
    counts = _zero_counts()
    t0 = time.perf_counter()
    st = devices.StreamingReceiver(
        devices.SimulatedDevice(clean, snr_db=30), receiver=rx).run(
            ts_sink=got.append)
    wall = time.perf_counter() - t0
    launches = _read_counts(counts)
    add(launches)
    ts_got = np.concatenate(got) if got else np.zeros(0, np.uint8)
    _ts_gate("streaming, 30 dB", ts_got, ts, st.frames_decoded, n_frames,
             st.ts_errors)
    stages = st.metrics.stages
    per = {k: 1e3 * stages[k].seconds / max(stages[k].calls, 1)
           for k in ("frontend", "decode", "decode_batch") if k in stages}
    batch_frames = stages["decode_batch"].items / p.frame_samples \
        if "decode_batch" in stages else 0
    log(f"[receiver streaming] {st.frontend} (host front end) "
        f"{1e3 * stages['frontend'].seconds / n_frames:.2f} ms/frame; "
        f"batched path "
        f"{1e3 * stages['decode_batch'].seconds / max(batch_frames, 1):.2f}"
        f" ms/frame over {rx.batch_supersteps} supersteps; per-frame path "
        f"{per.get('decode', 0.0):.2f} ms/frame; run {wall:.2f} s; "
        f"launches {launches}")
    if rx.batch_supersteps < 1 or launches["K2"] == 0:
        raise RuntimeError("the streaming run made no batched superstep "
                           "through K2")
    jax_mods = sorted(m for m in sys.modules if m.split(".")[0] == "jax")
    if jax_mods:
        raise RuntimeError(f"jax was imported: {jax_mods[:5]}")
    log("[receiver] no jax module loaded")
    return total


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=4,
                    help="frames per superstep (default 4)")
    ap.add_argument("--rx-frames", type=int, default=4,
                    help="frames of the receiver capture (default 4)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        log("FAIL: no CUDA device; this smoke test runs only on the card")
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from sdr_receiver_dvb_t2_tpu.dvbt2.params import CodeRate
    from sdr_receiver_dvb_t2_tpu_torch.utils import benchgen as bg

    phase_build()
    checks = phase_kernels()
    launches, err_slice = phase_slice(args.frames)
    p, plp = bg.headline_mode(NUM_BLOCKS)
    rx_launches = phase_receiver(
        p, plp, dataclasses.replace(plp, rate=CodeRate.C3_5),
        args.rx_frames, "cuda")
    names = {"K1": "ldpc_layered_vmem_adaptive_io",
             "K2": "ldpc_layered_vmem_adaptive",
             "K3": "ldpc_layered_vmem", "K4": "ldpc_layered_hbm"}
    lines = {"K1": 819, "K2": 665, "K3": 1020, "K4": 227}
    kernels = []
    for k in ("K1", "K2", "K3", "K4"):
        err, (k_ms, p_ms) = checks[k]
        n = launches[k] + rx_launches[k]
        if n == 0:
            raise RuntimeError(f"{k} was never launched on a main path")
        kernels.append({
            "name": f"{k} {names[k]}", "route": "cuda", "source": SOURCE,
            "replaces": f"{PALLAS}:{lines[k]}", "launches": n,
            "max_abs_err": max(err, err_slice) if k == "K1" else err,
            "ms": k_ms, "plain_ms": p_ms})
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
