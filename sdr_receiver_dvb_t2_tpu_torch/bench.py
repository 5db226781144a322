"""The port's bench: 32K-FFT DVB-T2 receive throughput on one card, from
raw impaired device-rate samples to transport-stream bytes.

    python -m sdr_receiver_dvb_t2_tpu_torch.bench            # on the card
    python -m sdr_receiver_dvb_t2_tpu_torch.bench --device cpu --frames 3

The port of the repository's `bench.py`.  The timed step is the superstep
(`rx/superstep.py`) over F frames of the headline mode (32K FFT, GI 1/128,
PP7 extended carriers, 256QAM C2/3 NORMAL, B=128 codewords per frame):
DC/IQ estimation and correction, NCO derotation and Farrow resampling on
the card (`ops/frontend_device.py`), FFT, pilot equalization and LLRs
(`rx/fusedpath.py`), the layered LDPC decoder with its in-kernel adaptive
exit (K1, `csrc/ldpc_layered.cu`), the BCH gate and the BB byte pack
(`ops/fec_device.py`), and a per-frame 64-bit hash.  CFO, SCO and frame
timing enter as tracking state that the product's own acquisition
estimates on a 2-frame capture (`--oracle-tracking`: the constants).

Every frame is distinct: F frames are synthesised on the card from one
frame's ingredients (`utils/benchgen.make_frame_synth`), frame f carrying
the FEC blocks rolled by f, and impaired there (CFO +1.2 kHz, SCO +22 ppm,
DC, IQ imbalance, AWGN, int16 ADC; optionally a static echo).  Gates, at
every point: the F per-frame hashes equal the host's expectation (the
weights depend on the byte and the codeword slot, so a permutation along
either axis fails), every codeword is BCH-clean, and one rotating frame's
TS is bit-exact against the host assembly of its rolled BB rows.

Timing (on the card only; a CPU run checks the gates and times nothing):
a data-dependent chain, each step adding its hash sum into the next
step's raw samples, with a host fetch at the end; per point the median
of 3 of (t(6 steps) - t(1 step)) / (5 F), with the spread.  Points: clean,
--snr (19 dB), --snr + 1 (20 dB), and --snr with the --multipath echo.

The second-to-last line of standard output is one JSON record of every
number the run printed; the last line is
  {"metric": "demod_32k_Msamples_per_s", "value": ..., "unit":
   "Msamples/s/chip", "vs_baseline": ...}
with vs_baseline the multiple of real time at 9.142857 Msamples/s; both
numbers are 0 unless the clean point passed every gate.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from ._device import resolve
from .dvbt2 import bbframe
from .dvbt2 import l1 as l1mod
from .rx import superstep as ssmod
from .tx import fec as txfec
from .tx import ofdm as txofdm
from .tx.modulator import T2Modulator
from .utils import benchgen as bg

METRIC = "demod_32k_Msamples_per_s"
REAL_TIME_MSPS = 9.142857      # the elementary rate of an 8 MHz channel
CHAIN = 6                      # steps of the long chain (the short has 1)
REPS = 3                       # chain measurements per point (median)
HOST_TAIL_FRAMES = 6


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` for the first card."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def stage_split(step, raw, inv, track, reps=3):
    """Device ms per stage of one superstep: a CUDA event at every stage
    mark of `Superstep.__call__`, the gaps summed by stage, the mean of
    `reps` steps after one warm-up."""
    step(*raw, inv, track)
    total = {}
    for _ in range(reps):
        events = [("start", torch.cuda.Event(enable_timing=True))]
        events[0][1].record()

        def mark(stage):
            events.append((stage, torch.cuda.Event(enable_timing=True)))
            events[-1][1].record()

        step(*raw, inv, track, mark=mark)
        torch.cuda.synchronize()
        for (_, e0), (stage, e1) in zip(events, events[1:]):
            total[stage] = total.get(stage, 0.0) + e0.elapsed_time(e1) / reps
    return total


def _nvar(snr_db: float) -> float:
    return 0.0 if snr_db <= 0 else 10.0 ** (-snr_db / 10.0)


def _inv_nvar(snr_db: float) -> float:
    return 10.0 ** ((snr_db if snr_db > 0 else 33.0) / 10.0)


class Bench:
    """The bench's state: the base payload and its frame ingredients, the
    superstep, the expected hashes and the tracking state.

    `noise` and `acq` are the torch.Generators (on `device`) of the
    superstep input's AWGN and of the acquisition capture's."""

    def __init__(self, p, plp, n_frames: int, device, noise, acq,
                 multipath=(0.15, 32), fixed_iters: int = 0,
                 no_impairments: bool = False, gate_frame=None, log=_log):
        self.dev = resolve(device, "the bench")
        self.p, self.plp, self.n_frames = p, plp, n_frames
        self.noise, self.acq, self.log = noise, acq, log
        self.no_impairments = no_impairments
        self.mp_amp, self.mp_delay = multipath
        nb_max = plp.num_blocks_max
        fec = plp.fec

        # the base TS and its mode adaptation into nb_max BB frames
        mod = T2Modulator(p, [plp])
        self.rng = np.random.default_rng(0)
        ts = self.rng.integers(0, 256, (mod.packets_needed(1) + 4, 188)
                               ).astype(np.uint8)
        ts[:, 0] = 0x47
        probe = T2Modulator(p, [plp])
        probe.adapters[0].push_packets(ts.reshape(-1))
        bb0 = np.stack([probe.adapters[0].next_frame()
                        for _ in range(nb_max)])
        cells0 = txfec.plp_encode(plp, bb0)          # (nb, cpf) rotated
        self.nb, self.cpf = cells0.shape
        out = mod.modulate(ts.reshape(-1), 1)
        l1_arr = np.concatenate([
            l1mod.l1pre_encode(out.l1pre),
            l1mod.l1post_encode(out.l1post_frames[0], mod.l1_post_mod)])
        self.maps = bg.probe_maps(p, plp, l1_arr, cells0)
        self.p1 = txofdm.generate_p1(p)
        self.rows = np.packbits(bb0, axis=1)         # (nb, kbch // 8)
        self.synth_fn, self.ship = bg.make_frame_synth(
            p, self.cpf, n_frames, *self.maps, self.p1, self.dev)

        # frame f slot b carries codeword (b + f) mod nb
        self.slot_src = (np.arange(nb_max)[None, :]
                         + np.arange(n_frames)[:, None]) % self.nb
        self.weights = ssmod.hash_weights(fec.k_bch // 8, nb_max)
        self.expect = np.stack([ssmod.expected_hash(self.rows[s],
                                                    self.weights)
                                for s in self.slot_src])
        self.gate_frame = (int(time.time()) % n_frames if gate_frame is None
                           else gate_frame)
        log(f"TS byte-extraction frame this run: "
            f"{self.gate_frame}/{n_frames}")
        self.step = ssmod.Superstep(p, plp, nb_max, n_frames, bg.FS,
                                    self.weights, fixed_iters=fixed_iters)

        if no_impairments:
            self.truth = (0.0, 1.0, float(2 * ssmod.HALF), bg.PHASE0)
        else:
            self.truth = (bg.CFO_HZ, 1.0 + bg.SCO,
                          ssmod.HALF * (1.0 + bg.SCO), bg.PHASE0)
        self.track = torch.tensor(self.truth, dtype=torch.float32,
                                  device=self.dev)

    def synth(self) -> torch.Tensor:
        """(F, frame_samples) complex64 distinct frames on the device."""
        return self.synth_fn(self.ship)

    def fresh_raw(self, snr_db: float, echo: bool = False, frames=None):
        """Synthesised frames (or `frames`), with the echo when asked,
        impaired at snr_db (<= 0: no AWGN) -> raw planes (F, n_raw) x2."""
        full = self.synth() if frames is None else frames
        return bg.impaired(full, _nvar(snr_db), self.noise, self.dev,
                           echo=(self.mp_amp, self.mp_delay) if echo
                           else (0.0, 0),
                           impair=not self.no_impairments)

    def estimate_tracking(self, snr_db: float) -> dict:
        """The product's tracking state from a contiguous 2-frame capture
        of synthesised frames 0 and 1 through the same impairer
        (`utils/benchgen.estimate_tracking`); the superstep then corrects
        with it.  -> the estimates and their errors."""
        t0 = time.time()
        self.track, (cfo, ratio, pos0) = bg.estimate_tracking(
            self.synth()[:2], _nvar(snr_db), self.acq, self.dev)
        est = {"snr_db": snr_db, "seconds": time.time() - t0,
               "cfo_hz": cfo, "cfo_err_hz": cfo - self.truth[0],
               "sco_ppm": (ratio - 1) * 1e6,
               "sco_err_ppm": (ratio - self.truth[1]) * 1e6,
               "pos0": pos0, "pos0_err": pos0 - self.truth[2]}
        self.log(f"estimated tracking state (acquired at "
                 f"{snr_db if snr_db > 0 else 33:g} dB in "
                 f"{est['seconds']:.1f} s): cfo {cfo:+.1f} Hz (err "
                 f"{est['cfo_err_hz']:+.2f}), sco {est['sco_ppm']:+.2f} ppm "
                 f"(err {est['sco_err_ppm']:+.3f}), frame start {pos0:.2f} "
                 f"raw (err {est['pos0_err']:+.2f} samples)")
        return est

    def chained(self, rr, ri, inv, mark=None):
        """One superstep, then its hash sum into the raw samples, so the
        next step on them depends on this one's decoded bytes."""
        sums, oks, iters, kept = self.step(rr, ri, inv, self.track,
                                           keep=(self.gate_frame,),
                                           mark=mark)
        rr.add_(sums.sum(dtype=torch.int32).float() * 1e-16)
        return sums, oks, iters, kept

    def _inv(self, snr_db):
        return torch.tensor(_inv_nvar(snr_db), dtype=torch.float32,
                            device=self.dev)

    def gate(self, snr_db: float, label: str, echo: bool = False,
             frames=None) -> dict:
        """One superstep on fresh input; the hashes of all F frames, BCH
        clean on every codeword, and the gate frame's TS bit-exact."""
        rr, ri = self.fresh_raw(snr_db, echo, frames)
        sums, oks, iters, kept = (t.cpu().numpy() for t in self.chained(
            rr, ri, self._inv(snr_db)))
        nb = self.plp.num_blocks_max
        hashes_ok = bool((sums == self.expect).all())
        bch_ok = bool((oks == nb).all())
        got = bg.reassemble_ts(kept)
        asm = bbframe.TSAssembler()
        asm.push_frames(np.ascontiguousarray(
            self.rows[self.slot_src[self.gate_frame]]))
        want = asm.ts_bytes()
        ts_ok = len(want) > 0 and np.array_equal(got, want)
        sweeps = float(iters) / self.n_frames
        self.log(f"[{label}] 64-bit byte hashes "
                 f"{'ok' if hashes_ok else 'FAIL'} x{len(sums)} frames "
                 f"(frame0 {sums[0]} expect {self.expect[0]}); BCH clean "
                 f"{oks.min()}..{oks.max()}/{nb}; LDPC {sweeps:.2f} "
                 f"sweeps/frame; TS bit-exact={ts_ok} ({len(got)} bytes)")
        return {"hashes_ok": hashes_ok, "bch_clean_min": int(oks.min()),
                "bch_ok": bch_ok, "ts_ok": bool(ts_ok),
                "ts_bytes": len(got), "sweeps_per_frame": sweeps,
                "ok": hashes_ok and bch_ok and bool(ts_ok)}

    def run_chain(self, n: int, snr_db: float, echo: bool = False) -> float:
        """Wall seconds of n chained steps on fresh input, ended by a host
        fetch that forces the whole chain."""
        rr, ri = self.fresh_raw(snr_db, echo)
        inv = self._inv(snr_db)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            sums = self.chained(rr, ri, inv)[0]
        int(sums[0, 0])
        return time.perf_counter() - t0

    def measure(self, snr_db: float, label: str, echo: bool = False) -> dict:
        """Median of REPS chain measurements with their spread."""
        self.run_chain(1, snr_db, echo)
        dts = []
        for _ in range(REPS):
            t1 = self.run_chain(1, snr_db, echo)
            tn = self.run_chain(CHAIN, snr_db, echo)
            dts.append((tn - t1) / ((CHAIN - 1) * self.n_frames))
        dt = float(np.median(dts))
        n_samp = self.p.frame_samples
        rec = {"ms_per_frame": dt * 1e3,
               "spread_pct": (max(dts) - min(dts)) / dt * 100.0,
               "samples_ms_per_frame": [d * 1e3 for d in dts],
               "msamples_per_s": n_samp / dt / 1e6,
               "ldpc_coded_mbit_per_s": (self.plp.num_blocks_max
                                         * self.plp.fec.n_ldpc / dt / 1e6)}
        rec["x_real_time"] = rec["msamples_per_s"] / REAL_TIME_MSPS
        self.log(f"[{label}] frame {n_samp} samples in "
                 f"{rec['ms_per_frame']:.3f} ms (median of {REPS}, spread "
                 f"{rec['spread_pct']:.0f}%: "
                 f"{[f'{d:.3f}' for d in rec['samples_ms_per_frame']]}); "
                 f"LDPC {rec['ldpc_coded_mbit_per_s']:.0f} Mbit/s coded; "
                 f"{rec['x_real_time']:.1f}x real time")
        return rec

    def busy(self, snr_db: float) -> dict:
        """The device's busy share over one chained step: the device
        kernel times torch.profiler records, summed, over the step's wall
        time (under the profiler); the top kernels by device time; the
        device ms by stage; and the first operation of one step that makes
        the host wait for the device (torch's sync debug mode, "error"),
        None if there is none: the chain's timing assumes the host issues
        ahead of the device."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        rr, ri = self.fresh_raw(snr_db)
        inv = self._inv(snr_db)
        self.chained(rr, ri, inv)
        torch.cuda.synchronize()
        host_sync = None
        with warnings.catch_warnings():
            # setting the mode warns that it is a prototype
            warnings.simplefilter("ignore")
            torch.cuda.set_sync_debug_mode("error")
            try:
                self.chained(rr, ri, inv)
            except RuntimeError as e:
                host_sync = str(e).splitlines()[0]
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            self.chained(rr, ri, inv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
        rec = {"device_ms_per_step": device_ms,
               "profiled_step_ms": wall * 1e3,
               "busy_share": device_ms / (wall * 1e3),
               "kernel_launches": sum(e.count for e in kernels),
               "top_kernels": [{"name": e.key[:80], "count": e.count,
                                "ms": e.self_device_time_total / 1e3}
                               for e in top],
               "host_sync": host_sync}
        split = stage_split(
            lambda rr, ri, inv, _track, mark=None: self.chained(
                rr, ri, inv, mark), (rr, ri), inv, None)
        rec["stage_ms_per_step"] = split
        self.log(f"[busy] one chained step: {device_ms:.2f} ms of device "
                 f"time in {rec['profiled_step_ms']:.2f} ms wall under the "
                 f"profiler = {100 * rec['busy_share']:.1f}% busy, "
                 f"{rec['kernel_launches']} kernels; host waits for the "
                 f"device in a step: {host_sync or 'none'}; device ms by "
                 f"stage: " + ", ".join(f"{k} {v:.2f}"
                                        for k, v in split.items()))
        for t in rec["top_kernels"]:
            self.log(f"[busy]   {t['ms']:9.3f} ms x{t['count']:5d}  "
                     f"{t['name']}")
        return rec

    def profile_stages(self) -> dict:
        """Per-frame ms of the front end alone and of the front end +
        demod + LLRs, each as its own chain at the clean point."""
        step = self.step
        track = self.track
        inv = self._inv(0.0)

        def front(rr, ri):
            (sr, _), _, _ = step.frontend(rr, ri, *track)
            return sr.float().sum()

        def demod(rr, ri):
            (sr, si), _, _ = step.frontend(rr, ri, *track)
            return step.mf.syms(sr, si, inv).float().sum()

        def chain(fn, n):
            rr, ri = self.fresh_raw(0.0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                sd = fn(rr, ri)
                rr.add_(sd * 1e-16)
            float(sd)
            return time.perf_counter() - t0

        rec = {}
        for name, fn in (("frontend", front), ("frontend_demod_llr", demod)):
            chain(fn, 1)
            t1, tn = chain(fn, 1), chain(fn, CHAIN)
            rec[name] = (tn - t1) / ((CHAIN - 1) * self.n_frames) * 1e3
            self.log(f"[profile] {name}: {rec[name]:.3f} ms/frame")
        return rec

    def host_tail(self) -> dict:
        """Batched TS reassembly on the host, per frame of B BB frames."""
        fec, nb = self.plp.fec, self.plp.num_blocks_max
        need = HOST_TAIL_FRAMES * nb * (fec.k_bch - 80) // 8 // 188 + 200
        ts = self.rng.integers(0, 256, (need, 188)).astype(np.uint8)
        ts[:, 0] = 0x47
        fr = bbframe.ts_to_bbframes(ts.reshape(-1), fec.k_bch,
                                    HOST_TAIL_FRAMES * nb, hem=False)
        rows = np.packbits(fr, axis=1).reshape(HOST_TAIL_FRAMES, nb, -1)
        asm = bbframe.TSAssembler()
        asm.push_frames(rows[0])              # warm up and lock
        t0 = time.perf_counter()
        for i in range(1, HOST_TAIL_FRAMES):
            asm.push_frames(rows[i])
        ms = (time.perf_counter() - t0) * 1e3 / (HOST_TAIL_FRAMES - 1)
        self.log(f"host TS tail: {ms:.2f} ms/frame "
                 f"({len(asm.ts_bytes())} TS bytes, {asm.errors} errors)")
        return {"ms_per_frame": ms, "errors": int(asm.errors)}


def run(p=None, plp=None, *, frames: int = 128, snr: float = 19.0,
        multipath=(0.15, 32), oracle_tracking: bool = False,
        fixed_iters: int = 0, no_impairments: bool = False,
        profile: bool = False, device="cuda", noise=None, acq=None,
        gate_frame=None, log=_log) -> dict:
    """Run the bench and return its record (every number it printed).

    `p`, `plp`: the mode (default the headline mode, B=128 codewords per
    frame).  `noise`, `acq`: torch.Generators on `device` for the AWGN of
    the superstep input and of the acquisition capture (default seeded 7
    and 11).  On the card every point is gated and timed; with
    device="cpu" the gates run and nothing is timed.  Points: clean; with
    snr > 0 also snr, snr + 1 and, with a multipath delay, snr with the
    echo."""
    if p is None:
        p, plp = bg.headline_mode()
    dev = resolve(device, "the bench")
    if noise is None:
        noise = torch.Generator(device=dev).manual_seed(7)
    if acq is None:
        acq = torch.Generator(device=dev).manual_seed(11)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    b = Bench(p, plp, frames, dev, noise, acq, multipath=multipath,
              fixed_iters=fixed_iters, no_impairments=no_impairments,
              gate_frame=gate_frame, log=log)
    rec = {"device": {"platform": "gpu" if on_card else "cpu",
                      "kind": torch.cuda.get_device_name(dev) if on_card
                      else "cpu",
                      "card": card_line() if on_card else None},
           "frames": frames, "num_blocks": plp.num_blocks_max,
           "frame_samples": p.frame_samples, "gate_frame": b.gate_frame,
           "decoder": (f"fixed {fixed_iters} sweeps" if fixed_iters
                       else "adaptive (K1)"),
           "impairments": not no_impairments, "points": {}}
    if no_impairments or oracle_tracking:
        rec["tracking"] = "oracle"
    else:
        rec["tracking"] = b.estimate_tracking(snr)
    points = [("clean", 0.0, False)]
    if snr > 0:
        points += [(f"{snr:g} dB", snr, False),
                   (f"{snr + 1:g} dB", snr + 1.0, False)]
        if multipath[1] > 0:
            points.append((f"{snr:g} dB echo {multipath[0]:g}@"
                           f"{multipath[1]}", snr, True))
    for i, (label, snr_db, echo) in enumerate(points):
        pt = {"snr_db": snr_db, "echo": echo, **b.gate(snr_db, label, echo)}
        if i == 0:
            rec["setup_seconds"] = time.time() - t0
            log(f"set-up and first step: {rec['setup_seconds']:.1f} s")
        if on_card:
            pt.update(b.measure(snr_db, label, echo))
        rec["points"][label] = pt
        if i == 0 and on_card:
            rec["busy_clean"] = b.busy(0.0)
            if profile:
                rec["profile_ms_per_frame"] = b.profile_stages()
        if i == 0:
            rec["host_tail"] = b.host_tail()
    if on_card:
        rec["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
        log(f"peak device memory {rec['peak_memory_bytes'] / 2**30:.2f} GiB")
    clean = rec["points"]["clean"]
    exact = clean["ok"]
    log(f"correctness: clean point hashes, BCH and TS bit-exact = {exact}; "
        f"every point = {all(v['ok'] for v in rec['points'].values())}")
    msps = clean.get("msamples_per_s", 0.0) if exact else 0.0
    rec["metric"] = {"metric": METRIC, "value": round(msps, 2),
                     "unit": "Msamples/s/chip",
                     "vs_baseline": round(msps / REAL_TIME_MSPS, 2)}
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--snr", type=float, default=19.0,
                    help="threshold-SNR point in dB, measured with snr + 1 "
                         "and the echo after the clean point (<= 0: clean "
                         "only)")
    ap.add_argument("--frames", type=int, default=128,
                    help="frames per superstep (default 128, every "
                         "codeword slot of every frame distinct)")
    ap.add_argument("--multipath", default="0.15,32",
                    help="'amp,delay' static echo in elementary-rate "
                         "samples for the echo point ('' disables it)")
    ap.add_argument("--oracle-tracking", action="store_true",
                    help="correct with the impairment constants instead of "
                         "the acquisition's estimates")
    ap.add_argument("--fixed-iters", type=int, default=0,
                    help="decode with this many sweeps of the fixed decoder "
                         "(K3 at C2/3) instead of the adaptive K1")
    ap.add_argument("--no-impairments", action="store_true",
                    help="clean samples at the elementary rate (AWGN only): "
                         "for stage-cost comparison")
    ap.add_argument("--profile", action="store_true",
                    help="also time the front end alone and the front end "
                         "+ demod + LLRs per frame")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the gates "
                         "only, at a size the CPU can hold)")
    args = ap.parse_args(argv)
    mp = (args.multipath or "").strip()
    multipath = ((float(mp.split(",")[0]), int(mp.split(",")[1])) if mp
                 else (0.0, 0))
    rec = run(frames=args.frames, snr=args.snr, multipath=multipath,
              oracle_tracking=args.oracle_tracking,
              fixed_iters=args.fixed_iters,
              no_impairments=args.no_impairments, profile=args.profile,
              device=args.device)
    print(json.dumps(rec))
    print(json.dumps(rec["metric"]))
    if not all(v["ok"] for v in rec["points"].values()):
        sys.exit(1)


if __name__ == "__main__":
    main()
