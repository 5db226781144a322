"""A cell on the live receive path: its workload file says `"path":
"stream"`, and the run replays one looped capture (`gen/capture.py`)
through the program's `io.devices.StreamingReceiver` and
`rx.device_receiver.DeviceT2Receiver`, built as `rx.cli --device-path`
builds them.  The file's stream keys: `device_rate` (samples/s),
`block_seconds`, `stream_batch`, `capture_frames` (a whole loop of the
TS: `gen/capture.Payload.loop_frames`).

Set-up (counted in `setup_s`, from process start): the cell's files, the
host encoding of the base frame and of the TS's period, the capture
rendered on the card and brought to the host, the receiver, and its run
up to the first block after lock and after its first batched decode.
The window: the same run, block after block, until the first block
--seconds or more later that decoded frames (`Window`); the harness sees
it through the receiver's `on_block` callback and ends it through the
`control` STOP path, after which the receiver decodes what it holds.
The device (`loop_device`) serves the capture in a loop from LEAD_FRAMES
frames before the seam; each read is a slice and a cast, and the AGC's
gain steps and retunes change nothing, as with a recording.

What decides `correct` (`numbers`), over the whole run, set-up and
the frames decoded after the STOP included: every TS packet the sink
received equals the payload's packet at its place, aligned once at the
first decoded frame; as many packets arrived as the decoded frames hold;
the receiver's counts of reacquisitions, skipped frames, TS errors, L1
failures, overruns and BCH failures are 0; and the receiver's sample
clock estimate lies within the cell's limit of the capture's."""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from . import cells, check, trace
from .gen import capture, synth

LEAD_FRAMES = 16              # the loop starts this many frames before
                              # its seam
SETUP_LIMIT_S = 240.0         # a run not in its window by then stops
CLOSE_BY = 2.0                # the window closes by this many times
                              # --seconds, frames decoded in its last
                              # block or not
BANDWIDTH_MHZ = 8.0           # rx.cli's default --bandwidth
EXACT = ("ts_packets_wrong", "ts_packets_missing", "reacquisitions",
         "frames_skipped", "ts_errors", "l1_failures", "overruns",
         "bch_failures", "setup_unfinished")
TOLERANCE = ("sco_err_ppm",)
STAGES = ("frontend", "track", "decode_batch", "decode")


def is_stream(wl: dict) -> bool:
    return wl.get("path") == "stream"


class Inputs:
    """The generator's side: the base frame (its L1, carrier map and P1)
    and the looped TS from the seed's payload and pool streams, and the
    capture with the seed's noise."""

    def __init__(self, cfg: dict, wl: dict, seed: int, device):
        st = cells.streams(seed)
        self.p, self.plp = synth.mode(cfg)
        self.base = synth.BaseFrame(self.p, self.plp, st["payload"])
        self.nb = self.base.nb
        self.payload = capture.Payload(self.plp, st["pool"])
        self.frames = int(wl["capture_frames"])
        if self.frames % self.payload.loop_frames(self.nb):
            raise SystemExit(
                f"capture_frames {self.frames} is no whole loop of the TS: "
                f"{self.payload.loop_frames(self.nb)} frames of {self.nb} "
                f"blocks hold a whole number of its periods")
        self.rate = float(wl["device_rate"])
        noise = torch.Generator(device=device).manual_seed(st["noise"])
        self.capture, self.truth = capture.render(
            self.base, self.payload, self.frames, self.rate,
            cells.nvar_rel(wl), noise, device)
        # read as the SDR would: int16 to complex64 at a fixed scale, here
        # unit rms, where the AGC asks for no step
        self.scale = float(1.0 / np.sqrt(2.0 * np.mean(
            self.capture[::64].astype(np.float32) ** 2)))
        self.sco_ppm = (self.truth["ratio"] * capture.ELEMENTARY / self.rate
                        - 1.0) * 1e6


def loop_device(inputs: Inputs):
    """A `io.devices.SDRDevice` that serves the capture in a loop, from
    LEAD_FRAMES frames before its seam; `restart` is the raw sample the
    loop goes on from after the seam (0: the capture's first)."""
    from sdr_receiver_dvb_t2_tpu_torch.io.devices import SDRDevice

    class LoopDevice(SDRDevice):
        def __init__(self):
            self.sample_rate = inputs.rate
            self.cap = inputs.capture
            self.scale = np.float32(inputs.scale)
            lead = inputs.frames - LEAD_FRAMES % inputs.frames
            self.start_at = int(round(lead * inputs.truth["frame_raw"]))
            self.pos = self.start_at
            self.restart = 0
            self.seams = 0

        def init(self, frequency_hz: float, gain_db: float = 0.0) -> None:
            self.pos = self.start_at

        def read_block(self, n: int) -> np.ndarray:
            parts, left = [], n
            while left:
                take = min(left, len(self.cap) - self.pos)
                parts.append(self.cap[self.pos:self.pos + take])
                self.pos += take
                left -= take
                if self.pos == len(self.cap):
                    self.pos = self.restart
                    self.seams += 1
            blk = parts[0] if len(parts) == 1 else np.concatenate(parts)
            x = blk.astype(np.float32)
            x *= self.scale
            return x.view(np.complex64).reshape(-1)

    return LoopDevice()


class Program:
    """The program's side, as `rx.cli --device-path` builds it: the device
    receiver at the CLI's defaults but for the cell's `stream_batch`, and
    the streaming loop with AGC, no ring, the cell's `block_seconds`."""

    def __init__(self, inputs: Inputs, wl: dict, device):
        from sdr_receiver_dvb_t2_tpu_torch.dvbt2.params import Bandwidth
        from sdr_receiver_dvb_t2_tpu_torch.io import devices
        from sdr_receiver_dvb_t2_tpu_torch.rx.device_receiver import \
            DeviceT2Receiver
        fs = Bandwidth.from_mhz(BANDWIDTH_MHZ).sample_rate
        self.device = loop_device(inputs)
        self.device.init(frequency_hz=0.0, gain_db=0.0)
        self.rx = DeviceT2Receiver(plp_filter=None, profile="base", fs=fs,
                                   device=device, ldpc_max_iters=24,
                                   adaptive=True,
                                   stream_batch=int(wl["stream_batch"]))
        self.sr = devices.StreamingReceiver(
            self.device, self.rx, agc=True, use_ring=False,
            checkpoint_path=None, block_seconds=float(wl["block_seconds"]))
        self.frame_raw = inputs.truth["frame_raw"]


class StreamProfile(trace.Profile):
    """Idle gaps named by the program's own `t2.*` stage spans (the
    streaming loop's `Metrics.stage`, ranges while the tracer is on)."""
    PREFIX = "t2."
    INNER = ()


class Window:
    """The `on_block` and `control` of the run: opens the window at the
    first block after lock and after the first batched decode, and closes
    it at the first block, --seconds or more later, in which the receiver
    decoded frames (so the window holds whole decodes: a batched decode
    hands over `stream_batch` frames at once), or at CLOSE_BY times
    --seconds if none comes; STOP at the next poll.  It keeps each block's
    time and the program's counts at both ends.  With `prof`, the whole
    window is profiled."""

    def __init__(self, prog: Program, seconds: float, t_start: float,
                 prof: StreamProfile | None):
        self.prog, self.seconds, self.t_start = prog, seconds, t_start
        self.prof = prof
        self.stop = False
        self.t0 = self.t1 = None
        self.block_ms = []
        self.chunks, self.packets = [], 0
        self.at_open = self.at_close = None
        self.rxstats = None

    # the sink and the control, as rx.cli hands them over
    def sink(self, ts: np.ndarray) -> None:
        self.chunks.append(ts)
        self.packets += len(ts) // 188

    def publish(self, status: dict) -> None:
        pass

    def poll(self, receiver, flush_ts) -> bool:
        return self.stop

    def _counts(self, st, rxstats) -> dict:
        stages = st.metrics.stages
        return {"frames": rxstats.frames_decoded, "packets": self.packets,
                "supersteps": self.prog.rx.batch_supersteps,
                "per_frame": stages["decode"].calls if "decode" in stages
                else 0,
                **{s: stages[s].seconds if s in stages else 0.0
                   for s in STAGES}}

    def __call__(self, st, lock, rxstats) -> None:
        now = time.perf_counter()
        self.rxstats = rxstats
        if self.stop:
            return
        if self.t0 is None:
            if lock is not None and self.prog.rx.batch_supersteps > 0:
                self.t0 = self.t_prev = now
                self.at_open = self._last = self._counts(st, rxstats)
                if self.prof is not None:
                    self.prof.begin()
            elif now - self.t_start > SETUP_LIMIT_S:
                self.stop = True
            return
        self.block_ms.append((now - self.t_prev) * 1e3)
        self.t_prev = now
        counts = self._counts(st, rxstats)
        decoded = counts["frames"] > self._last["frames"]
        self._last = counts
        held = now - self.t0
        if (held >= self.seconds and decoded) \
                or held >= CLOSE_BY * max(self.seconds, 1.0):
            if self.prof is not None:
                self.prof.end()
            self.t1, self.at_close, self.stop = now, counts, True


def faults(st, rxstats) -> dict:
    """The receiver's own counts that a sound run leaves at 0."""
    return {"reacquisitions": st.reacquisitions,
            "frames_skipped": st.frames_skipped, "ts_errors": st.ts_errors,
            "l1_failures": rxstats.l1_failures, "overruns": st.overruns,
            "bch_failures": sum(s.bch_failures
                                for s in rxstats.plp_stats.values())}


def ts_numbers(inputs: Inputs, chunks: list, frames: int):
    """The TS check of every packet the sink received: -> ({"ts_packets_wrong",
    "ts_packets_missing"}, ok (frames,) bool: the decoded frames, from the
    first, none of whose packets is wrong or missing).

    The first packet fixes the frame grid: it is the first that starts in
    the first decoded frame (the receiver's TS framer starts unlocked and
    locks at that frame's first BB frame).  It is placed once in the
    payload, and packet i after it is held against the payload's next
    i-th; as many packets have to come as the decoded frames hold from
    there.  A packet belongs to the frame that holds its last byte."""
    pay, nb = inputs.payload, inputs.nb
    k, dfl = len(pay.packets), pay.dfl
    got = (np.concatenate(chunks).reshape(-1, 188) if chunks
           else np.zeros((0, 188), np.uint8))
    at = (np.nonzero((pay.packets == got[0]).all(axis=1))[0] if len(got)
          else [])
    if len(at) != 1 or frames == 0:
        return ({"ts_packets_wrong": len(got),
                 "ts_packets_missing": max(frames, 1)},
                np.zeros(frames, bool))
    p0 = int(at[0])
    # the first decoded frame's first BB frame: the last frame start at or
    # before the first packet's (frames start on multiples of gcd(nb, P))
    j0 = p0 * 188 // dfl
    j0 -= j0 % math.gcd(nb, pay.period)
    first = -(-j0 * dfl // 188)
    end = (j0 + frames * nb) * dfl // 188
    n = max(end - first, len(got))
    lead = p0 - first
    good = np.zeros(n, bool)
    good[lead:lead + len(got)] = (got == pay.packets[
        (p0 + np.arange(len(got))) % k]).all(axis=1)
    owner = (((first + np.arange(n) + 1) * 188 - 1) // dfl - j0) // nb
    ok = np.ones(frames, bool)
    bad = owner[~good]
    ok[bad[(bad >= 0) & (bad < frames)]] = False
    return ({"ts_packets_wrong": int((~good[lead:lead + len(got)]).sum()),
             "ts_packets_missing": abs(end - first - len(got))}, ok)


def control_numbers(inputs: Inputs) -> dict:
    """The control's numbers: the capture's own sample clock, the one that
    the configuration states in float32, rounded to bfloat16 in the
    program's place."""
    ratio = float(torch.tensor(inputs.truth["ratio"], dtype=torch.float64
                               ).to(check.CONTROL_TRACK_DTYPE))
    sco = (ratio * capture.ELEMENTARY / inputs.rate - 1.0) * 1e6
    return {"sco_err_ppm": abs(sco - inputs.sco_ppm)}


def verdict(numbers: dict, limits: dict):
    return check.verdict(numbers, limits, exact=EXACT, tolerance=TOLERANCE)


def execute(wl: dict, cfg: dict, seed: int, seconds: float, tracing: bool,
            device, t_start: float, patch=None) -> dict:
    """One run of the cell.  -> {"numbers", "rec", "inputs", "peak",
    "setup_parts", "info", "device_ops": every device operation traced
    with its seconds (traced runs), "failed"}."""
    on_card = device.type == "cuda"
    t_in = time.perf_counter()
    inputs = Inputs(cfg, wl, seed, device)
    if on_card:
        # the capture lives on the host: its rendering sets no peak
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    t_prog = time.perf_counter()
    prog = Program(inputs, wl, device)
    if patch is not None:
        patch(prog)
    prof = None
    if tracing:
        from sdr_receiver_dvb_t2_tpu_torch.utils.metrics import TRACER
        TRACER.enable()
        prof = StreamProfile()
    win = Window(prog, seconds, t_start, prof)
    st = prog.sr.run(ts_sink=win.sink, on_block=win, control=win)
    peak = int(torch.cuda.max_memory_allocated(device)) if on_card else 0
    opened = win.t0 is not None
    if not opened:
        win.t0 = win.t1 = time.perf_counter()
        win.at_open = win.at_close = {"frames": 0, "packets": 0,
                                      "supersteps": 0, "per_frame": 0,
                                      **{s: 0.0 for s in STAGES}}
    setup_s = win.t0 - t_start
    setup_parts = {"imports and files": t_in - t_start,
                   "inputs (host encoding, capture)": t_prog - t_in,
                   "receiver to its window": win.t0 - t_prog}
    # judged: every packet and count of the run; the window's frames that
    # pass are the ones the rate counts
    frames_total = st.frames_decoded
    numbers, ok = ts_numbers(inputs, win.chunks, frames_total)
    f0, f1 = win.at_open["frames"], win.at_close["frames"]
    counted = int(ok[f0:f1].sum())
    numbers.update(faults(st, win.rxstats))
    numbers.update({"setup_unfinished": int(not opened),
                    "sco_err_ppm": abs(st.sco_ppm - inputs.sco_ppm)})
    window_s = win.t1 - win.t0
    d = {k: win.at_close[k] - win.at_open[k] for k in win.at_open}
    rec = {"setup_s": setup_s, "window_s": window_s,
           "step_ms": win.block_ms, "frames": counted,
           "samples_per_frame": inputs.p.frame_samples,
           "trace": prof.result() if prof is not None else None,
           "stream": {
               "frames": d["frames"],
               "batched_frames": d["frames"] - d["per_frame"],
               "stage_s": {k: d[k] for k in STAGES}}}
    info = {"frames_decoded": frames_total, "window_frames": d["frames"],
            "window_blocks": len(win.block_ms),
            "window_packets": d["packets"],
            "batched_supersteps": d["supersteps"],
            "seams_crossed": prog.device.seams,
            "gain_steps": st.gain_steps, "retunes": st.retune_requests,
            "cfo_err_hz": st.cfo_hz - inputs.truth["cfo_hz"],
            "sco_ppm": st.sco_ppm, "sco_ppm_true": inputs.sco_ppm,
            "snr_db": float(np.mean(st.snr_db)) if st.snr_db else None,
            "frontend": st.frontend,
            "capture_raw_samples": inputs.truth["n_raw"],
            "window_first_frame": f0,
            "block_ms": [round(b, 1) for b in win.block_ms],
            "bad_frames": [int(i) for i in np.nonzero(~ok)[0][:20]]}
    ops = sorted(prof.by_op.items(), key=lambda kv: -kv[1]) if prof else []
    return {"numbers": numbers, "rec": rec, "inputs": inputs, "peak": peak,
            "setup_parts": setup_parts, "info": info, "device_ops": ops,
            "failed": int(d["frames"] - counted)}
