"""SDR device layer: the framework's equivalent of the reference's L0
ingest (rx_sdrplay / rx_airspy / rx_plutosdr, SURVEY.md §2.1).

The reference couples its device thread to the demodulator through the
`signal_estimate` struct (dvbt2_demodulator.h:42-52): the demodulator asks
the hardware for coarse retunes, AGC gain steps, resampler corrections and
resets, and the device applies them between read blocks
(rx_sdrplay.cpp:158-197, 230-279).  This module reproduces that control
plane TPU-side:

  - `SignalEstimate`  — the feedback struct,
  - `SDRDevice`       — get/init/start/read_block/apply/stop interface,
  - `FileDevice`      — replays recorded captures at device rate,
  - `SimulatedDevice` — a modulated signal behind a hardware model
    (LO offset, clock ppm, gain); retune/AGC feedback acts on the model
    exactly like stepping a real LO/attenuator, so the closed-loop
    acquisition state machine can be exercised without hardware,
  - live vendor front ends live in io/vendor.py: `SdrplayDevice`
    (mir_sdr blocking ReadPacket loop), `AirspyDevice` (libairspy async
    callback into the native ring) and `PlutoDevice` (the reference's
    custom hi-speed libusb API, planar int16 transfers), registered here
    as "sdrplay" / "airspy" / "plutosdr"; for a radio on another machine
    use the network front end (io/net.py, `t2radio`).

Streaming consumption is in `StreamingReceiver` below: blocks -> elastic
buffer -> acquisition -> block decode -> TS sink, with feedback applied
between blocks (the reference's 7-thread pipeline collapsed into a loop
around the batched receiver).
"""
from __future__ import annotations

import logging
from dataclasses import dataclass, field

import numpy as np

from ..dvbt2.params import SAMPLE_RATE


@dataclass
class SignalEstimate:
    """Demodulator -> device feedback (dvbt2_demodulator.h:42-52)."""
    correct_resample: float = 0.0     # fractional sample-rate correction
    coarse_freq_offset: float = 0.0   # Hz; retune request
    gain_offset: float = 0.0          # dB; AGC step request
    signal_level: float = 0.0         # measured input level 0..1
    change_frequency: bool = False
    change_gain: bool = False
    reset: bool = False


class SDRDevice:
    """get/init/start/stop + blockwise read, like rx_sdrplay.h:34-48."""

    sample_rate: float = SAMPLE_RATE

    def init(self, frequency_hz: float, gain_db: float = 0.0) -> None:
        raise NotImplementedError

    def start(self) -> None:
        pass

    def read_block(self, n: int) -> np.ndarray | None:
        """Next n samples as complex64 (None = end of stream)."""
        raise NotImplementedError

    def apply(self, est: SignalEstimate) -> None:
        """Apply demodulator feedback (retune / AGC / reset)."""

    def flush(self) -> None:
        """Discard buffered samples (called after a hardware retune so
        data captured at the old LO is not re-measured)."""

    def stop(self) -> None:
        pass


class FileDevice(SDRDevice):
    """Replays a recorded capture; retune requests become a digital NCO
    shift (the recorded LO cannot move, but the correction is exact)."""

    def __init__(self, path: str, fmt: str | None = None,
                 sample_rate: float = SAMPLE_RATE):
        from . import iq as iqio
        self.samples = iqio.read_iq(path, fmt)
        self.sample_rate = sample_rate
        self.pos = 0
        self._freq_shift = 0.0
        self._gain = 1.0

    def init(self, frequency_hz: float, gain_db: float = 0.0) -> None:
        self.pos = 0
        self._gain = 10.0 ** (gain_db / 20.0)

    def read_block(self, n: int) -> np.ndarray | None:
        if self.pos >= len(self.samples):
            return None
        x = self.samples[self.pos:self.pos + n]
        idx = np.arange(self.pos, self.pos + len(x))
        self.pos += len(x)
        if self._freq_shift:
            x = x * np.exp(-2j * np.pi * self._freq_shift * idx
                           / self.sample_rate)
        return (x * self._gain).astype(np.complex64)

    def apply(self, est: SignalEstimate) -> None:
        if est.change_frequency:
            self._freq_shift += est.coarse_freq_offset
        if est.change_gain:
            self._gain *= 10.0 ** (est.gain_offset / 20.0)
        if est.reset:
            self.pos = 0


class SimulatedDevice(SDRDevice):
    """A transmit waveform behind a hardware front-end model: LO offset,
    sample-clock ppm, analog gain ahead of a quantizing/clipping ADC, and
    a fixed receiver noise floor.  Feedback steps the model the way real
    hardware steps mid-stream (rx_sdrplay.cpp:158-197): retunes and gain
    changes are phase/position-continuous (no stream restart), so closed
    loops (AGC, retune) can be exercised exactly as against an SDR.

    `snr_db` is the SNR at gain 0 dB (the signal is normalized to unit
    RMS); the noise floor is absolute, so a cold signal (negative gain)
    loses SNR and a hot one clips the ADC — the regime that makes the AGC
    loop load-bearing (the reference's level estimate + gain step,
    dvbt2_demodulator.cpp:234-249)."""

    def __init__(self, samples: np.ndarray, lo_offset_hz: float = 0.0,
                 clock_ppm: float = 0.0, gain_db: float = 0.0,
                 snr_db: float | None = None, seed: int = 0,
                 sample_rate: float = SAMPLE_RATE,
                 adc_bits: int | None = None,
                 lo_drift_hz_per_s: float = 0.0,
                 dc_offset: complex = 0.0,
                 iq_gain: float = 1.0, iq_skew: float = 0.0):
        self.base = np.asarray(samples, dtype=np.complex64)
        self.lo_offset_hz = lo_offset_hz
        self.lo_drift_hz_per_s = lo_drift_hz_per_s
        self.clock_ppm = clock_ppm
        self.gain_db = gain_db
        self.snr_db = snr_db
        self.seed = seed
        self.sample_rate = sample_rate
        self.adc_bits = adc_bits
        # analog front-end impairments (receiver-side, so applied to signal
        # AND noise, after the LO mixer): Q-branch gain deficit `iq_gain`
        # (Q' = Q/iq_gain), I->Q quadrature leak `iq_skew` (Q' += skew*I),
        # and a baseband DC offset — dvbt2_demodulator.cpp:187-192's targets
        self.dc_offset = complex(dc_offset)
        self.iq_gain = iq_gain
        self.iq_skew = iq_skew
        self.pos = 0
        self._stream: np.ndarray | None = None
        self._noise: np.ndarray | None = None
        self.retunes = 0
        self.gain_steps = 0

    # ADC full scale: unit-RMS OFDM has ~10 dB PAPR, so 0 dB gain sits
    # comfortably; +20 dB clips hard
    _ADC_FULL_SCALE = 4.0

    def _render(self) -> None:
        from ..rx import frontend
        x = self.base
        if self.clock_ppm:
            x = frontend.sinc_resample(x, 1.0 + self.clock_ppm * 1e-6)
        rms = float(np.sqrt(np.mean(np.abs(x) ** 2)))
        self._stream = (x / max(rms, 1e-30)).astype(np.complex64)
        if self.snr_db is not None:
            rng = np.random.default_rng(self.seed)
            nv = 10.0 ** (-self.snr_db / 10.0)
            n = len(self._stream)
            self._noise = (rng.normal(0, np.sqrt(nv / 2), n)
                           + 1j * rng.normal(0, np.sqrt(nv / 2), n)
                           ).astype(np.complex64)

    def init(self, frequency_hz: float, gain_db: float = 0.0) -> None:
        self.pos = 0
        self._render()

    def read_block(self, n: int) -> np.ndarray | None:
        if self._stream is None:
            self._render()
        if self.pos >= len(self._stream):
            return None
        lo, hi = self.pos, min(self.pos + n, len(self._stream))
        self.pos = hi
        x = self._stream[lo:hi] * np.float32(10.0 ** (self.gain_db / 20.0))
        if self.lo_offset_hz or self.lo_drift_hz_per_s:
            t = np.arange(lo, hi) / self.sample_rate
            # drifting LO: phase = 2*pi*(f0*t + drift*t^2/2)
            ph = 2 * np.pi * (self.lo_offset_hz * t
                              + 0.5 * self.lo_drift_hz_per_s * t * t)
            x = x * np.exp(1j * ph)
        if self._noise is not None:
            x = x + self._noise[lo:hi]
        if self.iq_gain != 1.0 or self.iq_skew:
            i, q = np.real(x), np.imag(x)
            x = i + 1j * (q / self.iq_gain + self.iq_skew * i)
        if self.dc_offset:
            x = x + np.complex64(self.dc_offset)
        if self.adc_bits is not None:
            fs = self._ADC_FULL_SCALE
            q = (2 ** (self.adc_bits - 1) - 1) / fs
            x = (np.round(np.clip(np.real(x), -fs, fs) * q)
                 + 1j * np.round(np.clip(np.imag(x), -fs, fs) * q)) / q
        return x.astype(np.complex64)

    def apply(self, est: SignalEstimate) -> None:
        if est.change_frequency:
            # retune the LO: the offset seen at baseband shrinks; the
            # stream keeps running (phase-continuous, indexed by pos)
            self.lo_offset_hz -= est.coarse_freq_offset
            self.retunes += 1
        if est.change_gain:
            self.gain_db += est.gain_offset
            self.gain_steps += 1
        if est.reset:
            self.pos = 0


def _sdrplay_device(*a, **kw):
    from .vendor import SdrplayDevice
    return SdrplayDevice(*a, **kw)


def _airspy_device(*a, **kw):
    from .vendor import AirspyDevice
    return AirspyDevice(*a, **kw)


def _pluto_device(*a, **kw):
    from .vendor import PlutoDevice
    return PlutoDevice(*a, **kw)


DEVICES = {"file": FileDevice, "sim": SimulatedDevice,
           "sdrplay": _sdrplay_device, "airspy": _airspy_device,
           "plutosdr": _pluto_device}
# "network" (tcp://host:port, io/net.py) is the remote-radio path: the
# radio-side IQStreamServer wraps the vendor device where the USB bus is,
# the receive host runs NetworkDevice (registered lazily to avoid the
# import cycle)


def _network_device(*a, **kw):
    from .net import NetworkDevice
    return NetworkDevice(*a, **kw)


DEVICES["network"] = _network_device


@dataclass
class StreamStats:
    blocks: int = 0
    raw_samples: int = 0
    retune_requests: int = 0
    gain_steps: int = 0
    gain_db_applied: float = 0.0
    level_db: float = 0.0
    reacquisitions: int = 0
    overruns: int = 0
    frames_decoded: int = 0
    frames_skipped: int = 0
    ts_bytes: int = 0
    ts_packets: int = 0
    ts_errors: int = 0
    l1_failures: int = 0
    cfo_hz: float = 0.0           # total front-end frequency correction
    sco_ppm: float = 0.0          # total sample-clock correction
    dc_offset_est: complex = 0j   # smoothed DC estimate (DCIQCorrector)
    iq_gain_est: float = 1.0      # smoothed Q-branch amplitude ratio
    iq_skew_est: float = 0.0      # smoothed I->Q quadrature leak
    snr_db: list = field(default_factory=list)
    timing: list = field(default_factory=list)
    metrics: object = None        # utils.metrics.Metrics
    debug: dict | None = None     # one captured frame for stage plots
    frontend: str = ""            # corrector chain class actually used
    last_raw: object = None       # decimated latest raw block (live spectrum)


def _advance_grid(lock, start: int) -> None:
    """Advance the frame grid from the frame at `start` to the next one:
    nominal frame length plus any FEF part scheduled after this frame
    (clause 8.3.1 — the signalled FEF_LENGTH follows every
    FEF_INTERVAL-th T2-frame).  The predicted FRAME_IDX counter wraps at
    NUM_T2_FRAMES like the on-air field."""
    p = lock.params
    lock.frame_start = start + p.frame_samples + p.fef_after(lock.frame_idx)
    lock.frame_idx = (lock.frame_idx + 1) % max(lock.l1pre.num_t2_frames, 1)


class _DirectSource:
    """Synchronous block reader (no thread)."""

    def __init__(self, dev: SDRDevice, block_len: int):
        self.dev = dev
        self.block_len = block_len
        self.overruns = 0

    def read(self):
        return self.dev.read_block(self.block_len)

    def close(self):
        pass


class _RingSource:
    """Reader thread pushing device blocks into the native SPSC IQRing:
    the reference's elastic device-thread buffering (rx_sdrplay.cpp:230-279)
    with the try_lock/grow-blocks scheme replaced by the lock-free ring.
    The producer BLOCKS (bounded retry) when the consumer falls behind
    instead of dropping, mirroring the reference's wait-condition
    backpressure; `overruns` counts ring-full stalls."""

    def __init__(self, dev: SDRDevice, block_len: int, depth: int = 8):
        import threading
        from ..native import IQRing
        self.dev = dev
        self.block_len = block_len
        self.ring = IQRing(depth * block_len)
        self.overruns = 0
        self._eof = threading.Event()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _produce(self):
        import time as _time
        while not self._stop.is_set():
            blk = self.dev.read_block(self.block_len)
            if blk is None:
                break
            while len(blk) and not self._stop.is_set():
                took = self.ring.push(blk)
                if took < len(blk):
                    self.overruns += 1
                    _time.sleep(0.001)
                blk = blk[took:]
        self._eof.set()

    def read(self):
        import time as _time
        while True:
            got = self.ring.pop(self.block_len)
            if len(got):
                return got
            if self._eof.is_set():
                got = self.ring.pop(self.block_len)
                return got if len(got) else None
            _time.sleep(0.001)

    def flush(self):
        self.ring.flush()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2.0)
        if self._thread.is_alive():
            # a stalled vendor read may still hold the ring: leak it
            # rather than free memory under a live producer
            return
        self.ring.close()


class StreamingReceiver:
    """Continuously-running closed-loop receive.

    raw device blocks -> elastic ingest (optionally the native SPSC ring on
    a reader thread) -> phase/position-continuous correction
    (rx.frontend.CorrectorChain: CFO NCO + SCO resampler) -> persistent
    lock: acquisition runs once, then leftover samples and the full lock
    state (mode, L1, frame grid, CFO/SCO) carry across block boundaries, so
    frames straddling a block boundary decode — the property the
    reference's always-on pipeline has (rx_sdrplay.cpp:199-291) and a
    block-per-call design lacks.  Per frame the tracking loop measures the
    frame's own P1 (residual CFO -> PI frequency loop, whole-sample timing
    drift -> grid retiming, correlation quality -> lock detector), and the
    AGC loop estimates input level and steps hardware gain
    (dvbt2_demodulator.cpp:234-249, rx_sdrplay.cpp:179-197).  Lock loss
    (consecutive tracking failures) or a hardware retune re-enters
    acquisition, like the reference's reset state machine
    (dvbt2_demodulator.cpp:418-425)."""

    RETUNE_THRESHOLD_HZ = 20e3
    AGC_TARGET_DB = 0.0           # unit RMS at the corrector input
    AGC_DEADBAND_DB = 3.0
    AGC_MAX_STEP_DB = 12.0
    P1_QUALITY_MIN = 0.12
    P1_SEARCH = 32
    MAX_FAILS = 3
    SCO_LADDER = (40e-6, -40e-6, 100e-6, -100e-6, 180e-6, -180e-6)

    def __init__(self, device: SDRDevice, receiver=None,
                 block_seconds: float = 0.6, max_retunes: int = 3,
                 agc: bool = True, use_ring: bool = False,
                 checkpoint_path: str | None = None,
                 checkpoint_every: int = 64,
                 acq_seconds: float = 0.55):
        from ..rx.receiver import T2Receiver
        self.device = device
        self.receiver = receiver or T2Receiver()
        self.block_seconds = block_seconds
        self.max_retunes = max_retunes
        self.agc = agc
        self.use_ring = use_ring
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = checkpoint_every
        self.acq_seconds = acq_seconds

    def _acq_need(self) -> int:
        # default: P1 + >=2 frames of the largest mode (SCO measurement)
        return int(self.receiver.fs * self.acq_seconds)

    def run(self, ts_sink=None, max_blocks: int | None = None,
            resume: str | None = None,
            capture_debug: bool = False, on_block=None,
            control=None) -> StreamStats:
        """`on_block(st, lock, rxstats)`: per-block observer hook (the live
        dashboard, utils.live.LiveDashboard.update); counters in `st` are
        refreshed before each call.  `control`: an io.control.ControlServer
        polled between blocks — live PLP/TS-sink switching and STOP
        without losing lock (the reference's set_out path,
        bb_de_header.cpp:500-525)."""
        from ..rx import frontend, p1_detect as rxp1
        from ..rx import receiver as rxr
        from ..dvbt2 import bbframe
        from ..utils.loops import ExponentialAverager, PILoopFilter, PIState
        from ..utils.metrics import Metrics

        st = StreamStats()
        st.metrics = Metrics()
        dev = self.device
        dev.start()
        assembler = bbframe.TSAssembler()
        rxstats = rxr.ReceiverStats()
        fs = self.receiver.fs  # true elementary rate (bandwidth-dependent)
        block_len = max(4096, int(dev.sample_rate * self.block_seconds))
        chain = None
        if getattr(self.receiver, "wants_device_frontend", False):
            # the device receive path corrects samples on the receiver's
            # torch device (ops/frontend_device);
            # vendor rates ride a polyphase stage (AirSpy 35/32) or the
            # drift resampler (SdrPlay/Pluto +0.625%); anything else
            # falls back to the host chain
            from ..ops.frontend_device import (DeviceFrontendChain,
                                               UnsupportedRatio)
            try:
                chain = DeviceFrontendChain(in_rate=dev.sample_rate,
                                            out_rate=fs,
                                            block_len=block_len,
                                            device=self.receiver.device)
            except UnsupportedRatio as e:
                # only the refused ratio: any other error propagates
                logging.getLogger(__name__).warning(
                    "sample correction runs on the host: %s", e)
                chain = None
        if chain is None:
            chain = frontend.CorrectorChain(in_rate=dev.sample_rate,
                                            out_rate=fs)
        st.frontend = type(chain).__name__
        self.chain = chain      # the chain of the newest run, for callers
        base_ratio = chain.ratio
        resume_base = 0   # raw device samples consumed before this run
        if resume is not None:
            # seek BEFORE any reader thread starts pulling from the device
            resume_base = self._resume(resume, dev, chain, assembler, st)
        if self.use_ring:
            try:
                src = _RingSource(dev, block_len)
            except Exception:
                src = _DirectSource(dev, block_len)
        else:
            src = _DirectSource(dev, block_len)
        pending = np.zeros(0, np.complex64)
        lock = None
        retunes = 0
        pending_retune = 0.0
        total_retuned = 0.0
        emitted = 0          # packets already flushed to the sink
        consumed = 0         # corrected samples dropped by compaction
        lvl = ExponentialAverager(alpha=0.5)
        lvl_state = None
        cfo_pi = PILoopFilter(bandwidth=0.35)
        cfo_state = PIState()
        cfo_prev = 0.0
        last_ckpt_frames = 0
        eof = False

        def notify():
            if on_block is None:
                return
            st.ts_packets = len(assembler.packets)
            st.ts_errors = assembler.error_count()
            st.frames_decoded = rxstats.frames_decoded
            st.cfo_hz = chain.freq_hz + total_retuned
            st.sco_ppm = (chain.ratio / base_ratio - 1.0) * 1e6
            if chain.dciq is not None:
                st.dc_offset_est = chain.dciq.dc
                st.iq_gain_est = chain.dciq.g
                st.iq_skew_est = chain.dciq.c
            on_block(st, lock, rxstats)

        def flush_ts(final_flush: bool = False):
            nonlocal emitted
            # hold back each (sub-)assembler's newest packet: its NM
            # transport-error flag is only known once the NEXT packet's
            # CRC byte arrives, and a flushed copy could no longer be
            # amended (multi-PLP subs share the packets list)
            avail = (len(assembler.packets) if final_flush
                     else assembler.flush_safe_count())
            if ts_sink is not None and avail > emitted:
                ts_sink(np.concatenate(assembler.packets[emitted:avail]))
                emitted = avail

        def track_one(final: bool):
            """Track the next frame on the grid: P1 quality gate, whole-
            sample retiming, CFO PI update.  Returns the frame start, or
            None (skipped / insufficient samples / lock dead)."""
            nonlocal pending, cfo_state, cfo_prev
            p = lock.params
            fsamp = p.frame_samples
            margin = 0 if final else rxp1.P1_LEN + 64
            # at end of capture, a frame may fall a few samples short of
            # the buffer (e.g. the lock grid sits +1 from a channel delay);
            # admit it — the clamp below starts the FFT window early, which
            # the guard interval absorbs
            slack = self.P1_SEARCH if final else 0
            while lock.frame_start + fsamp + margin <= len(pending) + slack:
                start = lock.frame_start
                with st.metrics.stage("track"):
                    m = rxp1.measure_p1(pending, start,
                                        search=self.P1_SEARCH, fs=fs)
                if m is None or m.quality < self.P1_QUALITY_MIN:
                    lock.fail_streak += 1
                    st.frames_skipped += 1
                    _advance_grid(lock, start)
                    if lock.fail_streak >= self.MAX_FAILS:
                        return None
                    continue
                if m.offset:
                    # whole-sample grid drift measured against the frame's
                    # own P1 (the reference's timing loop actuation)
                    start += m.offset
                    lock.frame_start = start
                if start + fsamp + margin > len(pending):
                    if final and 0 <= len(pending) - fsamp \
                            and start - (len(pending) - fsamp) \
                            <= self.P1_SEARCH:
                        # capture ends a few samples short of the retimed
                        # grid: start the FFT window early — the guard
                        # interval absorbs it (cyclic-prefix tolerance)
                        start = len(pending) - fsamp
                    else:
                        return None
                cfo_state, out = cfo_pi.step(cfo_state, m.cfo_hz)
                df = out - cfo_prev
                if abs(df) > 0.5:
                    cfo_prev = out
                    seg = pending[start:]
                    n = np.arange(len(seg))
                    pending[start:] = (seg * np.exp(
                        -2j * np.pi * df * n / fs)
                    ).astype(np.complex64)
                    chain.add_frequency(df, len(pending) - start)
                return start
            return None

        def track_and_decode(final: bool):
            """Decode every complete frame in `pending`; returns True while
            the lock holds.  When the receiver exposes decode_frames_batch
            (DeviceT2Receiver), consecutive tracked frames are decoded as
            ONE F-frame superstep — the bench's MultiFramePath shape inside
            the streaming loop."""
            p = lock.params
            fsamp = p.frame_samples
            batch_n = getattr(self.receiver, "stream_batch", 0) \
                if hasattr(self.receiver, "decode_frames_batch") else 0
            while True:
                want = batch_n if batch_n >= 2 else 1
                # FEF parts lengthen the span a batch of frames occupies
                fef_extra = (0 if p.fef is None
                             else (want // max(p.fef[2], 1) + 1) * p.fef[1])
                if (want >= 2 and not final
                        and lock.frame_start + want * fsamp + fef_extra
                        + rxp1.P1_LEN + 64 > len(pending)):
                    # batch mode trades latency for the F-frame superstep:
                    # wait until a full batch of samples is buffered
                    return lock.fail_streak < self.MAX_FAILS
                starts = []
                while len(starts) < want:
                    fs_ = track_one(final)
                    if fs_ is None:
                        break
                    starts.append(fs_)
                    _advance_grid(lock, fs_)
                if not starts:
                    return lock.fail_streak < self.MAX_FAILS
                done = 0
                if len(starts) == want and want >= 2:
                    with st.metrics.stage("decode_batch",
                                          items=len(starts) * fsamp):
                        done = self.receiver.decode_frames_batch(
                            pending, starts, p, lock.plps, lock.l1pre,
                            assembler, rxstats)
                    if done:
                        fails = getattr(self.receiver,
                                        "last_batch_failures", 0)
                        if fails:
                            lock.fail_streak += fails
                            st.frames_skipped += fails
                            if lock.fail_streak >= self.MAX_FAILS:
                                return False
                        else:
                            lock.fail_streak = 0
                for fs_ in starts[done:]:
                    with st.metrics.stage("decode", items=fsamp):
                        ok = self.receiver._decode_frame(
                            pending, fs_, p, lock.plps, lock.l1pre, None,
                            assembler, rxstats)
                    if ok:
                        lock.fail_streak = 0
                    else:
                        lock.fail_streak += 1
                        st.frames_skipped += 1
                        if lock.fail_streak >= self.MAX_FAILS:
                            return False
                if lock.fail_streak >= self.MAX_FAILS:
                    return False

        while True:
            if control is not None:
                st.ts_packets = len(assembler.packets)
                st.frames_decoded = rxstats.frames_decoded
                control.publish(dict(
                    blocks=st.blocks, frames=st.frames_decoded,
                    ts_packets=st.ts_packets,
                    locked=lock is not None,
                    plp=self.receiver.plp_filter,
                    cfo_hz=chain.freq_hz + total_retuned,
                    snr_db=(float(np.mean(st.snr_db))
                            if st.snr_db else None)))
                if control.poll(self.receiver, flush_ts):
                    eof = True   # graceful STOP: drain, then exit
            limit = max_blocks is not None and st.blocks >= max_blocks
            raw = None if (limit or eof) else src.read()
            if raw is None:
                eof = True
            else:
                st.blocks += 1
                st.raw_samples += len(raw)
                # decimated tap of the latest RAW block for the live
                # spectrum pane (the reference's input spectrograph,
                # main_window.cpp:393-441); ~4k samples, cheap copy
                if len(raw):
                    st.last_raw = np.array(
                        raw[::max(1, len(raw) // 4096)][:4096])
                lvl_state = self._agc(raw, st, lvl, lvl_state)
                with st.metrics.stage("frontend", items=len(raw)):
                    out = chain.process(raw)
                pending = out if len(pending) == 0 \
                    else np.concatenate([pending, out])
            if lock is None:
                if len(pending) >= self._acq_need() \
                        or (eof and len(pending) > 8192):
                    with st.metrics.stage("acquire"):
                        lock, pending = self._try_lock(pending, chain, st)
                    if lock is not None:
                        st.snr_db.append(lock.snr_db)
                        cfo_state = PIState()
                        cfo_prev = 0.0
                        if capture_debug and st.debug is None:
                            fs0 = lock.frame_start
                            st.debug = dict(
                                frame=np.array(pending[
                                    fs0:fs0 + lock.params.frame_samples]),
                                params=lock.params, plps=lock.plps,
                                l1pre=lock.l1pre)
                        if (abs(chain.freq_hz) > self.RETUNE_THRESHOLD_HZ
                                and retunes < self.max_retunes):
                            pending_retune = chain.freq_hz
                    elif len(pending) > 2 * self._acq_need():
                        # still hunting: slide the window (unlocked samples
                        # are discarded, as in the reference's P1 hunt)
                        consumed += len(pending) - self._acq_need()
                        pending = pending[-self._acq_need():]
                if lock is None:
                    notify()
                    if eof:
                        break
                    continue
            alive = track_and_decode(final=eof)
            flush_ts()
            notify()
            # compact: keep a small lookback for the next P1 measurement.
            # NB frame_start may point BEYOND the buffered samples (a FEF
            # part separates this frame from the next, _advance_grid) —
            # clamp, or the slice below would silently drop the position
            keep_from = max(0, min(lock.frame_start, len(pending)) - 64)
            if keep_from:
                consumed += keep_from
                pending = pending[keep_from:]
                lock.frame_start -= keep_from
            if not alive:
                lock = None
                st.reacquisitions += 1
            elif pending_retune:
                # center the hardware LO on the digital correction
                # (rx_sdrplay.cpp:163-176); samples captured before the
                # retune are dropped and the lock re-acquires, like the
                # reference's reset-after-retune
                dev.apply(SignalEstimate(coarse_freq_offset=pending_retune,
                                         change_frequency=True))
                # drop every sample captured at the OLD LO (device ring +
                # reader-thread ring): an async front end can have a deep
                # backlog whose stale offset would trigger a double retune
                dev.flush()
                src_flush = getattr(src, "flush", None)
                if src_flush is not None:
                    src_flush()
                chain.add_frequency(-pending_retune, 0)
                total_retuned += pending_retune
                st.retune_requests += 1
                retunes += 1
                pending_retune = 0.0
                consumed += len(pending)
                pending = pending[:0]
                lock = None
            if (self.checkpoint_path and lock is not None
                    and rxstats.frames_decoded - last_ckpt_frames
                    >= self.checkpoint_every):
                self._checkpoint(consumed + lock.frame_start, chain,
                                 resume_base, assembler, rxstats)
                last_ckpt_frames = rxstats.frames_decoded
            if eof:
                break
        src.close()
        dev.stop()
        st.overruns = getattr(src, "overruns", 0)
        st.frames_decoded = rxstats.frames_decoded
        st.l1_failures = rxstats.l1_failures
        st.snr_db.extend(rxstats.snr_db)
        st.timing.extend(rxstats.timing_offset)
        st.ts_errors = assembler.error_count()
        st.ts_packets = len(assembler.packets)
        st.ts_bytes = len(assembler.packets) * 188
        st.cfo_hz = chain.freq_hz + total_retuned
        st.sco_ppm = (chain.ratio / base_ratio - 1.0) * 1e6
        if chain.dciq is not None:
            st.dc_offset_est = chain.dciq.dc
            st.iq_gain_est = chain.dciq.g
            st.iq_skew_est = chain.dciq.c
            st.metrics.gauge("dc_i", float(st.dc_offset_est.real))
            st.metrics.gauge("dc_q", float(st.dc_offset_est.imag))
            st.metrics.gauge("iq_gain", float(st.iq_gain_est))
            st.metrics.gauge("iq_skew", float(st.iq_skew_est))
        st.metrics.gauge("snr_db", float(np.mean(st.snr_db))
                         if st.snr_db else float("nan"))
        st.metrics.gauge("cfo_hz", st.cfo_hz)
        st.metrics.gauge("sco_ppm", st.sco_ppm)
        st.metrics.gauge("gain_db", st.gain_db_applied)
        flush_ts(final_flush=True)
        return st

    # -- AGC loop (level estimate -> hardware gain step) --------------------

    def _agc(self, raw, st, lvl, lvl_state):
        level = float(np.sqrt(np.mean(np.abs(raw) ** 2)))
        lvl_state, sm = lvl.step(lvl_state if lvl_state is not None
                                 else level, level)
        st.level_db = 20.0 * np.log10(max(abs(sm), 1e-12))
        if self.agc:
            err = self.AGC_TARGET_DB - st.level_db
            if abs(err) > self.AGC_DEADBAND_DB:
                step = float(np.clip(err, -self.AGC_MAX_STEP_DB,
                                     self.AGC_MAX_STEP_DB))
                self.device.apply(SignalEstimate(
                    gain_offset=step, change_gain=True,
                    signal_level=float(sm)))
                st.gain_steps += 1
                st.gain_db_applied += step
        return lvl_state

    # -- acquisition --------------------------------------------------------

    def _try_lock(self, pending, chain, st):
        """Acquire on the corrected pending buffer; applies measured CFO
        in place (phase-exact splice via CorrectorChain.add_frequency) and
        SCO via a rebased resampler stage, re-acquiring until residuals
        vanish.  Returns (LockState | None, pending)."""
        from ..rx import frontend

        ls = self.receiver.acquire(pending)
        if ls is None:
            # large sample-clock offsets break even hard-decision L1: walk
            # the trial ladder (receive()'s _sco_ladder, streaming form)
            for trial in self.SCO_LADDER:
                xr = frontend.sinc_resample(pending, 1.0 + trial)
                if len(xr) < 8192:
                    break
                if self.receiver.acquire(xr) is not None:
                    pending = chain.rebase_ratio(pending, 1.0 + trial)
                    ls = self.receiver.acquire(pending)
                    break
            if ls is None:
                return None, pending
        for _ in range(3):
            if abs(ls.cfo_hz) > 1e-3:
                n = np.arange(len(pending))
                pending = (pending * np.exp(
                    -2j * np.pi * ls.cfo_hz * n / self.receiver.fs)
                ).astype(np.complex64)
                chain.add_frequency(ls.cfo_hz, len(pending))
                ls.cfo_hz = 0.0
            if 2e-6 < abs(ls.sco) < 5e-3:
                pending = chain.rebase_ratio(pending, 1.0 + ls.sco)
                ls2 = self.receiver.acquire(pending)
                if ls2 is None:
                    return None, pending
                ls = ls2
                continue
            break
        return ls, pending

    # -- checkpoint/resume ---------------------------------------------------

    def _checkpoint(self, next_frame_abs, chain, resume_base, assembler,
                    rxstats):
        from ..utils.checkpoint import StreamCheckpoint
        # corrected-output index -> raw-device index: each output sample
        # consumed `chain.ratio` raw input samples; resume_base keeps the
        # offset absolute across resumed runs
        StreamCheckpoint(
            sample_offset=resume_base
            + int(round(next_frame_abs * chain.ratio)),
            cfo_hz=float(chain.freq_hz),
            sco_ppm=float((chain.ratio
                           / (self.device.sample_rate / self.receiver.fs)
                           - 1.0) * 1e6),
            ts_buf=[int(b) for b in assembler._buf],
            ts_prev_crc=assembler._prev_crc,
            ts_lost=bool(assembler._lost),
            frames_decoded=int(rxstats.frames_decoded),
            ts_packets=len(assembler.packets),
        ).save(self.checkpoint_path)

    def _resume(self, path, dev, chain, assembler, st):
        """Seek the device to the checkpointed frame boundary, restore the
        corrector and TS-reassembly state, and let acquisition re-lock at
        (exactly) the next undecoded frame, so the recovered TS continues
        the interrupted one without duplicate or lost packets."""
        from ..utils.checkpoint import StreamCheckpoint, restore_assembler
        ck = StreamCheckpoint.load(path)
        skip = ck.sample_offset
        if hasattr(dev, "pos"):
            dev.pos = skip
        else:
            left = skip
            while left > 0:
                blk = dev.read_block(min(left, 1 << 20))
                if blk is None or len(blk) == 0:
                    break
                left -= len(blk)
        if ck.cfo_hz:
            chain.add_frequency(ck.cfo_hz, 0)
        if abs(ck.sco_ppm) > 1e-3:
            if hasattr(chain, "stages"):     # host CorrectorChain
                chain.stages[0].ratio *= (1.0 + ck.sco_ppm * 1e-6)
                chain.stages[0]._resampling = True
            else:                            # DeviceFrontendChain
                # rebase (append a post-stage resampler), don't just bump
                # the reporting-only `ratio` attribute: process() resamples
                # at _fine_ratio + _post stages, so a bare `ratio *=` would
                # silently drop the checkpointed SCO correction and drift
                # the frame grid (~sco_ppm * frame_samples per frame)
                chain.rebase_ratio(np.zeros(0, np.complex64),
                                   1.0 + ck.sco_ppm * 1e-6)
        restore_assembler(ck, assembler)
        return int(ck.sample_offset)
