"""Sample-domain front end: device-rate int16 IQ -> corrected elementary-rate
complex baseband.

Capability parity with the reference's `dvbt2_demodulator.cpp:145-254` chain
(DC removal, 1-bit-quantization IQ-imbalance correction, NCO derotation,
Farrow resampling, FIR decimation), redesigned feed-forward for batch
processing (SURVEY.md §7 "two-phase receive"): estimates are computed over a
whole block and applied vectorized, instead of per-sample closed loops.

  - DC offset: block mean (the reference's exponential averager steady state,
    loop_filters.hh:56-73)
  - IQ imbalance: sign-based amplitude/orthogonality estimate, the same
    1-bit statistic the reference uses (dvbt2_demodulator.cpp:256-265)
  - CFO: supplied by P1 acquisition (rx.p1_detect), applied as one derotation
  - resampling: polyphase-evaluated cubic Farrow interpolator
    (interpolator_farrow.hh:41-68 redesigned as a vectorized kernel) for
    arbitrary device-rate -> 9.142857 Msps conversion, e.g. 9.2 Msps SdrPlay
    / PlutoSDR and 10 Msps AirSpy captures
  - FIR decimation: windowed-sinc low-pass + ":2" decimation for rates at
    ~2x the elementary rate (filter_decimator.h redesigned as one conv)
"""
from __future__ import annotations

import numpy as np

from ..dvbt2.params import SAMPLE_RATE

DEVICE_RATES = {
    "sdrplay": 9.2e6,
    "plutosdr": 9.2e6,
    "airspy": 10.0e6,
}


def int16_to_complex(i: np.ndarray, q: np.ndarray,
                     scale: float = 1.0 / 32768.0) -> np.ndarray:
    """Device int16 I/Q -> complex64 (rx_sdrplay/airspy deliver int16)."""
    return (i.astype(np.float32) + 1j * q.astype(np.float32)) * scale


def remove_dc(x: np.ndarray) -> tuple[np.ndarray, complex]:
    dc = complex(np.mean(x))
    return x - dc, dc


def estimate_iq_imbalance(x: np.ndarray) -> tuple[float, float]:
    """(amplitude ratio g, quadrature skew c) via the sign-based statistic
    the reference uses: E[|I|]/E[|Q|] and E[sign(I) * Q]."""
    i, q = np.real(x), np.imag(x)
    ei = float(np.mean(np.abs(i)))
    eq = float(np.mean(np.abs(q)))
    g = ei / max(eq, 1e-12)
    c = float(np.mean(np.sign(i) * q)) / max(ei, 1e-12)
    return g, c


def correct_iq_imbalance(x: np.ndarray, g: float, c: float) -> np.ndarray:
    """Restore Q' = g*Q ... and remove the I-correlated quadrature leak."""
    i, q = np.real(x), np.imag(x)
    q2 = (q * g - c * i) / np.sqrt(max(1.0 - c * c, 1e-6))
    return (i + 1j * q2).astype(np.complex64)


def derotate(x: np.ndarray, cfo_hz: float, fs: float = SAMPLE_RATE,
             phase0: float = 0.0) -> np.ndarray:
    n = np.arange(len(x))
    return (x * np.exp(-1j * (2 * np.pi * cfo_hz * n / fs + phase0))
            ).astype(np.complex64)


# --- Farrow cubic resampler (vectorized) ---

def farrow_resample(x: np.ndarray, ratio: float,
                    frac0: float = 0.0) -> np.ndarray:
    """Cubic Lagrange (Farrow) resampling: output rate = input rate / ratio.

    ratio = in_rate / out_rate (e.g. 9.2/9.142857 > 1 when decimating).
    Vectorized: output sample k interpolates x at position k*ratio + frac0
    with a 4-tap cubic kernel (same polynomial as interpolator_farrow.hh).
    """
    n_out = int((len(x) - 3) / ratio)
    t = np.arange(n_out) * ratio + frac0
    base = np.floor(t).astype(np.int64)
    mu = (t - base).astype(np.float32)
    # 4-tap cubic Lagrange on points x[base-1 .. base+2]
    xm1 = x[np.clip(base - 1, 0, len(x) - 1)]
    x0 = x[base]
    x1 = x[np.clip(base + 1, 0, len(x) - 1)]
    x2 = x[np.clip(base + 2, 0, len(x) - 1)]
    mu2 = mu * mu
    mu3 = mu2 * mu
    c0 = x0
    c1 = (x1 - xm1) * 0.5
    c2 = xm1 - 2.5 * x0 + 2.0 * x1 - 0.5 * x2
    c3 = 0.5 * (x2 - xm1) + 1.5 * (x0 - x1)
    return (c0 + c1 * mu + c2 * mu2 + c3 * mu3).astype(np.complex64)


def _sinc_interp(x: np.ndarray, pos0: float, ratio: float, n_out: int,
                 taps: int) -> np.ndarray:
    """Windowed-sinc interpolation core: output k reads x around position
    pos0 + k*ratio + taps/2 (so the first taps/2 samples are left context)."""
    half = taps // 2
    t = np.arange(n_out) * ratio + pos0 + half
    base = np.floor(t).astype(np.int64)
    mu = (t - base).astype(np.float64)
    out = np.zeros(n_out, dtype=np.complex128)
    k = np.arange(-half + 1, half + 1)  # taps offsets
    for kj in k:
        d = kj - mu
        w = np.sinc(d) * np.cos(np.pi * d / taps) ** 2  # cosine^2 window
        out += x[base + kj] * w
    return out.astype(np.complex64)


def sinc_resample(x: np.ndarray, ratio: float, taps: int = 24,
                  frac0: float = 0.0) -> np.ndarray:
    """High-quality arbitrary resampler: windowed-sinc interpolation.

    The cubic Farrow above matches the reference's interpolator but, like
    it, droops near the band edge -- DVB-T2 occupies ~83% of Nyquist and
    repeated cubic passes visibly damage edge carriers.  This kernel stays
    flat past 0.9 Nyquist; use it for sample-clock-offset correction where
    the signal is already at (nearly) the elementary rate (|ratio-1| small).
    """
    n_out = int((len(x) - taps) / ratio)
    return _sinc_interp(x, frac0, ratio, n_out, taps)


class DCIQCorrector:
    """Streaming DC-offset + IQ-imbalance stage: the reference applies both
    continuously per sample at the very front of its chain (DC via
    exponential averager, dvbt2_demodulator.cpp:187-188; 1-bit-statistic
    IQ-imbalance correction, dvbt2_demodulator.cpp:190-192, 256-265).  Here
    the same estimators run per block, exponentially averaged across blocks,
    and the smoothed correction is applied feed-forward — so a real SDR
    capture with a DC spike or 1-2% analog gain/quadrature imbalance is
    cleaned before the NCO mixes the I/Q axes.

    Must run at the head of the chain (before derotation/resampling): IQ
    imbalance is defined on the receiver's analog I/Q axes, which an NCO
    rotation would scramble."""

    def __init__(self, alpha: float = 0.25, min_g: float = 0.005,
                 min_c: float = 0.005):
        self.alpha = alpha
        self.min_g = min_g          # engage thresholds (estimator noise
        self.min_c = min_c          # floor on a clean stream)
        self.dc = 0.0 + 0.0j
        self.g = 1.0
        self.c = 0.0
        self._blocks = 0

    @property
    def active(self) -> bool:
        """True when the smoothed imbalance is material enough to correct."""
        return abs(self.g - 1.0) > self.min_g or abs(self.c) > self.min_c

    def process(self, block: np.ndarray) -> np.ndarray:
        if not len(block):
            return block
        w = self.alpha if self._blocks else 1.0
        self._blocks += 1
        self.dc = (1.0 - w) * self.dc + w * complex(np.mean(block))
        x = block - np.complex64(self.dc)
        g_b, c_b = estimate_iq_imbalance(x)
        self.g = (1.0 - w) * self.g + w * g_b
        self.c = (1.0 - w) * self.c + w * c_b
        if self.active:
            x = correct_iq_imbalance(x, self.g, self.c)
        return x.astype(np.complex64)


class StreamCorrector:
    """Phase/position-continuous per-block NCO + sample-clock corrector for
    the streaming receiver: the recorded-block feed-forward corrections of
    `T2Receiver.receive` restructured as a stateful stream operator, the
    framework's equivalent of the reference's always-running NCO + Farrow
    resampler (dvbt2_demodulator.cpp:194-221) whose loop inputs arrive
    between blocks instead of between samples.

      - resampling: windowed-sinc interpolation with a taps-length halo
        carried across blocks, so the fractional read position is continuous
        no matter where block boundaries fall;
      - NCO: derotation by the accumulated `freq_hz` with a running phase on
        the *output* sample index, so frequency updates never introduce a
        phase step inside a symbol.

    Feedback entry points: `add_frequency(df, applied_samples)` (CFO loop;
    `applied_samples` says how many recent output samples the caller already
    corrected in place, keeping the splice phase-exact) and `scale_ratio`
    (SCO loop).  Blocks already emitted are NOT retroactively fixed --
    callers may re-feed a pending buffer through `process` after changing
    settings; state stays continuous for subsequent blocks.
    """

    def __init__(self, fs: float = SAMPLE_RATE, taps: int = 24):
        self.fs = fs
        self.taps = taps
        self.freq_hz = 0.0
        self.ratio = 1.0                 # input samples per output sample
        self._dphi = 0.0                 # NCO phase step per output sample
        self._phase = 0.0                # NCO phase of the next output sample
        self._halo = np.zeros(0, np.complex64)
        self._pos = 0.0                  # fractional read position in halo
        self._resampling = False

    def add_frequency(self, df_hz: float, applied_samples: int = 0) -> None:
        """Steer the NCO by df.  When the caller has already derotated its
        last `applied_samples` output samples in place (indexed from that
        correction's own zero), advance the phase so the next output sample
        continues that ramp exactly."""
        self.freq_hz += df_hz
        self._dphi = 2.0 * np.pi * self.freq_hz / self.fs
        self._phase = float(np.mod(
            self._phase + 2.0 * np.pi * df_hz / self.fs * applied_samples,
            2.0 * np.pi))

    def scale_ratio(self, factor: float) -> None:
        """Multiply the resample ratio (e.g. 1 + sco)."""
        self.ratio *= factor
        if abs(self.ratio - 1.0) > 1e-12:
            self._resampling = True

    def process(self, block: np.ndarray) -> np.ndarray:
        """Correct one block; returns the output samples ready so far (the
        resampler holds back a taps-length tail until the next block)."""
        x = np.asarray(block, dtype=np.complex64)
        if self._resampling or len(self._halo):
            buf = np.concatenate([self._halo, x])
            n_out = int((len(buf) - self.taps - self._pos) / self.ratio)
            if n_out <= 0:
                self._halo = buf
                return np.zeros(0, np.complex64)
            y = _sinc_interp(buf, self._pos, self.ratio, n_out, self.taps)
            adv = self._pos + n_out * self.ratio
            drop = int(np.floor(adv))
            self._halo = buf[drop:]
            self._pos = adv - drop
        else:
            y = x
        if self.freq_hz or self._phase:
            ph = self._phase + self._dphi * np.arange(len(y))
            y = (y * np.exp(-1j * ph)).astype(np.complex64)
            self._phase = float(np.mod(self._phase + self._dphi * len(y),
                                       2.0 * np.pi))
        return y


class StreamDecimator:
    """Streaming anti-aliased /2 decimator: the block form of
    `fir_decimate` with the FIR history carried across blocks.

    The sinc interpolator in StreamCorrector has no low-pass, so ratios
    much above ~1.5 would alias out-of-band energy into the channel; the
    CorrectorChain prepends one of these per octave instead (a 9.2 Msps
    device feeding a 1.7 MHz channel needs two).  Exposes the stage
    interface the chain's accounting uses (`ratio`, `freq_hz`)."""

    def __init__(self, taps: np.ndarray | None = None):
        self.taps_arr = lowpass_taps() if taps is None else taps
        self.ratio = 2.0
        self.freq_hz = 0.0
        self._hist = np.zeros(0, np.complex64)

    def process(self, block: np.ndarray) -> np.ndarray:
        x = np.concatenate([self._hist,
                            np.asarray(block, dtype=np.complex64)])
        nt = len(self.taps_arr)
        if len(x) < nt + 1:
            self._hist = x
            return np.zeros(0, np.complex64)
        y = np.convolve(x, self.taps_arr, mode="valid")
        sel = y[::2].astype(np.complex64)
        # next output's first tap sits at x[2*len(sel)]: keep from there
        self._hist = x[2 * len(sel):]
        return sel


class CorrectorChain:
    """Composable StreamCorrector stages for the streaming receiver.

    Stage 0 owns device-rate -> elementary-rate conversion and the CFO NCO;
    re-lock SCO corrections append a stage whose resampler halo is seeded
    from the caller's pending buffer (`rebase_ratio`), so the corrected
    output stream is sample-exact across the correction splice — the
    streaming analogue of `T2Receiver.receive` resampling a whole recorded
    block and re-acquiring."""

    def __init__(self, in_rate: float = SAMPLE_RATE,
                 out_rate: float = SAMPLE_RATE, taps: int = 24,
                 dc_iq: bool = True):
        # per-octave anti-aliased decimation ahead of the interpolator: the
        # sinc interpolator has no low-pass, so large down-ratios (a wide
        # device rate feeding a narrow bandwidth's elementary rate) would
        # fold out-of-band energy into the channel (same split as the
        # one-shot device_to_elementary)
        self.pre: list[StreamDecimator] = []
        ratio = in_rate / out_rate
        while ratio >= 1.7:
            self.pre.append(StreamDecimator())
            ratio /= 2.0
        s = StreamCorrector(fs=out_rate, taps=taps)
        if abs(ratio - 1.0) > 1e-9:
            s.ratio = ratio
            s._resampling = True
        # DC/IQ-imbalance correction sits ahead of everything: it operates
        # on the device's analog I/Q axes (dvbt2_demodulator.cpp:187-192)
        self.dciq = DCIQCorrector() if dc_iq else None
        self.stages = [s]
        self.taps = taps
        self.fs = out_rate

    @property
    def freq_hz(self) -> float:
        return sum(s.freq_hz for s in self.stages)

    @property
    def ratio(self) -> float:
        r = 1.0
        for s in self.pre:
            r *= s.ratio
        for s in self.stages:
            r *= s.ratio
        return r

    def process(self, block: np.ndarray) -> np.ndarray:
        if self.dciq is not None:
            block = self.dciq.process(block)
        for d in self.pre:
            block = d.process(block)
        for s in self.stages:
            block = s.process(block)
        return block

    def add_frequency(self, df_hz: float, applied_samples: int = 0) -> None:
        self.stages[-1].add_frequency(df_hz, applied_samples)

    def rebase_ratio(self, pending: np.ndarray, factor: float) -> np.ndarray:
        """Append a resampler stage correcting a newly-measured SCO; returns
        `pending` resampled by it.  The new stage's halo is seeded with
        pending's tail at the exact fractional position, so the next
        `process` output continues the resampled stream seamlessly."""
        tail = StreamCorrector(fs=self.fs, taps=self.taps)
        tail.ratio = factor
        tail._resampling = True
        pending = np.asarray(pending, np.complex64)
        n_out = int((len(pending) - self.taps) / factor)
        if n_out <= 0:
            tail._halo = pending
            self.stages.append(tail)
            return np.zeros(0, np.complex64)
        out = _sinc_interp(pending, 0.0, factor, n_out, self.taps)
        adv = n_out * factor
        drop = int(np.floor(adv))
        tail._halo = pending[drop:]
        tail._pos = adv - drop
        self.stages.append(tail)
        return out


# --- FIR decimator ---

def lowpass_taps(n_taps: int = 64, cutoff: float = 0.25) -> np.ndarray:
    """Windowed-sinc low-pass (cutoff as fraction of input rate), matching
    the reference's 64-tap symmetric FIR role (filter_decimator.h)."""
    n = np.arange(n_taps) - (n_taps - 1) / 2.0
    h = np.sinc(2 * cutoff * n) * np.hamming(n_taps)
    return (h / h.sum()).astype(np.float32)


def fir_decimate(x: np.ndarray, factor: int = 2,
                 taps: np.ndarray | None = None) -> np.ndarray:
    taps = lowpass_taps() if taps is None else taps
    y = np.convolve(x, taps, mode="valid")
    return y[::factor].astype(np.complex64)


def device_to_elementary(x: np.ndarray, device_rate: float,
                         cfo_hz: float = 0.0,
                         target_rate: float = SAMPLE_RATE) -> np.ndarray:
    """Full front-end: device-rate complex in, elementary-rate out.
    `target_rate` is the bandwidth's elementary rate (params.Bandwidth;
    9.142857 Msps for 8 MHz channels)."""
    x, _ = remove_dc(x)
    g, c = estimate_iq_imbalance(x)
    # only correct when the imbalance is material (estimator noise floor)
    if abs(g - 1.0) > 0.01 or abs(c) > 0.01:
        x = correct_iq_imbalance(x, g, c)
    if cfo_hz:
        x = derotate(x, cfo_hz, fs=device_rate)
    # halve with a real low-pass until the residual ratio is small enough
    # for the unfiltered interpolator (narrow bandwidths need several
    # octaves: e.g. 9.2 Msps -> 1.845 Msps is /4 then x1.25).  Threshold
    # 1.7 (same as CorrectorChain): decimating at ratios in [1.5, 2)
    # would land the output rate BELOW the elementary rate, clipping the
    # ~0.42*fs occupied band edge (the LPF cutoff 0.25*1.7*fs = 0.425*fs
    # just clears it)
    while device_rate >= 1.7 * target_rate:
        x = fir_decimate(x, 2)
        device_rate = device_rate / 2.0
    if abs(device_rate - target_rate) > 1.0:
        x = farrow_resample(x, device_rate / target_rate)
    return x
