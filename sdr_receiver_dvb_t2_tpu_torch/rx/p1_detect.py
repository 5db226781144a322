"""P1 preamble detection and decoding (acquisition phase, host NumPy).

TPU-first redesign of the reference's streaming correlator
(`p1_symbol.cpp:92-172`): instead of a sample-serial delay-line state machine,
the whole search window is correlated at once with vectorized delay products
and cumulative-sum boxcar averages — same math, O(N) NumPy, no state.

Correlator (reference block diagram, p1_symbol.cpp:57-74):
  branch C: x[n] * conj(x[n+Tc] * shift)  averaged over Tb... (see below)
  branch B: x[n] * conj(x[n+...])        averaged and delayed
  correlation peak marks the P1; the angle of the peak gives the fractional
  CFO (P1_HERTZ_PER_RADIAN); integer CFO is found by sliding the first
  active carrier 76..96 in the 1K FFT of the A part (p1_symbol.cpp:117-126).

Decode: DBPSK over 384 CDS carriers, descramble, match S1/S2 signature
patterns, redundancy check data[i]==data[i+40] (p1_symbol.cpp:180-232).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..dvbt2.params import FFTMode, Preamble, SAMPLE_RATE
from ..tx.ofdm import (P1_A, P1_ACTIVE, P1_ACTIVE_CARRIERS, P1_B, P1_C,
                       P1_FIRST_CARRIER, P1_LEN, S1_PATTERNS, S2_PATTERNS,
                       p1_randomize)

_S1_TO_PREAMBLE = {0: Preamble.T2_SISO, 1: Preamble.T2_MISO,
                   2: Preamble.NON_T2, 3: Preamble.T2_LITE_SISO,
                   4: Preamble.T2_LITE_MISO}
# S2 field 1 -> FFT mode is PROFILE-dependent (table 49: the T2-Lite
# column reassigns code 3 to 16K with T2-GI guards and reserves the 32K
# codes — annex I has no 1K/32K); see dvbt2.params.fft_from_s2_field1


@dataclass
class P1Result:
    start: int                  # sample index of the P1 (start of C part)
    fractional_cfo_hz: float
    integer_cfo_carriers: int
    preamble: Preamble
    fft_mode: FFTMode
    s1: int
    s2: int
    s2_field2: int
    correlation: float


def _boxcar(x: np.ndarray, n: int) -> np.ndarray:
    """Running sum of the previous n samples (output[i] = sum x[i-n+1..i])."""
    c = np.cumsum(x, dtype=np.complex128)
    out = c.copy()
    out[n:] = c[n:] - c[:-n]
    return out


def p1_correlate(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized C-A-B correlation metric.

    Returns (metric magnitude, complex metric) arrays aligned so that a peak
    at index i marks a P1 whose C part starts near i - P1_LEN.

    The C part repeats in A after Tc=542 samples (with a +fSH shift); the
    A segment [542:1024] repeats in B after Tb=482 samples.  Products of
    x with the conjugated, delay-shifted stream collapse both repetitions
    into flat plateaus whose product peaks only where both align.
    """
    n = len(x)
    if n < 2 * P1_LEN:
        return np.zeros(0), np.zeros(0, np.complex128)
    shift = np.exp(-2j * np.pi * np.arange(n) / P1_A)
    xs = x * shift
    # C-branch: conj(x[i]) * xs[i+Tc]: matches when x[i] is in C and
    # x[i+542] is the corresponding A sample (A = C * e^{+j2pi fsh t} undone)
    pc = np.zeros(n, dtype=np.complex128)
    pc[:n - P1_C] = np.conj(x[:n - P1_C]) * (x * shift.conj())[P1_C:]
    # B-branch: conj(x[i]) * x_shifted[i+Tb]: matches when x[i] in A-tail,
    # x[i+482] the corresponding B sample
    pb = np.zeros(n, dtype=np.complex128)
    pb[:n - P1_B] = np.conj(x[:n - P1_B]) * xs[P1_B:]
    # average over the repetition support
    mc = _boxcar(pc, P1_C)      # plateau ends at end of C..A overlap
    mb = _boxcar(pb, P1_B)
    # align: C overlap covers samples [start .. start+542), its boxcar peak
    # sits at start+541; B overlap covers [start+1024 .. start+1566), peak at
    # start+1565.  Delay mc by (1566-542)=1024 to align peaks, then multiply.
    mc_d = np.zeros_like(mc)
    mc_d[P1_A:] = mc[:-P1_A]
    metric = mc_d * mb
    return np.abs(metric), metric


def decode_p1(x: np.ndarray, start: int, peak_metric: complex,
              fs: float = SAMPLE_RATE) -> P1Result | None:
    """Decode the P1 at `start` (start of C part).  `fs` is the true
    elementary rate (bandwidth-dependent) so reported CFOs are true Hz."""
    # fractional CFO from the correlation angle: the C branch contributes a
    # phase 2*pi*df*Tc*T, the B branch 2*pi*df*Tb*T -> total over
    # (Tc+Tb)=1024 sample delays, plus a deterministic structural offset of
    # 2*pi*542/1024 from the guard frequency shift (derivation in
    # p1_correlate's docstring conventions).
    struct = np.exp(-2j * np.pi * P1_C / P1_A)
    frac_cfo = float(np.angle(peak_metric * struct)) / (2 * np.pi) \
        * fs / P1_A
    # derotate the A part and FFT
    a = np.array(x[start + P1_C:start + P1_C + P1_A], dtype=np.complex128)
    n = np.arange(P1_A)
    a = a * np.exp(-2j * np.pi * frac_cfo * n / fs)
    spec = np.fft.fftshift(np.fft.fft(a) / np.sqrt(P1_A))
    # integer CFO: slide first-carrier index 76..96 (p1_symbol.cpp:117-126)
    best, best_pow = P1_FIRST_CARRIER, -1.0
    for first in range(76, 97):
        idx = first + P1_ACTIVE_CARRIERS
        pw = float(np.sum(np.abs(spec[idx]) ** 2))
        if pw > best_pow:
            best_pow, best = pw, first
    carriers = spec[best + P1_ACTIVE_CARRIERS]
    # DBPSK demod + descramble (p1_symbol.cpp:180-205)
    diff = carriers[1:] * np.conj(carriers[:-1])
    transitions = np.real(diff) < 0
    d = np.empty(P1_ACTIVE)
    d[0] = -1.0
    d[1:] = np.where(transitions, -1.0, 1.0)
    d = np.cumprod(d)
    d *= p1_randomize()
    bits = np.empty(P1_ACTIVE, dtype=np.uint8)
    bits[0] = 0 if d[0] > 0 else 1
    bits[1:] = (d[1:] * d[:-1]) < 0
    data = np.packbits(bits)
    if not np.array_equal(data[:8], data[40:48]):
        return None
    s1 = next((i for i, pat in enumerate(S1_PATTERNS)
               if data[0] == pat[0]), None)
    s2 = next((i for i, pat in enumerate(S2_PATTERNS)
               if data[8] == pat[0] and data[9] == pat[1]), None)
    if s1 is None or s2 is None or s1 not in _S1_TO_PREAMBLE:
        return None
    s2_field1 = s2 >> 1
    from ..dvbt2.params import fft_from_s2_field1
    fft_mode = fft_from_s2_field1(s2_field1, lite=s1 in (3, 4))
    if fft_mode is None:
        return None
    return P1Result(
        start=start, fractional_cfo_hz=frac_cfo,
        integer_cfo_carriers=best - P1_FIRST_CARRIER,
        preamble=_S1_TO_PREAMBLE[s1], fft_mode=fft_mode,
        s1=s1, s2=s2, s2_field2=s2 & 1, correlation=float(np.abs(peak_metric)))


@dataclass
class P1Measure:
    cfo_hz: float      # fractional CFO at this P1
    offset: int        # whole-sample timing error (actual - expected)
    quality: float     # normalized correlation (~1 clean, ~0 no P1)


def measure_p1(x: np.ndarray, start: int, search: int = 32,
               fs: float = SAMPLE_RATE) -> P1Measure | None:
    """Tracking-phase P1 measurement at a KNOWN frame grid position.

    Once locked, every frame starts with a P1 at a predicted index; this
    correlates only a 2*P1_LEN window around it and returns the residual
    fractional CFO (the per-frame input of the streaming CFO loop — the
    recorded-block analogue of the reference's frequency PI loop,
    dvbt2_demodulator.cpp:321-330), the whole-sample timing drift, and a
    power-normalized peak quality used as the lock detector (the
    reference's begin/end hysteresis, p1_symbol.cpp:92-172)."""
    lo = max(0, start - search - 4)
    hi = min(len(x), start + 2 * P1_LEN + search)
    seg = x[lo:hi]
    if len(seg) < 2 * P1_LEN:
        return None
    mag, metric = p1_correlate(seg)
    expect = (start - lo) + 1565
    w0, w1 = expect - search, expect + search + 1
    if w0 < 0 or w1 > len(mag):
        return None
    peak = w0 + int(np.argmax(mag[w0:w1]))
    pwr = float(np.mean(np.abs(seg[expect - 1565:expect + P1_B]) ** 2))
    norm = (pwr * P1_C) * (pwr * P1_B)
    quality = float(mag[peak]) / max(norm, 1e-30)
    struct = np.exp(-2j * np.pi * P1_C / P1_A)
    cfo = float(np.angle(metric[peak] * struct)) / (2 * np.pi) \
        * fs / P1_A
    return P1Measure(cfo_hz=cfo, offset=peak - expect, quality=quality)


def p1_candidate_peaks(mag: np.ndarray, threshold_ratio: float = 0.1,
                       max_candidates: int = 16) -> list[int]:
    """Plateau-clustered candidate peak indices, earliest first.

    A strong interference burst can out-correlate the real P1 (its boxcar
    metric is a random walk over 542 products), so a single global argmax
    is not robust -- return every plateau above threshold and let the
    decode gates (data[i]==data[i+40] redundancy + S1/S2 signature match,
    p1_symbol.cpp:217-232) reject the false ones."""
    gmax = float(mag.max()) if len(mag) else 0.0
    if gmax <= 0:
        return []
    above = np.nonzero(mag >= threshold_ratio * gmax)[0]
    peaks = []
    i = 0
    while i < len(above) and len(peaks) < max_candidates:
        j = i
        while j + 1 < len(above) and above[j + 1] - above[j] <= P1_LEN:
            j += 1
        seg0, seg1 = above[i], above[j]
        peaks.append(int(seg0 + np.argmax(mag[seg0:seg1 + 1])))
        i = j + 1
    return peaks


BASE_PREAMBLES = (Preamble.T2_SISO, Preamble.T2_MISO)
LITE_PREAMBLES = (Preamble.T2_LITE_SISO, Preamble.T2_LITE_MISO)


def acquire_p1(x: np.ndarray,
               accept: tuple = BASE_PREAMBLES,
               fs: float = SAMPLE_RATE) -> P1Result | None:
    """Search + decode; robust to interference bursts.

    Tries candidate plateaus earliest-first; when none decodes, the tried
    plateaus are suppressed and the scan repeats (a burst of interference
    can out-correlate every real P1, so thresholding against the global
    maximum alone would never see them).  This is the recorded-block form
    of the reference's continuous P1 hunt with begin/end hysteresis
    (p1_symbol.cpp:92-172).

    `accept` selects which preamble types are OURS: base-profile
    receivers lock on T2 P1s and skip T2-Lite/FEF ones, a lite-profile
    receiver (`accept=LITE_PREAMBLES`) does the reverse — that is how a
    T2-Lite service multiplexed into the FEF parts of a base T2 signal
    is selected (clause 8.4; no reference equivalent)."""
    mag, metric = p1_correlate(x)
    if len(mag) == 0:
        return None
    mag = mag.copy()
    for _ in range(8):
        peaks = p1_candidate_peaks(mag)
        if not peaks:
            return None
        for peak in peaks:
            start = peak - 1565
            if -256 <= start < 0:
                # resampling can shift the first P1 a bit before the buffer
                # start; the differential P1 decode tolerates starting late
                # (the C-A correlation plateau is 542 samples wide) and the
                # receiver's per-frame retiming absorbs the grid bias
                start = 0
            if start < 0 or start + P1_LEN > len(x):
                continue
            res = decode_p1(x, start, metric[peak], fs=fs)
            if res is not None:
                if res.preamble not in accept:
                    # a decodable P1 of a preamble type this receiver is
                    # not selecting: a FEF part, the other profile of a
                    # base+lite multiplex, or a neighbouring signal.
                    # Not ours — keep scanning (its plateau is suppressed
                    # with the other failures below)
                    continue
                return res
        for peak in peaks:
            mag[max(0, peak - 2 * P1_LEN):peak + 2 * P1_LEN] = 0.0
    return None
