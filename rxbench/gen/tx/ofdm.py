"""OFDM modulation: carrier vectors -> time-domain IQ, plus P1 generation.

P1 (clause 9.8, matching the reference detector's conventions in
p1_symbol.{h,cpp}): 384 DBPSK carriers (CDS tables) in a 1K FFT, C-A-B
structure with +1-carrier frequency shift on the guard copies:
  C = shifted A[0:542], placed before A; B = shifted A[542:1024], after A.

Data symbols: k_total carriers centered in the FFT (carrier k sits at
fft-shifted bin `left_nulls + k`, the inverse of the receiver's
`ofdm_cell = &fft[left_nulls]` convention), IFFT, cyclic-prefix GI.
"""
from __future__ import annotations

import functools

import numpy as np

from ..dvbt2 import tables
from ..dvbt2.params import (T2Params, FFTMode, Preamble, s2_field1_code)

P1_LEN = 2048
P1_A = 1024
P1_C = 542
P1_B = 482
P1_ACTIVE = 384
P1_FIRST_CARRIER = 86  # index of table carrier 0 in the shifted 1K spectrum

# CDS(256,32) active-carrier table (EN 302 755 clause 9.8.2.2; also
# p1_symbol.h:85-111)
P1_ACTIVE_CARRIERS = np.array([
    44, 45, 47, 51, 54, 59, 62, 64, 65, 66, 70, 75, 78, 80, 81, 82,
    84, 85, 87, 88, 89, 90, 94, 96, 97, 98, 102, 107, 110, 112, 113, 114,
    116, 117, 119, 120, 121, 122, 124, 125, 127, 131, 132, 133, 135, 136,
    137, 138, 142, 144, 145, 146, 148, 149, 151, 152, 153, 154, 158, 160,
    161, 162, 166, 171, 172, 173, 175, 179, 182, 187, 190, 192, 193, 194,
    198, 203, 206, 208, 209, 210, 212, 213, 215, 216, 217, 218, 222, 224,
    225, 226, 230, 235, 238, 240, 241, 242, 244, 245, 247, 248, 249, 250,
    252, 253, 255, 259, 260, 261, 263, 264, 265, 266, 270, 272, 273, 274,
    276, 277, 279, 280, 281, 282, 286, 288, 289, 290, 294, 299, 300, 301,
    303, 307, 310, 315, 318, 320, 321, 322, 326, 331, 334, 336, 337, 338,
    340, 341, 343, 344, 345, 346, 350, 352, 353, 354, 358, 363, 364, 365,
    367, 371, 374, 379, 382, 384, 385, 386, 390, 395, 396, 397, 399, 403,
    406, 411, 412, 413, 415, 419, 420, 421, 423, 424, 425, 426, 428, 429,
    431, 435, 438, 443, 446, 448, 449, 450, 454, 459, 462, 464, 465, 466,
    468, 469, 471, 472, 473, 474, 478, 480, 481, 482, 486, 491, 494, 496,
    497, 498, 500, 501, 503, 504, 505, 506, 508, 509, 511, 515, 516, 517,
    519, 520, 521, 522, 526, 528, 529, 530, 532, 533, 535, 536, 537, 538,
    542, 544, 545, 546, 550, 555, 558, 560, 561, 562, 564, 565, 567, 568,
    569, 570, 572, 573, 575, 579, 580, 581, 583, 584, 585, 586, 588, 589,
    591, 595, 598, 603, 604, 605, 607, 611, 612, 613, 615, 616, 617, 618,
    622, 624, 625, 626, 628, 629, 631, 632, 633, 634, 636, 637, 639, 643,
    644, 645, 647, 648, 649, 650, 654, 656, 657, 658, 660, 661, 663, 664,
    665, 666, 670, 672, 673, 674, 678, 683, 684, 689, 692, 696, 698, 699,
    701, 702, 703, 704, 706, 707, 708, 712, 714, 715, 717, 718, 719, 720,
    722, 723, 725, 726, 727, 729, 733, 734, 735, 736, 738, 739, 740, 744,
    746, 747, 748, 753, 756, 760, 762, 763, 765, 766, 767, 768, 770, 771,
    772, 776, 778, 779, 780, 785, 788, 792, 794, 795, 796, 801, 805, 806,
    807, 809], dtype=np.int64)
assert P1_ACTIVE_CARRIERS.shape[0] == P1_ACTIVE

# S1/S2 modulation signalling sequences (clause 9.8.2.3 tables 38/39; also
# p1_symbol.h:112-157)
S1_PATTERNS = [
    [0x12, 0x47, 0x21, 0x74, 0x1D, 0x48, 0x2E, 0x7B],
    [0x47, 0x12, 0x74, 0x21, 0x48, 0x1D, 0x7B, 0x2E],
    [0x21, 0x74, 0x12, 0x47, 0x2E, 0x7B, 0x1D, 0x48],
    [0x74, 0x21, 0x47, 0x12, 0x7B, 0x2E, 0x48, 0x1D],
    [0x1D, 0x48, 0x2E, 0x7B, 0x12, 0x47, 0x21, 0x74],
    [0x48, 0x1D, 0x7B, 0x2E, 0x47, 0x12, 0x74, 0x21],
    [0x2E, 0x7B, 0x1D, 0x48, 0x21, 0x74, 0x12, 0x47],
    [0x7B, 0x2E, 0x48, 0x1D, 0x74, 0x21, 0x47, 0x12],
]
S2_PATTERNS = [
    [0x12, 0x1D, 0x47, 0x48, 0x21, 0x2E, 0x74, 0x7B, 0x1D, 0x12, 0x48, 0x47,
     0x2E, 0x21, 0x7B, 0x74, 0x12, 0xE2, 0x47, 0xB7, 0x21, 0xD1, 0x74, 0x84,
     0x1D, 0xED, 0x48, 0xB8, 0x2E, 0xDE, 0x7B, 0x8B],
    [0x47, 0x48, 0x12, 0x1D, 0x74, 0x7B, 0x21, 0x2E, 0x48, 0x47, 0x1D, 0x12,
     0x7B, 0x74, 0x2E, 0x21, 0x47, 0xB7, 0x12, 0xE2, 0x74, 0x84, 0x21, 0xD1,
     0x48, 0xB8, 0x1D, 0xED, 0x7B, 0x8B, 0x2E, 0xDE],
    [0x21, 0x2E, 0x74, 0x7B, 0x12, 0x1D, 0x47, 0x48, 0x2E, 0x21, 0x7B, 0x74,
     0x1D, 0x12, 0x48, 0x47, 0x21, 0xD1, 0x74, 0x84, 0x12, 0xE2, 0x47, 0xB7,
     0x2E, 0xDE, 0x7B, 0x8B, 0x1D, 0xED, 0x48, 0xB8],
    [0x74, 0x7B, 0x21, 0x2E, 0x47, 0x48, 0x12, 0x1D, 0x7B, 0x74, 0x2E, 0x21,
     0x48, 0x47, 0x1D, 0x12, 0x74, 0x84, 0x21, 0xD1, 0x47, 0xB7, 0x12, 0xE2,
     0x7B, 0x8B, 0x2E, 0xDE, 0x48, 0xB8, 0x1D, 0xED],
    [0x1D, 0x12, 0x48, 0x47, 0x2E, 0x21, 0x7B, 0x74, 0x12, 0x1D, 0x47, 0x48,
     0x21, 0x2E, 0x74, 0x7B, 0x1D, 0xED, 0x48, 0xB8, 0x2E, 0xDE, 0x7B, 0x8B,
     0x12, 0xE2, 0x47, 0xB7, 0x21, 0xD1, 0x74, 0x84],
    [0x48, 0x47, 0x1D, 0x12, 0x7B, 0x74, 0x2E, 0x21, 0x47, 0x48, 0x12, 0x1D,
     0x74, 0x7B, 0x21, 0x2E, 0x48, 0xB8, 0x1D, 0xED, 0x7B, 0x8B, 0x2E, 0xDE,
     0x47, 0xB7, 0x12, 0xE2, 0x74, 0x84, 0x21, 0xD1],
    [0x2E, 0x21, 0x7B, 0x74, 0x1D, 0x12, 0x48, 0x47, 0x21, 0x2E, 0x74, 0x7B,
     0x12, 0x1D, 0x47, 0x48, 0x2E, 0xDE, 0x7B, 0x8B, 0x1D, 0xED, 0x48, 0xB8,
     0x21, 0xD1, 0x74, 0x84, 0x12, 0xE2, 0x47, 0xB7],
    [0x7B, 0x74, 0x2E, 0x21, 0x48, 0x47, 0x1D, 0x12, 0x74, 0x7B, 0x21, 0x2E,
     0x47, 0x48, 0x12, 0x1D, 0x7B, 0x8B, 0x2E, 0xDE, 0x48, 0xB8, 0x1D, 0xED,
     0x74, 0x84, 0x21, 0xD1, 0x47, 0xB7, 0x12, 0xE2],
    [0x12, 0xE2, 0x47, 0xB7, 0x21, 0xD1, 0x74, 0x84, 0x1D, 0xED, 0x48, 0xB8,
     0x2E, 0xDE, 0x7B, 0x8B, 0x12, 0x1D, 0x47, 0x48, 0x21, 0x2E, 0x74, 0x7B,
     0x1D, 0x12, 0x48, 0x47, 0x2E, 0x21, 0x7B, 0x74],
    [0x47, 0xB7, 0x12, 0xE2, 0x74, 0x84, 0x21, 0xD1, 0x48, 0xB8, 0x1D, 0xED,
     0x7B, 0x8B, 0x2E, 0xDE, 0x47, 0x48, 0x12, 0x1D, 0x74, 0x7B, 0x21, 0x2E,
     0x48, 0x47, 0x1D, 0x12, 0x7B, 0x74, 0x2E, 0x21],
    [0x21, 0xD1, 0x74, 0x84, 0x12, 0xE2, 0x47, 0xB7, 0x2E, 0xDE, 0x7B, 0x8B,
     0x1D, 0xED, 0x48, 0xB8, 0x21, 0x2E, 0x74, 0x7B, 0x12, 0x1D, 0x47, 0x48,
     0x2E, 0x21, 0x7B, 0x74, 0x1D, 0x12, 0x48, 0x47],
    [0x74, 0x84, 0x21, 0xD1, 0x47, 0xB7, 0x12, 0xE2, 0x7B, 0x8B, 0x2E, 0xDE,
     0x48, 0xB8, 0x1D, 0xED, 0x74, 0x7B, 0x21, 0x2E, 0x47, 0x48, 0x12, 0x1D,
     0x7B, 0x74, 0x2E, 0x21, 0x48, 0x47, 0x1D, 0x12],
    [0x1D, 0xED, 0x48, 0xB8, 0x2E, 0xDE, 0x7B, 0x8B, 0x12, 0xE2, 0x47, 0xB7,
     0x21, 0xD1, 0x74, 0x84, 0x1D, 0x12, 0x48, 0x47, 0x2E, 0x21, 0x7B, 0x74,
     0x12, 0x1D, 0x47, 0x48, 0x21, 0x2E, 0x74, 0x7B],
    [0x48, 0xB8, 0x1D, 0xED, 0x7B, 0x8B, 0x2E, 0xDE, 0x47, 0xB7, 0x12, 0xE2,
     0x74, 0x84, 0x21, 0xD1, 0x48, 0x47, 0x1D, 0x12, 0x7B, 0x74, 0x2E, 0x21,
     0x47, 0x48, 0x12, 0x1D, 0x74, 0x7B, 0x21, 0x2E],
    [0x2E, 0xDE, 0x7B, 0x8B, 0x1D, 0xED, 0x48, 0xB8, 0x21, 0xD1, 0x74, 0x84,
     0x12, 0xE2, 0x47, 0xB7, 0x2E, 0x21, 0x7B, 0x74, 0x1D, 0x12, 0x48, 0x47,
     0x21, 0x2E, 0x74, 0x7B, 0x12, 0x1D, 0x47, 0x48],
    [0x7B, 0x8B, 0x2E, 0xDE, 0x48, 0xB8, 0x1D, 0xED, 0x74, 0x84, 0x21, 0xD1,
     0x47, 0xB7, 0x12, 0xE2, 0x7B, 0x74, 0x2E, 0x21, 0x48, 0x47, 0x1D, 0x12,
     0x74, 0x7B, 0x21, 0x2E, 0x47, 0x48, 0x12, 0x1D],
]

# S2 field 1 coding lives in dvbt2.params (table 49: base + T2-Lite
# columns, profile-dependent)


@functools.lru_cache(maxsize=None)
def p1_randomize() -> np.ndarray:
    """P1 scrambling sequence as +-1 (PRBS seed 0x4E46, p1_symbol.cpp:44-53)."""
    out = np.empty(P1_ACTIVE, dtype=np.float64)
    sr = 0x4E46
    for i in range(P1_ACTIVE):
        b = (sr ^ (sr >> 1)) & 1
        out[i] = -1.0 if b else 1.0
        sr >>= 1
        if b:
            sr |= 0x4000
    return out


def p1_signalling_bits(s1: int, s2: int) -> np.ndarray:
    """384 signalling bits: CSS(S1) | CSS(S2) | CSS(S1)."""
    b1 = np.unpackbits(np.array(S1_PATTERNS[s1], dtype=np.uint8))
    b2 = np.unpackbits(np.array(S2_PATTERNS[s2], dtype=np.uint8))
    return np.concatenate([b1, b2, b1])


def generate_p1(p: T2Params) -> np.ndarray:
    """P1 preamble symbol: 2048 complex samples (C | A | B)."""
    s1 = {Preamble.T2_SISO: 0, Preamble.T2_MISO: 1, Preamble.NON_T2: 2,
          Preamble.T2_LITE_SISO: 3, Preamble.T2_LITE_MISO: 4}[p.preamble]
    fft_field = s2_field1_code(p.fft_mode, p.preamble)
    # S2 field2 = 1 when the preambles are of mixed types (FEF present)
    s2 = (fft_field << 1) | (1 if p.fef else 0)
    return p1_from_signalling(s1, s2)


def p1_from_signalling(s1: int, s2: int) -> np.ndarray:
    """P1 symbol from raw S1/S2 field values (also used for FEF-part P1s,
    whose S1 announces a non-T2 transmission)."""
    bits = p1_signalling_bits(s1, s2)
    # differential encode: d[-1]=+1, transition on bit=1; then scramble
    d = np.where(np.cumsum(bits) % 2 == 1, -1.0, 1.0)
    t = d * p1_randomize()
    # place on active carriers: shifted-spectrum index 86+carrier -> baseband
    spec = np.zeros(P1_A, dtype=np.complex64)
    shifted_bins = P1_FIRST_CARRIER + P1_ACTIVE_CARRIERS
    baseband = (shifted_bins - P1_A // 2) % P1_A
    spec[baseband] = t.astype(np.complex64)
    a = np.fft.ifft(spec) * np.sqrt(P1_A)
    # frequency-shifted guard copies: s[n] = a[n] * e^{+j 2 pi n / 1024}
    n = np.arange(P1_A)
    s = a * np.exp(2j * np.pi * n / P1_A)
    p1 = np.concatenate([s[:P1_C], a, s[P1_C:]])
    assert p1.shape[0] == P1_LEN
    return p1.astype(np.complex64)


def tr_positions(p: T2Params, l: int) -> np.ndarray:
    """Absolute carrier indices of the reserved PAPR tones of symbol l."""
    from ..dvbt2.params import PAPR
    if p.papr not in (PAPR.TR, PAPR.BOTH):
        return np.zeros(0, np.int64)
    if l < p.n_p2:
        m = tables.p2_carrier_map(p)
        return np.where(m == tables.P2_PAPR)[0]
    if p.has_fc and l == p.len_frame - 1:
        m = tables.fc_carrier_map(p)
        return np.where(m == tables.TR)[0]
    dy = tables.SP_PATTERN[p.pilot_pattern][1]
    m = tables.data_carrier_maps(p)[l % dy]
    return np.where(m == tables.TR)[0]


def tr_papr_reduce(p: T2Params, spec: np.ndarray, sym: np.ndarray,
                   symbol_indices: np.ndarray, target_db: float = 7.5,
                   max_iters: int = 20) -> np.ndarray:
    """Tone-reservation PAPR reduction (EN 302 755 clause 9.6.2).

    Iterative peak cancellation: the reserved carriers of each symbol form
    a frequency comb whose IFFT is a peaked kernel; each iteration finds
    the largest time-domain sample above the clipping level and subtracts
    a scaled, circularly-shifted kernel -- which by construction only adds
    energy on the reserved tones, so data/pilot cells are untouched and the
    receiver (which skips TR cells) is unaffected.  The reference receiver
    only *skips* reserved tones (pilot_generator.cpp:1962-2009); actually
    exercising them is transmit-side and beyond its scope.

    spec: (n_sym, fft) baseband spectra; sym: matching IFFT output
    (pre-scale, pre-GI).  Returns the corrected time-domain symbols.
    """
    n = p.fft_size
    shifted_of_k = ((np.arange(p.k_total) + p.left_nulls) - n // 2) % n
    kernels: dict = {}
    out = sym.copy()
    for row, l in enumerate(symbol_indices):
        trs = tr_positions(p, int(l))
        if len(trs) == 0:
            continue
        bins = shifted_of_k[trs]
        key = bins.tobytes()
        if key not in kernels:
            comb = np.zeros(n, np.complex128)
            comb[bins] = 1.0
            kern = np.fft.ifft(comb) * (n / len(bins))  # kern[0] == 1
            kernels[key] = kern
        kern = kernels[key]
        x = out[row].astype(np.complex128)
        rms = np.sqrt(np.mean(np.abs(x) ** 2))
        vclip = rms * 10.0 ** (target_db / 20.0)
        for _ in range(max_iters):
            m = int(np.argmax(np.abs(x)))
            pk = abs(x[m])
            if pk <= vclip:
                break
            alpha = (pk - vclip) * x[m] / pk
            x -= alpha * np.roll(kern, m)
        out[row] = x.astype(np.complex64)
    return out


def ace_papr_reduce(p: T2Params, spec: np.ndarray, sym: np.ndarray,
                    symbol_indices: np.ndarray, target_db: float = 6.5,
                    gain: float = 1.0, max_ext: float = 0.7,
                    iters: int = 4) -> np.ndarray:
    """Active Constellation Extension PAPR reduction (clause 9.6.1).

    Clip-and-filter with the extend-outward projection: clip the
    time-domain symbol, take the clipping error back to the frequency
    domain, and keep only the error components that push a cell's real or
    imaginary part further OUT in its own sign direction on cells already
    at the outer decision region -- the receiver's LLRs only improve for
    such moves.  Pilot/dummy/TR cells are never modified (their reference
    amplitudes are part of the channel estimate).

    Outer-region membership is decided against the per-symbol maximum
    component magnitude (exact for the uniform single-PLP symbols this
    modulator emits; conservative otherwise).  The extension is capped at
    `max_ext` of the nominal component.  Returns corrected time symbols.
    """
    n = p.fft_size
    shifted_of_k = ((np.arange(p.k_total) + p.left_nulls) - n // 2) % n

    def data_bins(l: int) -> np.ndarray:
        if l < p.n_p2:
            m = tables.p2_carrier_map(p)
        elif p.has_fc and l == p.len_frame - 1:
            m = tables.fc_carrier_map(p)
        else:
            dy = tables.SP_PATTERN[p.pilot_pattern][1]
            m = tables.data_carrier_maps(p)[l % dy]
        return shifted_of_k[np.nonzero(m == tables.DATA)[0]]

    out = sym.astype(np.complex128).copy()
    for row, l in enumerate(symbol_indices):
        x = out[row]
        x0 = spec[row]
        bins = data_bins(int(l))             # data cells only: pilots and
        if len(bins) == 0:                   # reserved tones stay exact
            continue
        re0, im0 = np.real(x0[bins]), np.imag(x0[bins])
        thr_r = 0.95 * np.max(np.abs(re0)) if np.max(np.abs(re0)) else 0.0
        thr_i = 0.95 * np.max(np.abs(im0)) if np.max(np.abs(im0)) else 0.0
        rms = np.sqrt(np.mean(np.abs(x) ** 2))
        vclip = rms * 10.0 ** (target_db / 20.0)
        for _ in range(iters):
            mag = np.abs(x)
            pk = float(mag.max())
            if pk <= vclip:
                break
            xc = np.where(mag > vclip, x * (vclip / np.maximum(mag, 1e-12)),
                          x)
            e = np.fft.fft(xc - x)           # clipping-error spectrum
            eb = e[bins]
            er, ei = np.real(eb), np.imag(eb)
            # extend-outward projection per component
            ok_r = (np.sign(er) == np.sign(re0)) & (np.abs(re0) >= thr_r)
            ok_i = (np.sign(ei) == np.sign(im0)) & (np.abs(im0) >= thr_i)
            ext_r = np.where(ok_r, np.clip(gain * er, -max_ext * np.abs(re0),
                                           max_ext * np.abs(re0)), 0.0)
            ext_i = np.where(ok_i, np.clip(gain * ei, -max_ext * np.abs(im0),
                                           max_ext * np.abs(im0)), 0.0)
            delta = np.zeros(n, np.complex128)
            delta[bins] = ext_r + 1j * ext_i
            x = x + np.fft.ifft(delta)
        out[row] = x
    return out.astype(np.complex64)


def ofdm_modulate(p: T2Params, carriers: np.ndarray,
                  first_symbol: int = 0) -> np.ndarray:
    """(n_sym, k_total) carrier vectors -> (n_sym, fft+guard) samples.

    Carrier k maps to fft-shifted bin left_nulls + k (the receiver reads
    `&fft_shifted[left_nulls]`, dvbt2_demodulator.cpp / data_symbol.cpp).
    When tone reservation is enabled (p.papr TR/BOTH) the reserved tones
    get the clause-9.6.2 peak-cancellation values.
    """
    from ..dvbt2.params import PAPR
    n_sym = carriers.shape[0]
    spec = np.zeros((n_sym, p.fft_size), dtype=np.complex64)
    shifted = np.arange(p.k_total) + p.left_nulls
    baseband = (shifted - p.fft_size // 2) % p.fft_size
    spec[:, baseband] = carriers
    sym = np.fft.ifft(spec, axis=1).astype(np.complex64)
    idx = np.arange(first_symbol, first_symbol + n_sym)
    if p.papr in (PAPR.ACE, PAPR.BOTH):
        sym = ace_papr_reduce(p, spec, sym, idx)
    if p.papr in (PAPR.TR, PAPR.BOTH):
        sym = tr_papr_reduce(p, spec, sym, idx)
    sym *= np.float32(p.fft_size / np.sqrt(p.k_total))
    g = p.guard_size
    return np.concatenate([sym[:, -g:], sym], axis=1)


def frame_to_samples(p: T2Params, carriers: np.ndarray) -> np.ndarray:
    """Full T2 frame: P1 + all OFDM symbols, flattened sample stream."""
    body = ofdm_modulate(p, carriers).reshape(-1)
    return np.concatenate([generate_p1(p), body])


def generate_fef_part(p: T2Params, rms: float, seed: int = 0) -> np.ndarray:
    """Future Extension Frame part (clause 8.4): its own P1 announcing a
    non-T2 transmission (S1=2, the value a T2 receiver's acquisition must
    skip), followed by arbitrary future-extension content — modelled as
    complex noise at the T2 frames' RMS so level/AGC loops see a
    continuous signal.  FEF_LENGTH counts elementary periods INCLUDING
    the P1.  The reference has no FEF support at all (SURVEY.md: FEF
    unsupported); real broadcasts use FEF parts to multiplex T2-Lite."""
    fef_type, fef_length, _ = p.fef
    if fef_length < P1_LEN:
        raise ValueError("FEF_LENGTH must cover at least the FEF P1")
    fft_field = s2_field1_code(p.fft_mode, p.preamble)
    p1 = p1_from_signalling(2, (fft_field << 1) | 1)
    rng = np.random.default_rng(0xFEF00 + seed)
    n = fef_length - P1_LEN
    filler = (rng.normal(0, rms / np.sqrt(2), n)
              + 1j * rng.normal(0, rms / np.sqrt(2), n))
    return np.concatenate([p1, filler]).astype(np.complex64)
