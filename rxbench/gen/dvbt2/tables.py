"""Derived DVB-T2 constant tables: PRBS/PN sequences, pilot carrier maps and
pilot reference values — all precomputed as NumPy arrays.

TPU-first design stance (SURVEY.md par.7): the reference walks carriers with
per-sample switch statements at runtime (`pilot_generator.cpp`,
`p2_symbol.cpp:142-252`); here every map is built once per mode as an index /
value array so the on-device equalizer is a batched gather + lerp.

Parity with the reference implementation (behavioral, not line-by-line):
  - carrier PRBS:      pilot_generator.cpp:48-60
  - frame PN sequence: pilot_generator.cpp:61-66 (+ dvbt2_definition.h:346-369)
  - P2 carrier map:    pilot_generator.cpp:134-374
  - CP/SP/TR/FC maps:  pilot_generator.cpp:516-2091
  - pilot amplitudes:  pilot_generator.cpp:376-507
  - reference values:  pilot_generator.cpp:2093-2166
"""
from __future__ import annotations

import functools

import numpy as np

from . import _etsi_tables as ET
from .params import (PAPR, Constellation, FFTMode, PilotPattern, SP_AMPLITUDE,
                     SP_PATTERN, T2Params, cp_amplitude, p2_amplitude)

# carrier type codes (local enum; values are ours, not the reference's)
DATA = 0
P2 = 1
P2_INV = 2
P2_PAPR = 3
SP = 4
SP_INV = 5
CP = 6
CP_INV = 7
TR = 8

_P2_PAPR_MAP = {
    1024: ET.P2_PAPR_1K, 2048: ET.P2_PAPR_2K, 4096: ET.P2_PAPR_4K,
    8192: ET.P2_PAPR_8K, 16384: ET.P2_PAPR_16K, 32768: ET.P2_PAPR_32K,
}
_TR_PAPR_MAP = {
    1024: ET.TR_PAPR_1K, 2048: ET.TR_PAPR_2K, 4096: ET.TR_PAPR_4K,
    8192: ET.TR_PAPR_8K, 16384: ET.TR_PAPR_16K, 32768: ET.TR_PAPR_32K,
}
# (number of CP groups used, modulo applied to group entries) per fft_size
_CP_GROUPS_USED = {1024: (1, 1632), 2048: (2, 1632), 4096: (3, 3264),
                   8192: (4, 6528), 16384: (5, 13056), 32768: (6, None)}
_CP_EXTRA = {8192: ET.CP_EXTRA["8k"], 16384: ET.CP_EXTRA["16k"],
             32768: ET.CP_EXTRA["32k"]}


@functools.lru_cache(maxsize=None)
def prbs_sequence(length: int) -> np.ndarray:
    """Carrier-level PRBS w_k (clause 9.2.3.2.1): x^11 + x^2 + 1, seed all-ones.

    Returns uint8 bits; bit i scrambles carrier i (+ k_offset in normal mode).
    """
    out = np.empty(length, dtype=np.uint8)
    sr = 0x7FF
    for i in range(length):
        out[i] = sr & 1
        b = (sr ^ (sr >> 2)) & 1
        sr >>= 1
        if b:
            sr |= 0x400
    return out


@functools.lru_cache(maxsize=None)
def pn_sequence() -> np.ndarray:
    """Frame-level PN sequence (clause 9.2.3.2.2, table 36), 2624 bits."""
    packed = np.array(ET.PN_SEQUENCE_BYTES, dtype=np.uint8)
    return np.unpackbits(packed)


def _miso_inverted(k: np.ndarray, dx: int) -> np.ndarray:
    """MISO TX2 pilot inversion rule: invert where (k/dx) odd and k % dx == 0."""
    return ((k // dx) % 2 == 1) & (k % dx == 0)


@functools.lru_cache(maxsize=None)
def p2_carrier_map(p: T2Params) -> np.ndarray:
    """Carrier-type map of a P2 symbol (k_total entries)."""
    k_total, k_ext = p.k_total, p.k_ext
    m = np.full(k_total, DATA, dtype=np.int8)
    step = 6 if (p.fft_size == 32768 and not p.miso) else 3
    idx = np.arange(0, k_total, step)
    if p.miso and p.miso_group == 1:
        inv = ((idx // 3) % 2 == 1) & (idx % 3 == 0)
        m[idx] = np.where(inv, P2_INV, P2)
    else:
        m[idx] = P2
    if p.extended_carrier and k_ext:
        edges = np.concatenate([np.arange(k_ext),
                                np.arange(k_total - k_ext, k_total)])
        if p.miso and p.miso_group == 1:
            inv = ((edges // 3) % 2 == 1) & (edges % 3 == 0)
            m[edges] = np.where(inv, P2_INV, P2)
        else:
            m[edges] = P2
    if p.miso:
        m[[k_ext + 1, k_ext + 2, k_total - k_ext - 2, k_total - k_ext - 3]] = P2
    papr = np.array(_P2_PAPR_MAP[p.fft_size], dtype=np.int64)
    if p.fft_size >= 8192:
        papr = papr + k_ext
    m[papr] = P2_PAPR
    if p.miso:
        # re-open pilots adjacent to isolated PAPR carriers (clause 9.2.3.3)
        for i, ki in enumerate(papr):
            if ki % 3 == 1 and (i == len(papr) - 1 or ki + 1 != papr[i + 1]):
                m[ki + 1] = P2
            if ki % 3 == 2 and (i == 0 or ki - 1 != papr[i - 1]):
                m[ki - 1] = P2
    return m


@functools.lru_cache(maxsize=None)
def data_carrier_maps(p: T2Params) -> np.ndarray:
    """Carrier-type maps for data symbols, shape (dy, k_total).

    Row r is the map for any data symbol with absolute index l where
    l % dy == r.  (With TR-PAPR the reserved-tone shift also has period dy,
    so dy rows cover every data symbol.)
    """
    dx, dy = SP_PATTERN[p.pilot_pattern]
    k_total, k_ext = p.k_total, p.k_ext
    k = np.arange(k_total)
    maps = np.full((dy, k_total), DATA, dtype=np.int8)

    # continual pilots (same positions every symbol)
    ngroups, mod = _CP_GROUPS_USED[p.fft_size]
    cp_idx = []
    for g, vals in ET.CP_GROUPS[int(p.pilot_pattern) + 1].items():
        if g <= ngroups:
            v = np.array(vals, dtype=np.int64)
            cp_idx.append(v % mod if mod else v)
    extra = _CP_EXTRA.get(p.fft_size, {}).get(int(p.pilot_pattern) + 1)
    if extra:
        cp_idx.append(np.array(extra, dtype=np.int64))
    cp_idx = np.unique(np.concatenate(cp_idx)) if cp_idx else np.array([], np.int64)
    cp_idx = cp_idx[cp_idx < k_total]
    if p.miso and p.miso_group == 1:
        cp_inv = _miso_inverted(cp_idx, dx)
    else:
        cp_inv = np.zeros(len(cp_idx), dtype=bool)

    for row in range(dy):
        m = maps[row]
        m[cp_idx] = np.where(cp_inv, CP_INV, CP)
        # scattered pilots: (k - k_ext) mod (dx*dy) == dx * (l mod dy)
        rem = np.mod(k - k_ext, dx * dy)
        sp_mask = rem == dx * row
        if p.miso and p.miso_group == 1:
            inv = (k // dx) % 2 == 1
            m[sp_mask & ~inv] = SP
            m[sp_mask & inv] = SP_INV
        else:
            m[sp_mask] = SP
        # edge pilots
        if p.miso and p.miso_group == 1 and row % 2 == 1:
            m[0] = SP_INV
            m[k_total - 1] = SP_INV
        else:
            m[0] = SP
            m[k_total - 1] = SP
        # TR-PAPR reserved tones
        if p.papr in (PAPR.TR, PAPR.BOTH):
            if p.extended_carrier:
                shift = dx * ((row + k_ext // dx) % dy)
            else:
                shift = dx * row
            tr = np.array(_TR_PAPR_MAP[p.fft_size], dtype=np.int64) + shift
            m[tr] = TR
    return maps


@functools.lru_cache(maxsize=None)
def fc_carrier_map(p: T2Params) -> np.ndarray:
    """Carrier-type map of the frame-closing symbol."""
    dx, _ = SP_PATTERN[p.pilot_pattern]
    k_total, k_ext = p.k_total, p.k_ext
    k = np.arange(k_total)
    m = np.full(k_total, DATA, dtype=np.int8)
    sp_mask = k % dx == 0
    if p.miso and p.miso_group == 1:
        inv = (k // dx) % 2 == 1
        m[sp_mask & ~inv] = SP
        m[sp_mask & inv] = SP_INV
    else:
        m[sp_mask] = SP
    if p.fft_size == 1024 and p.pilot_pattern in (PilotPattern.PP4, PilotPattern.PP5):
        m[k_total - 2] = SP
    elif p.fft_size == 2048 and p.pilot_pattern == PilotPattern.PP7:
        m[k_total - 2] = SP
    if p.miso and p.miso_group == 1 and (p.len_frame - 1) % 2 == 1:
        m[0] = SP_INV
        m[k_total - 1] = SP_INV
    else:
        m[0] = SP
        m[k_total - 1] = SP
    if p.papr in (PAPR.TR, PAPR.BOTH):
        tr = np.array(_P2_PAPR_MAP[p.fft_size], dtype=np.int64)
        if p.fft_size >= 8192:
            tr = tr + k_ext
        m[tr] = TR
    return m


def _amplitudes(p: T2Params) -> np.ndarray:
    """Pilot amplitude per carrier-type code (index by map value)."""
    a = np.zeros(9, dtype=np.float32)
    a[P2] = a[P2_INV] = p2_amplitude(p.fft_size, p.miso)
    a[SP] = a[SP_INV] = SP_AMPLITUDE[p.pilot_pattern]
    a[CP] = a[CP_INV] = cp_amplitude(p.fft_size)
    return a


_INVERTED = np.zeros(9, dtype=bool)
_INVERTED[[P2_INV, SP_INV, CP_INV]] = True


def _refer_values(p: T2Params, cmap: np.ndarray, symbol_idx: int) -> np.ndarray:
    """Pilot reference value (signed amplitude) per carrier; 0 on non-pilots."""
    k_total = cmap.shape[0]
    prbs = prbs_sequence(k_total + p.k_offset)[p.k_offset:p.k_offset + k_total]
    pn = pn_sequence()[symbol_idx]
    amp = _amplitudes(p)[cmap]
    sign = 1.0 - 2.0 * (prbs ^ pn).astype(np.float32)
    sign = np.where(_INVERTED[cmap], -sign, sign)
    is_pilot = (cmap == P2) | (cmap == P2_INV) | (cmap == SP) | (cmap == SP_INV) \
        | (cmap == CP) | (cmap == CP_INV)
    return np.where(is_pilot, amp * sign, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def p2_pilot_refer(p: T2Params) -> np.ndarray:
    """P2 pilot reference values, shape (n_p2, k_total)."""
    cmap = p2_carrier_map(p)
    return np.stack([_refer_values(p, cmap, j) for j in range(p.n_p2)])


@functools.lru_cache(maxsize=None)
def data_pilot_refer(p: T2Params) -> np.ndarray:
    """Data-symbol pilot reference values, shape (n_data_plain, k_total).

    Row i corresponds to absolute symbol index n_p2 + i
    (data symbols only, frame-closing symbol excluded).
    """
    maps = data_carrier_maps(p)
    dy = maps.shape[0]
    n_plain = p.n_data - (1 if p.has_fc else 0)
    rows = []
    for i in range(n_plain):
        l = p.n_p2 + i
        rows.append(_refer_values(p, maps[l % dy], l))
    return np.stack(rows) if rows else np.zeros((0, p.k_total), np.float32)


@functools.lru_cache(maxsize=None)
def fc_pilot_refer(p: T2Params) -> np.ndarray:
    """Frame-closing symbol pilot reference values, shape (k_total,)."""
    cmap = fc_carrier_map(p)
    return _refer_values(p, cmap, p.len_frame - 1)


# --- constellation tables (clause 6.2.2) ---

def _gray_levels(m: int) -> np.ndarray:
    """Per-axis PAM levels indexed by the m/2 gray bits of that axis, matching
    the DVB-T2 bit-to-cell mapping (y0..y_{m-1} -> I uses even bits, Q odd)."""
    half = m // 2
    n = 1 << half
    levels = np.zeros(n, dtype=np.float32)
    # Explicit per-axis gray tables from EN 302 755 tables 9-11 (MSB first):
    if half == 1:
        tab = {0: 1, 1: -1}
    elif half == 2:
        tab = {0b00: 3, 0b01: 1, 0b10: -3, 0b11: -1}
    elif half == 3:
        tab = {0b000: 7, 0b001: 5, 0b010: 1, 0b011: 3,
               0b100: -7, 0b101: -5, 0b110: -1, 0b111: -3}
    elif half == 4:
        tab = {0b0000: 15, 0b0001: 13, 0b0010: 9, 0b0011: 11,
               0b0100: 1, 0b0101: 3, 0b0110: 7, 0b0111: 5,
               0b1000: -15, 0b1001: -13, 0b1010: -9, 0b1011: -11,
               0b1100: -1, 0b1101: -3, 0b1110: -7, 0b1111: -5}
    else:
        raise ValueError(half)
    for bits, lvl in tab.items():
        levels[bits] = lvl
    return levels


NORM_FACTOR = {
    Constellation.QPSK: 1.0 / np.sqrt(2.0),
    Constellation.QAM16: 1.0 / np.sqrt(10.0),
    Constellation.QAM64: 1.0 / np.sqrt(42.0),
    Constellation.QAM256: 1.0 / np.sqrt(170.0),
}

# rotated-constellation angles (clause 6.3, table 12), radians
ROTATION_ANGLE = {
    Constellation.QPSK: np.deg2rad(29.0),
    Constellation.QAM16: np.deg2rad(16.8),
    Constellation.QAM64: np.deg2rad(8.6),
    Constellation.QAM256: np.arctan(1.0 / 16.0),
}


@functools.lru_cache(maxsize=None)
def constellation_points(c: Constellation) -> np.ndarray:
    """Complex constellation indexed by the cell word (y0 = MSB), normalized."""
    m = c.bits_per_cell
    half = m // 2
    levels = _gray_levels(m)
    n = 1 << m
    pts = np.zeros(n, dtype=np.complex64)
    for w in range(n):
        # even bits (y0, y2, ...) -> real axis, odd bits -> imag axis
        re_bits = 0
        im_bits = 0
        for i in range(half):
            re_bits = (re_bits << 1) | ((w >> (m - 1 - 2 * i)) & 1)
            im_bits = (im_bits << 1) | ((w >> (m - 2 - 2 * i)) & 1)
        pts[w] = levels[re_bits] + 1j * levels[im_bits]
    return (pts * NORM_FACTOR[c]).astype(np.complex64)
