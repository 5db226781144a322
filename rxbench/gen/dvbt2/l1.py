"""L1 signalling (ETSI EN 302 755 clause 7): L1-pre / L1-post structures,
bit packing/parsing with CRC-32, and the L1 FEC chain (shortened BCH +
punctured short LDPC) with the L1-post bit interleaver and demux.

Field widths/order follow EN 302 755 tables 16-22 exactly as the reference
receiver parses them (`p2_symbol.cpp:301-531` for L1-pre,
`p2_symbol.cpp:670-1088` for L1-post incl. the configurable/dynamic offsets).

The RX entry points mirror the reference's strategy: hard decisions on the
equalized cells + CRC-32 gate (no L1 FEC decode, `p2_symbol.cpp:308-331`);
a soft decoder can be layered later since the full code structure is here.

Provenance of the shortening/puncturing tables (EN 302 755 V1.4.1):
- `L1POST_PAD_GROUPS` is the group-wise shortening order pi_S for the
  L1-post 16K rate-1/2 code, clause 7.3.1.2 Table 17.
- `L1PRE_PUNCT_GROUPS` is the group-wise puncturing order pi_P for the
  L1-pre 16K rate-1/4 code, clause 7.3.2.2 Table 18.
- `L1POST_PUNCT_GROUPS` is pi_P for the L1-post 16K rate-1/2 code,
  clause 7.3.2.2 Table 19.
- L1-pre shortening is tail-only (KSIG_PRE = 200 is fixed; the pad bits
  fill positions 200..KBCH-1), matching deployed modulators.
The group-order sequences are reconstructed from gr-dvbt2 and pinned
against a second copy of the literals in
tests/test_l1.py::test_l1_group_orders_match_standard_tables — that
pinning guards against divergence but is NOT an independent verification
of tables 17-19 (no EN 302 755 text is available in this environment).
The N_punc/N_post sizing IS derived from the clause 7.3.2.1/7.3.2.2
formulas directly (l1post_fec_geometry).  Pad/puncture placement only
affects the *parity* bits of L1 (never the systematic bits a
reference-style RX hard-parses), so TX<->RX loopback is exact
regardless; cross-vendor soft-decode interop rests on the second-hand
order lists.
"""
from __future__ import annotations

from dataclasses import dataclass, field as dfield

import numpy as np

from . import bbframe, bch, interleavers, ldpc
from . import params as params_mod
from .params import (CodeRate, Constellation, FECFrame, FFTMode, Preamble,
                     T2Params, fec_params)

CRC32_POLY = 0x04C11DB7
L1_PRE_CELLS = 1840
L1PRE_KSIG = 200

# C1_4 short (L1-pre): 36 parity groups of 360; puncture order.
L1PRE_PUNCT_GROUPS = [
    27, 13, 29, 32, 5, 0, 11, 21, 33, 20, 25, 28, 18, 35, 8, 3, 9, 31,
    22, 24, 7, 14, 17, 4, 2, 26, 16, 34, 19, 10, 12, 23, 1, 6, 30, 15]
L1PRE_N_PUNC = 11488  # fixed so that 200 + 168 + (12960 - N_punc) = 1840

# C1_2 short (L1-post): 25 parity groups of 360; puncture order.
L1POST_PUNCT_GROUPS = [
    6, 4, 18, 9, 13, 8, 15, 20, 5, 17, 2, 22, 24, 7, 12, 1, 16, 23, 14,
    0, 21, 10, 19, 11, 3]
# C1_2 short: 20 info-bit groups (7032 info bits); zero-pad order.
L1POST_PAD_GROUPS = [
    18, 17, 16, 15, 14, 13, 12, 11, 4, 10, 9, 8, 7, 3, 2, 1, 6, 5, 19, 0]

# L1-post modulation (L1_MOD field, table on p2_symbol.cpp:555-609)
L1_MOD_BITS = {0: 1, 1: 2, 2: 4, 3: 6}  # BPSK, QPSK, 16QAM, 64QAM
L1_MOD_CONSTELLATION = {1: None, 2: Constellation.QPSK,
                        4: Constellation.QAM16, 6: Constellation.QAM64}
# L1-post demux orders (dvbt2_definition.h:865-873): cell-word bit k comes
# from interleaved-stream position w + MUX[k]
MUX16 = [7, 1, 3, 5, 2, 4, 6, 0]
MUX64 = [11, 8, 5, 2, 10, 7, 4, 1, 9, 6, 3, 0]


def crc32_bits(bits: np.ndarray) -> int:
    """MPEG CRC-32 over a bit array (MSB-first, init 0xFFFFFFFF, no xorout);
    matches p2_symbol.cpp:308-314."""
    crc = 0xFFFFFFFF
    for b in np.asarray(bits, dtype=np.uint8):
        top = (crc >> 31) & 1
        crc = (crc << 1) & 0xFFFFFFFF
        if top ^ int(b):
            crc ^= CRC32_POLY
    return crc


def _put(bits: np.ndarray, pos: int, value: int, width: int) -> int:
    for i in range(width):
        bits[pos + i] = (value >> (width - 1 - i)) & 1
    return pos + width


def _get(bits: np.ndarray, pos: int, width: int) -> tuple[int, int]:
    v = 0
    for i in range(width):
        v = (v << 1) | int(bits[pos + i])
    return v, pos + width


# --------------------------------------------------------------------------
# L1-pre (table 16; parse parity: p2_symbol.cpp:334-489)
# --------------------------------------------------------------------------

_L1PRE_FIELDS = [  # (name, width)
    ("type", 8), ("bwt_ext", 1), ("s1", 3), ("s2_field1", 3), ("s2_field2", 1),
    ("l1_repetition_flag", 1), ("guard_interval", 3), ("papr", 4),
    ("l1_post_mod", 4), ("l1_cod", 2), ("l1_fec_type", 2),
    ("l1_post_size", 18), ("l1_post_info_size", 18), ("pilot_pattern", 4),
    ("tx_id_availability", 8), ("cell_id", 16), ("network_id", 16),
    ("t2_system_id", 16), ("num_t2_frames", 8), ("num_data_symbols", 12),
    ("regen_flag", 3), ("l1_post_extension", 1), ("num_rf", 3),
    ("current_rf_index", 3), ("t2_version", 4), ("l1_post_scrambled", 1),
    ("t2_base_lite", 1), ("reserved", 4),
]
assert sum(w for _, w in _L1PRE_FIELDS) == 168


@dataclass
class L1Pre:
    type: int = 0b00000000          # 00 = TS only
    bwt_ext: int = 1
    s1: int = 0                      # T2 SISO
    s2_field1: int = 0
    s2_field2: int = 0
    l1_repetition_flag: int = 0
    guard_interval: int = 4          # GI_1_128
    papr: int = 0
    l1_post_mod: int = 1             # QPSK
    l1_cod: int = 0                  # rate 1/2
    l1_fec_type: int = 0             # LDPC 16K
    l1_post_size: int = 0            # cells
    l1_post_info_size: int = 0       # bits (excl. CRC32)
    pilot_pattern: int = 6           # PP7
    tx_id_availability: int = 0
    cell_id: int = 0
    network_id: int = 0x3085
    t2_system_id: int = 0x8001
    num_t2_frames: int = 2
    num_data_symbols: int = 59
    regen_flag: int = 0
    l1_post_extension: int = 0
    num_rf: int = 1
    current_rf_index: int = 0
    t2_version: int = 0b0000
    l1_post_scrambled: int = 0
    t2_base_lite: int = 0
    reserved: int = 0

    def pack(self) -> np.ndarray:
        """-> 200 bits: the 168 signalling bits + CRC-32."""
        bits = np.zeros(200, dtype=np.uint8)
        pos = 0
        for name, width in _L1PRE_FIELDS:
            pos = _put(bits, pos, getattr(self, name), width)
        _put(bits, 168, crc32_bits(bits[:168]), 32)
        return bits

    @classmethod
    def unpack(cls, bits: np.ndarray) -> "L1Pre | None":
        """Parse 200 bits; None on CRC-32 failure (p2_symbol.cpp:326-331)."""
        bits = np.asarray(bits[:200], dtype=np.uint8)
        crc, _ = _get(bits, 168, 32)
        if crc != crc32_bits(bits[:168]):
            return None
        out = cls()
        pos = 0
        for name, width in _L1PRE_FIELDS:
            v, pos = _get(bits, pos, width)
            setattr(out, name, v)
        return out


# --------------------------------------------------------------------------
# L1-post (tables 19-22; offsets per p2_symbol.cpp:673-1088)
# --------------------------------------------------------------------------

@dataclass
class L1PostPLP:
    id: int = 0
    plp_type: int = 1                # 1 = data PLP type 1
    plp_payload_type: int = 0b00011  # TS
    ff_flag: int = 0
    first_rf_idx: int = 0
    first_frame_idx: int = 0
    plp_group_id: int = 0
    plp_cod: int = 2                 # C2_3
    plp_mod: int = 3                 # 256QAM
    plp_rotation: int = 1
    plp_fec_type: int = 1            # normal FEC frame
    plp_num_blocks_max: int = 8
    frame_interval: int = 1
    time_il_length: int = 3
    time_il_type: int = 0
    in_band_a_flag: int = 0
    in_band_b_flag: int = 0
    reserved_1: int = 0
    plp_mode: int = 0
    static_flag: int = 0
    static_padding_flag: int = 0


_L1POST_PLP_FIELDS = [
    ("id", 8), ("plp_type", 3), ("plp_payload_type", 5), ("ff_flag", 1),
    ("first_rf_idx", 3), ("first_frame_idx", 8), ("plp_group_id", 8),
    ("plp_cod", 3), ("plp_mod", 3), ("plp_rotation", 1), ("plp_fec_type", 2),
    ("plp_num_blocks_max", 10), ("frame_interval", 8), ("time_il_length", 8),
    ("time_il_type", 1), ("in_band_a_flag", 1), ("in_band_b_flag", 1),
    ("reserved_1", 11), ("plp_mode", 2), ("static_flag", 1),
    ("static_padding_flag", 1),
]
assert sum(w for _, w in _L1POST_PLP_FIELDS) == 89


@dataclass
class L1PostDynPLP:
    id: int = 0
    start: int = 0
    num_blocks: int = 0
    reserved_2: int = 0


@dataclass
class L1PostDynamic:
    frame_idx: int = 0
    sub_slice_interval: int = 0
    type_2_start: int = 0
    l1_change_counter: int = 0
    start_rf_idx: int = 0
    reserved_1: int = 0
    plp: list = dfield(default_factory=list)   # [L1PostDynPLP]
    reserved_3: int = 0
    aux_private_dyn: list = dfield(default_factory=list)  # [int 48-bit]

    def n_bits(self, num_plp: int, num_aux: int) -> int:
        return 71 + 48 * num_plp + 8 + 48 * num_aux

    def pack_into(self, bits, pos: int) -> int:
        pos = _put(bits, pos, self.frame_idx, 8)
        pos = _put(bits, pos, self.sub_slice_interval, 22)
        pos = _put(bits, pos, self.type_2_start, 22)
        pos = _put(bits, pos, self.l1_change_counter, 8)
        pos = _put(bits, pos, self.start_rf_idx, 3)
        pos = _put(bits, pos, self.reserved_1, 8)
        for p in self.plp:
            pos = _put(bits, pos, p.id, 8)
            pos = _put(bits, pos, p.start, 22)
            pos = _put(bits, pos, p.num_blocks, 10)
            pos = _put(bits, pos, p.reserved_2, 8)
        pos = _put(bits, pos, self.reserved_3, 8)
        for a in self.aux_private_dyn:
            pos = _put(bits, pos, a, 48)
        return pos

    @classmethod
    def unpack_from(cls, bits, pos: int, num_plp: int, num_aux: int):
        out = cls()
        out.frame_idx, pos = _get(bits, pos, 8)
        out.sub_slice_interval, pos = _get(bits, pos, 22)
        out.type_2_start, pos = _get(bits, pos, 22)
        out.l1_change_counter, pos = _get(bits, pos, 8)
        out.start_rf_idx, pos = _get(bits, pos, 3)
        out.reserved_1, pos = _get(bits, pos, 8)
        for _ in range(num_plp):
            p = L1PostDynPLP()
            p.id, pos = _get(bits, pos, 8)
            p.start, pos = _get(bits, pos, 22)
            p.num_blocks, pos = _get(bits, pos, 10)
            p.reserved_2, pos = _get(bits, pos, 8)
            out.plp.append(p)
        out.reserved_3, pos = _get(bits, pos, 8)
        for _ in range(num_aux):
            a, pos = _get(bits, pos, 48)
            out.aux_private_dyn.append(a)
        return out, pos


@dataclass
class L1Post:
    """L1-post configurable + one dynamic block (+ optional dyn_next)."""
    sub_slices_per_frame: int = 1
    num_plp: int = 1
    num_aux: int = 0
    aux_config_rfu: int = 0
    rf: list = dfield(default_factory=lambda: [(0, 0)])  # [(rf_idx, frequency)]
    fef: tuple | None = None          # (fef_type, fef_length, fef_interval)
    plp: list = dfield(default_factory=lambda: [L1PostPLP()])
    fef_length_msb: int = 0
    reserved_2: int = 0
    aux: list = dfield(default_factory=list)  # [(aux_stream_type, aux_private_config)]
    dyn: L1PostDynamic = dfield(default_factory=L1PostDynamic)
    dyn_next: L1PostDynamic | None = None

    def configurable_bits(self) -> int:
        return (35 + 35 * len(self.rf) + (34 if self.fef else 0)
                + 89 * len(self.plp) + 32 + 32 * len(self.aux))

    def info_bits(self, repetition: bool = False) -> int:
        dyn_n = self.dyn.n_bits(self.num_plp, self.num_aux)
        return self.configurable_bits() + dyn_n * (2 if repetition else 1)

    def pack(self, repetition: bool = False) -> np.ndarray:
        """-> (info_bits + 32) bits incl. CRC-32 over the info part."""
        n = self.info_bits(repetition)
        bits = np.zeros(n + 32, dtype=np.uint8)
        pos = 0
        pos = _put(bits, pos, self.sub_slices_per_frame, 15)
        pos = _put(bits, pos, self.num_plp, 8)
        pos = _put(bits, pos, self.num_aux, 4)
        pos = _put(bits, pos, self.aux_config_rfu, 8)
        for rf_idx, freq in self.rf:
            pos = _put(bits, pos, rf_idx, 3)
            pos = _put(bits, pos, freq, 32)
        if self.fef:
            pos = _put(bits, pos, self.fef[0], 4)
            pos = _put(bits, pos, self.fef[1], 22)
            pos = _put(bits, pos, self.fef[2], 8)
        for p in self.plp:
            for name, width in _L1POST_PLP_FIELDS:
                pos = _put(bits, pos, getattr(p, name), width)
        pos = _put(bits, pos, self.fef_length_msb, 2)
        pos = _put(bits, pos, self.reserved_2, 30)
        for stype, priv in self.aux:
            pos = _put(bits, pos, stype, 4)
            pos = _put(bits, pos, priv, 28)
        pos = self.dyn.pack_into(bits, pos)
        if repetition:
            assert self.dyn_next is not None
            pos = self.dyn_next.pack_into(bits, pos)
        assert pos == n
        _put(bits, pos, crc32_bits(bits[:n]), 32)
        return bits

    @classmethod
    def unpack(cls, bits: np.ndarray, num_rf: int, has_fef: bool,
               repetition: bool = False) -> "L1Post | None":
        """Parse; geometry (num_rf/fef) comes from L1-pre like the reference.
        Returns None on CRC-32 mismatch over the parsed length."""
        bits = np.asarray(bits, dtype=np.uint8)
        try:
            return cls._unpack_inner(bits, num_rf, has_fef, repetition)
        except IndexError:
            # corrupted counts (num_plp/num_aux) walked past the buffer --
            # equivalent failure to a CRC mismatch
            return None

    @classmethod
    def _unpack_inner(cls, bits, num_rf, has_fef, repetition):
        out = cls(rf=[], plp=[], aux=[])
        pos = 0
        out.sub_slices_per_frame, pos = _get(bits, pos, 15)
        out.num_plp, pos = _get(bits, pos, 8)
        out.num_aux, pos = _get(bits, pos, 4)
        out.aux_config_rfu, pos = _get(bits, pos, 8)
        for _ in range(num_rf):
            rf_idx, pos = _get(bits, pos, 3)
            freq, pos = _get(bits, pos, 32)
            out.rf.append((rf_idx, freq))
        if has_fef:
            ft, pos = _get(bits, pos, 4)
            fl, pos = _get(bits, pos, 22)
            fi, pos = _get(bits, pos, 8)
            out.fef = (ft, fl, fi)
        for _ in range(out.num_plp):
            p = L1PostPLP()
            for name, width in _L1POST_PLP_FIELDS:
                v, pos = _get(bits, pos, width)
                setattr(p, name, v)
            out.plp.append(p)
        out.fef_length_msb, pos = _get(bits, pos, 2)
        out.reserved_2, pos = _get(bits, pos, 30)
        for _ in range(out.num_aux):
            st, pos = _get(bits, pos, 4)
            pc, pos = _get(bits, pos, 28)
            out.aux.append((st, pc))
        out.dyn, pos = L1PostDynamic.unpack_from(
            bits, pos, out.num_plp, out.num_aux)
        if repetition:
            out.dyn_next, pos = L1PostDynamic.unpack_from(
                bits, pos, out.num_plp, out.num_aux)
        crc, _ = _get(bits, pos, 32)
        if crc != crc32_bits(bits[:pos]):
            return None
        return out


# --------------------------------------------------------------------------
# L1 FEC chain (clause 7.3.1/7.3.2)
# --------------------------------------------------------------------------

def _keep_indices_after_punct(n_parity_groups: int, order: list[int],
                              n_punc: int) -> np.ndarray:
    """Parity-bit keep mask (len n_groups*360) after puncturing ``n_punc``
    bits: whole groups in table order first, then the tail of the next
    group in order. Parity indexed in parity-interleaved (group-major)
    order."""
    keep = np.ones(n_parity_groups * 360, dtype=bool)
    full = n_punc // 360
    rem = n_punc % 360
    for g in order[:full]:
        keep[g * 360:(g + 1) * 360] = False
    if rem:
        g = order[full]
        keep[(g + 1) * 360 - rem:(g + 1) * 360] = False
    return keep


def _pad_positions(ksig: int, kbch: int, order: list[int]) -> np.ndarray:
    """Bool mask over kbch info bits: True = zero-pad position.  Whole groups
    in table order first; remainder pads the tail of the next group."""
    n_pad = kbch - ksig
    pad = np.zeros(kbch, dtype=bool)
    remaining = n_pad
    for g in order:
        lo = g * 360
        hi = min(lo + 360, kbch)  # last info group may be partial
        size = hi - lo
        if remaining >= size:
            pad[lo:hi] = True
            remaining -= size
        else:
            pad[hi - remaining:hi] = True  # pad the tail of this group
            remaining = 0
        if remaining == 0:
            break
    assert pad.sum() == n_pad
    return pad


def _l1_fec_encode(info: np.ndarray, frame_rate: CodeRate,
                   pad_order: list[int] | None,
                   punct_order: list[int], n_punc: int) -> np.ndarray:
    """Shortened-BCH + punctured-LDPC encode of one L1 block.

    Returns transmitted bits: [K_sig info][BCH parity][kept LDPC parity],
    parity in parity-interleaved order.
    """
    fec = fec_params(FECFrame.SHORT, frame_rate)
    ksig = len(info)
    padded = np.zeros(fec.k_bch, dtype=np.uint8)
    if pad_order is None:
        padded[:ksig] = info  # L1-pre: tail shortening
        pad_mask = np.zeros(fec.k_bch, dtype=bool)
        pad_mask[ksig:] = True
    else:
        pad_mask = _pad_positions(ksig, fec.k_bch, pad_order)
        padded[~pad_mask] = info
    bch_cw = bch.encode(FECFrame.SHORT, padded, fec.t_bch)
    code = ldpc.get_code(FECFrame.SHORT, frame_rate)
    cw = ldpc.encode(code, bch_cw)
    parity = cw[code.k:]
    # parity interleave: group-major order u[360t+s] = c[q s + t]
    q = code.q
    t = np.arange(q)[:, None]
    s = np.arange(360)[None, :]
    parity_il = parity[(q * s + t).reshape(-1)]
    keep = _keep_indices_after_punct(q, punct_order, n_punc)
    info_tx = bch_cw[:fec.k_bch][~pad_mask]
    return np.concatenate([info_tx, bch_cw[fec.k_bch:], parity_il[keep]])


def l1pre_encode(l1pre: L1Pre) -> np.ndarray:
    """L1-pre -> 1840 BPSK cells (complex64)."""
    bits = _l1_fec_encode(l1pre.pack(), CodeRate.C1_4, None,
                          L1PRE_PUNCT_GROUPS, L1PRE_N_PUNC)
    assert bits.shape[0] == L1_PRE_CELLS
    return (1.0 - 2.0 * bits.astype(np.float32)).astype(np.complex64)


def l1pre_decode_hard(cells: np.ndarray) -> L1Pre | None:
    """Hard-BPSK decode of the systematic 200 bits + CRC gate, exactly the
    reference's approach (p2_symbol.cpp:301-331)."""
    bits = (np.real(cells[:L1PRE_KSIG]) < 0).astype(np.uint8)
    return L1Pre.unpack(bits)


def l1post_fec_geometry(ksig: int, eta_mod: int) -> tuple[int, int]:
    """(N_post bits, N_punc) for an L1-post of ``ksig`` info+crc bits
    (clause 7.3.2.2 formulas)."""
    fec = fec_params(FECFrame.SHORT, CodeRate.C1_2)
    n_punc_temp = (6 * (fec.k_bch - ksig)) // 5
    n_post_temp = ksig + fec.bch_parity + (fec.n_ldpc - fec.k_ldpc) \
        - n_punc_temp
    quantum = 2 * eta_mod
    n_post = -(-n_post_temp // quantum) * quantum
    n_punc = n_punc_temp - (n_post - n_post_temp)
    return n_post, n_punc


def _l1post_interleave(bits: np.ndarray, eta_mod: int) -> np.ndarray:
    """L1-post bit interleaver (16/64QAM only): fill an (rows x cols) matrix
    column-wise, read row-wise (inverse of p2_symbol.cpp:636-643)."""
    if eta_mod not in (4, 6):
        return bits
    cols = 2 * eta_mod
    rows = len(bits) // cols
    return bits.reshape(cols, rows).T.reshape(-1)


def _l1post_deinterleave(bits: np.ndarray, eta_mod: int) -> np.ndarray:
    if eta_mod not in (4, 6):
        return bits
    cols = 2 * eta_mod
    rows = len(bits) // cols
    return bits.reshape(rows, cols).T.reshape(-1)


def _l1post_demux(bits: np.ndarray, eta_mod: int) -> np.ndarray:
    """Interleaved stream -> cell words.  Cell-word bit k (y_k) is
    interleaved[w + MUX[k]] per substream group (p2_symbol.cpp:620-633)."""
    if eta_mod == 4:
        mux = MUX16
    elif eta_mod == 6:
        mux = MUX64
    else:
        return bits
    sub = len(mux)
    grp = bits.reshape(-1, sub)
    return grp[:, mux].reshape(-1)


def _l1post_mux_inverse(bits: np.ndarray, eta_mod: int) -> np.ndarray:
    if eta_mod == 4:
        mux = np.array(MUX16)
    elif eta_mod == 6:
        mux = np.array(MUX64)
    else:
        return bits
    inv = np.empty_like(mux)
    inv[mux] = np.arange(len(mux))
    return bits.reshape(-1, len(mux))[:, inv].reshape(-1)


def _map_cells(bits: np.ndarray, eta_mod: int) -> np.ndarray:
    """Cell-word bit stream -> complex cells (y0 = MSB of the cell word)."""
    from .tables import constellation_points
    if eta_mod == 1:
        return (1.0 - 2.0 * bits.astype(np.float32)).astype(np.complex64)
    c = L1_MOD_CONSTELLATION[eta_mod]
    words = bits.reshape(-1, eta_mod)
    idx = np.zeros(len(words), dtype=np.int64)
    for b in range(eta_mod):
        idx = (idx << 1) | words[:, b]
    return constellation_points(c)[idx]


def _unmap_cells_hard(cells: np.ndarray, eta_mod: int) -> np.ndarray:
    """Hard demodulate cells -> y-bit stream (reference p2_symbol.cpp:593-633)."""
    if eta_mod == 1:
        return (np.real(cells) < 0).astype(np.uint8)
    re, im = np.real(cells), np.imag(cells)
    if eta_mod == 2:
        return np.stack([(re < 0), (im < 0)], axis=1).astype(np.uint8).reshape(-1)
    if eta_mod == 4:
        a4 = 2.0 / np.sqrt(10.0)
        return np.stack([
            re < 0, im < 0, np.abs(re) <= a4, np.abs(im) <= a4,
        ], axis=1).astype(np.uint8).reshape(-1)
    if eta_mod == 6:
        a2 = 2.0 / np.sqrt(42.0)
        a4 = 4.0 / np.sqrt(42.0)
        return np.stack([
            re < 0, im < 0, np.abs(re) <= a4, np.abs(im) <= a4,
            np.abs(np.abs(re) - a4) <= a2, np.abs(np.abs(im) - a4) <= a2,
        ], axis=1).astype(np.uint8).reshape(-1)
    raise ValueError(eta_mod)


def l1post_encode(l1post: L1Post, l1_post_mod: int,
                  repetition: bool = False,
                  scrambled: bool = False) -> np.ndarray:
    """L1-post -> complex cells (length = N_post / eta_mod)."""
    info = l1post.pack(repetition)
    eta = L1_MOD_BITS[l1_post_mod]
    n_post, n_punc = l1post_fec_geometry(len(info), eta)
    coded = _l1_fec_encode(info, CodeRate.C1_2, L1POST_PAD_GROUPS,
                           L1POST_PUNCT_GROUPS, n_punc)
    assert coded.shape[0] == n_post, (coded.shape, n_post)
    if scrambled:
        coded = coded ^ bbframe.bb_scrambler_sequence(n_post)
    interleaved = _l1post_interleave(coded, eta)
    cell_bits = _l1post_demux(interleaved, eta)
    return _map_cells(cell_bits, eta)


def _unmap_cells_llr(cells: np.ndarray, eta_mod: int,
                     nvar: float) -> np.ndarray:
    """Soft bit LLRs (positive = 0) for the L1-post modulations."""
    from .tables import constellation_points
    if eta_mod == 1:
        return (2.0 / nvar) * np.real(cells)
    c = L1_MOD_CONSTELLATION[eta_mod]
    pts = constellation_points(c)
    words = np.arange(len(pts))
    d2 = np.abs(cells[:, None] - pts[None, :]) ** 2
    out = np.empty((len(cells), eta_mod), dtype=np.float64)
    for b in range(eta_mod):
        bit = (words >> (eta_mod - 1 - b)) & 1
        d0 = d2[:, bit == 0].min(axis=1)
        d1 = d2[:, bit == 1].min(axis=1)
        out[:, b] = (d1 - d0) / max(nvar, 1e-9)
    return out.reshape(-1)


def l1post_decode_soft(cells: np.ndarray, l1pre: L1Pre,
                       nvar: float = 0.05,
                       iters: int = 30) -> L1Post | None:
    """Soft L1-post decode: exploit the shortened/punctured LDPC parity the
    reference throws away (it only hard-slices the systematic bits,
    p2_symbol.cpp:536-668).  Punctured parity positions get LLR 0, shortened
    info positions a large known-zero prior; after min-sum the systematic
    bits are re-parsed and CRC-gated as usual."""
    from . import ldpc as ldpcmod
    from .interleavers import parity_interleaver_perm
    eta = L1_MOD_BITS[l1pre.l1_post_mod]
    n_post = l1pre.l1_post_size * eta
    ksig = l1pre.l1_post_info_size + 32
    fec = fec_params(FECFrame.SHORT, CodeRate.C1_2)
    llr_v = _unmap_cells_llr(cells[:l1pre.l1_post_size], eta, nvar)
    interleaved = _l1post_mux_inverse_f(llr_v, eta)
    coded = _l1post_deinterleave_f(interleaved, eta)
    if l1pre.t2_version > 1 and l1pre.l1_post_scrambled:
        sgn = 1.0 - 2.0 * bbframe.bb_scrambler_sequence(n_post).astype(float)
        coded = coded * sgn
    # rebuild the full-codeword LLR vector
    pad_mask = _pad_positions(ksig, fec.k_bch, L1POST_PAD_GROUPS)
    n_punc = (fec.n_ldpc - fec.k_ldpc) * 0  # computed below
    _, n_punc = l1post_fec_geometry(ksig, eta)
    keep = _keep_indices_after_punct(fec.q_ldpc, L1POST_PUNCT_GROUPS, n_punc)
    big = 1e3
    full = np.zeros(fec.n_ldpc)
    info_llr = np.full(fec.k_bch, big)          # shortened zeros: strong 0
    info_llr[~pad_mask] = coded[:ksig]
    full[:fec.k_bch] = info_llr
    full[fec.k_bch:fec.k_ldpc] = coded[ksig:ksig + fec.bch_parity]
    parity_il = np.zeros(fec.n_ldpc - fec.k_ldpc)
    parity_il[keep] = coded[ksig + fec.bch_parity:]
    # undo the parity interleave (u[360t+s] = c[q s + t])
    q = fec.q_ldpc
    t = np.arange(q)[:, None]
    sidx = np.arange(360)[None, :]
    full[fec.k_ldpc + (q * sidx + t).reshape(-1)] = parity_il
    code = ldpcmod.get_code(FECFrame.SHORT, CodeRate.C1_2)
    hard, _ = ldpcmod.decode_minsum_np(code, full, iters=iters)
    info_bits = hard[:fec.k_bch][~pad_mask].astype(np.uint8)
    return L1Post.unpack(info_bits, num_rf=l1pre.num_rf,
                         has_fef=bool(l1pre.s2_field2),
                         repetition=bool(l1pre.l1_repetition_flag))


def _l1post_mux_inverse_f(vals: np.ndarray, eta_mod: int) -> np.ndarray:
    if eta_mod == 4:
        mux = np.array(MUX16)
    elif eta_mod == 6:
        mux = np.array(MUX64)
    else:
        return vals
    inv = np.empty_like(mux)
    inv[mux] = np.arange(len(mux))
    return vals.reshape(-1, len(mux))[:, inv].reshape(-1)


def _l1post_deinterleave_f(vals: np.ndarray, eta_mod: int) -> np.ndarray:
    if eta_mod not in (4, 6):
        return vals
    cols = 2 * eta_mod
    rows = len(vals) // cols
    return vals.reshape(rows, cols).T.reshape(-1)


def l1post_decode_hard(cells: np.ndarray, l1pre: L1Pre) -> L1Post | None:
    """Hard-decision L1-post parse from equalized cells, using L1-pre for
    geometry; CRC-32 gated (the reference's approach, p2_symbol.cpp:536-668)."""
    eta = L1_MOD_BITS[l1pre.l1_post_mod]
    n_post = l1pre.l1_post_size * eta
    y_bits = _unmap_cells_hard(cells[:l1pre.l1_post_size], eta)
    interleaved = _l1post_mux_inverse(y_bits, eta)
    coded = _l1post_deinterleave(interleaved, eta)
    if l1pre.t2_version > 1 and l1pre.l1_post_scrambled:
        coded = coded ^ bbframe.bb_scrambler_sequence(n_post)
    return L1Post.unpack(coded, num_rf=l1pre.num_rf,
                         has_fef=bool(l1pre.s2_field2),
                         repetition=bool(l1pre.l1_repetition_flag))


# --------------------------------------------------------------------------
# Builders: T2Params + PLP configs -> L1 structures
# --------------------------------------------------------------------------

def build_l1(p: T2Params, plps, num_frames: int = 2,
             l1_post_mod: int = 1,
             l1_repetition: bool = False) -> tuple[L1Pre, L1Post]:
    """Construct consistent L1-pre/L1-post for a single-RF T2 system.

    `plps`: list of PLPParams.  Dynamic fields (plp start / num_blocks) are
    zero here; the frame builder fills them per frame.  With
    `l1_repetition` the post size accounts for the doubled dynamic block
    (current frame + next frame, clause 7.2.3.1).
    """
    post_plps = []
    for cfg in plps:
        post_plps.append(L1PostPLP(
            id=cfg.plp_id, plp_cod=int(cfg.rate), plp_mod=int(cfg.constellation),
            plp_rotation=int(cfg.rotated), plp_fec_type=int(cfg.fec_frame),
            plp_type=cfg.plp_type,
            plp_num_blocks_max=cfg.num_blocks_max,
            frame_interval=cfg.frame_interval,
            time_il_length=cfg.time_il_length, time_il_type=cfg.time_il_type,
            first_frame_idx=cfg.first_frame_idx,
            in_band_a_flag=int(getattr(cfg, "in_band_a", 0))))
    dyn = L1PostDynamic(plp=[L1PostDynPLP(id=c.plp_id) for c in plps])
    post = L1Post(num_plp=len(plps), plp=post_plps,
                  sub_slices_per_frame=max(
                      [c.sub_slices for c in plps if c.plp_type == 2],
                      default=1),
                  dyn=dyn,
                  fef=(tuple(int(v) for v in p.fef) if p.fef else None))
    eta = L1_MOD_BITS[l1_post_mod]
    info_size = post.info_bits(repetition=l1_repetition)
    n_post, _ = l1post_fec_geometry(info_size + 32, eta)
    pre = L1Pre(
        l1_repetition_flag=int(l1_repetition),
        bwt_ext=int(p.extended_carrier),
        s2_field2=1 if p.fef else 0,
        # S1 mirrors the P1 field: T2-Lite profiles use 3 (SISO) / 4 (MISO)
        s1=((4 if p.miso else 3)
            if p.preamble in (Preamble.T2_LITE_SISO, Preamble.T2_LITE_MISO)
            else (1 if p.miso else 0)),
        # the table-49 coding is keyed by MODE and PROFILE (the T2GI
        # variants and the lite column have their own codes; a size-keyed
        # map would break P1<->L1 coherence and the T2-MI player's mode
        # reconstruction) — same function generate_p1 transmits
        s2_field1=params_mod.s2_field1_code(p.fft_mode, p.preamble),
        guard_interval=int(p.guard),
        papr=int(p.papr),
        l1_post_mod=l1_post_mod,
        l1_post_size=n_post // eta,
        l1_post_info_size=info_size,
        pilot_pattern=int(p.pilot_pattern),
        num_t2_frames=num_frames,
        num_data_symbols=p.n_data,
    )
    return pre, post
