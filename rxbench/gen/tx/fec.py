"""TX FEC + mapping chain for one PLP: BB frame bits -> complex OFDM cells.

Chain per FEC frame (EN 302 755 clause 6):
  BB scramble -> BCH encode -> LDPC encode -> parity interleave ->
  bit interleave (column twist) + demux -> cell words -> constellation map ->
  rotation + cyclic Q-delay (if enabled)

Everything is vectorized over the batch of FEC frames with precomputed
permutations from `dvbt2.interleavers` (the TPU-first "tables as arrays"
stance -- the inverse of the reference's per-bit loops in llr_demapper.cpp /
ldpc_decoder.cpp).  This TX side is the framework's test-signal source and
runs in NumPy on host.
"""
from __future__ import annotations

import numpy as np

from ..dvbt2 import bbframe, bch, interleavers, ldpc, tables
from ..dvbt2.params import PLPParams


def fec_encode_bits(plp: PLPParams, bb_bits: np.ndarray) -> np.ndarray:
    """(n, kbch) unscrambled BB-frame bits -> (n, n_ldpc) interleaved
    codeword bits (v-stream order feeding the cell mapper)."""
    fec = plp.fec
    bb_bits = np.asarray(bb_bits, dtype=np.uint8).reshape(-1, fec.k_bch)
    scrambled = bbframe.scramble(bb_bits)
    bch_cw = bch.encode(plp.fec_frame, scrambled, fec.t_bch)
    code = ldpc.get_code(plp.fec_frame, plp.rate)
    cw = ldpc.encode(code, bch_cw)
    pperm = interleavers.parity_interleaver_perm(fec.n_ldpc, fec.k_ldpc,
                                                fec.q_ldpc)
    u = cw[:, pperm]
    addr = interleavers.bit_interleaver_perm(plp.constellation,
                                            plp.fec_frame, plp.rate)
    return u[:, addr]


def map_cells(plp: PLPParams, v_bits: np.ndarray) -> np.ndarray:
    """(n, n_ldpc) v-stream bits -> (n, cells_per_fec) complex cells with
    rotation + Q-delay applied when the PLP uses rotated constellations."""
    m = plp.bits_per_cell
    n = v_bits.shape[0]
    words = v_bits.reshape(n, -1, m)
    idx = np.zeros(words.shape[:2], dtype=np.int64)
    for b in range(m):
        idx = (idx << 1) | words[:, :, b]
    cells = tables.constellation_points(plp.constellation)[idx]
    if plp.rotated:
        phi = tables.ROTATION_ANGLE[plp.constellation]
        cells = cells * np.complex64(np.exp(1j * phi))
        # cyclic Q-delay within each FEC block (clause 6.3.2)
        q = np.roll(cells.imag, 1, axis=-1)
        cells = (cells.real + 1j * q).astype(np.complex64)
    return cells.astype(np.complex64)


def plp_encode(plp: PLPParams, bb_bits: np.ndarray) -> np.ndarray:
    """(n, kbch) BB frames -> (n, cells_per_fec) cells."""
    return map_cells(plp, fec_encode_bits(plp, bb_bits))
