"""T2 frame builder: FEC-block cells -> per-symbol carrier vectors.

Responsibilities (EN 302 755 clauses 6.4/6.5/8/9):
  - cell interleaver per FEC block (LFSR perm + per-block shift, restart
    each TI block -- matching time_deinterleaver.cpp:316-334 semantics)
  - time interleaver: column-wise write / row-wise read per TI block, with
    the reference's floor/remainder split of FEC blocks over N_TI blocks
    (time_deinterleaver.cpp:276-283)
  - frame cell stream: [L1-pre][L1-post][PLP slices][dummy cells] across
    P2 + data + FC symbols (addressing: PLP_START counts from the first
    post-L1 cell, time_deinterleaver.cpp:299-305)
  - frequency interleaver per symbol with the reference's parity convention
  - pilot insertion (P2 / data / FC maps + reference values from
    dvbt2.tables), TR-PAPR carriers left at zero
"""
from __future__ import annotations

import numpy as np

from ..dvbt2 import bbframe, interleavers, tables
from ..dvbt2.params import PLPParams, T2Params


def ti_blocks_split(num_blocks: int, n_ti: int) -> list[int]:
    """FEC blocks per TI block: first blocks get floor, the last
    (num_blocks % n_ti) get one extra (time_deinterleaver.cpp:276-283)."""
    base = num_blocks // n_ti
    rem = num_blocks % n_ti
    return [base + (1 if j >= n_ti - rem else 0) for j in range(n_ti)]


def interleave_plp_frame(plp: PLPParams, cells: np.ndarray) -> np.ndarray:
    """Cell+time interleave one frame's FEC blocks of one PLP.

    cells: (num_blocks, cells_per_fec) rotated/mapped cells.
    Returns the PLP's cell slice for the frame (num_blocks*cells_per_fec,).
    """
    num_blocks, cpf = cells.shape
    n_ti = max(1, plp.time_il_length if plp.time_il_type == 0 else 1)
    out = []
    idx = 0
    for nb in ti_blocks_split(num_blocks, n_ti):
        if nb == 0:
            continue
        blk = cells[idx:idx + nb]
        idx += nb
        # cell interleaver: shift counter restarts per TI block
        perm = interleavers.cell_interleaver_perm(cpf, nb)
        inter = np.empty_like(blk)
        np.put_along_axis(inter, perm, blk, axis=1)
        # time interleaver: column-major write, row-major read
        order = interleavers.time_interleaver_perm(cpf, nb)
        out.append(inter.reshape(-1)[order])
    assert idx == num_blocks
    return np.concatenate(out) if out else np.zeros(0, np.complex64)


def layout_plp_slices(plps, slices):
    """Order the per-PLP cell slices inside the frame (clause 8.3.6):
    type-1 PLPs first as contiguous slices, then type-2 PLPs interleaved
    round-robin in SUB_SLICES rounds (the reference's multi-PLP slice
    switching, time_deinterleaver.cpp:354-366, consumes this layout).

    Returns (parts in frame order, {plp_id: start_cell},
             sub_slice_interval, type_2_start)."""
    t1 = [(c, s) for c, s in zip(plps, slices) if c.plp_type != 2]
    t2 = [(c, s) for c, s in zip(plps, slices) if c.plp_type == 2]
    parts: list[np.ndarray] = []
    starts: dict[int, int] = {}
    pos = 0
    for c, s in t1:
        starts[c.plp_id] = pos
        parts.append(s)
        pos += len(s)
    type_2_start = pos
    interval = 0
    if t2:
        nss = t2[0][0].sub_slices
        if any(c.sub_slices != nss for c, _ in t2):
            raise ValueError("type-2 PLPs must share SUB_SLICES_PER_FRAME")
        lens = []
        for c, s in t2:
            if len(s) % nss:
                raise ValueError(
                    f"PLP {c.plp_id}: {len(s)} cells not divisible into "
                    f"{nss} sub-slices")
            lens.append(len(s) // nss)
        interval = sum(lens)
        off = 0
        for (c, s), ln in zip(t2, lens):
            starts[c.plp_id] = pos + off
            off += ln
        for r in range(nss):
            for (c, s), ln in zip(t2, lens):
                parts.append(s[r * ln:(r + 1) * ln])
    return parts, starts, interval, type_2_start


def dummy_cells(n: int) -> np.ndarray:
    """BPSK-modulated BB-PRBS filler for unallocated cells (clause 8.3.6)."""
    if n <= 0:
        return np.zeros(0, np.complex64)
    seq = bbframe.bb_scrambler_sequence(((n + bbframe.MAX_KBCH - 1)
                                         // bbframe.MAX_KBCH) * bbframe.MAX_KBCH)
    bits = np.resize(seq, n)
    return (1.0 - 2.0 * bits.astype(np.float32)).astype(np.complex64)


def build_frame_cells(p: T2Params, l1_cells: np.ndarray,
                      plp_slices: list[np.ndarray]) -> np.ndarray:
    """Assemble the frame's active-cell stream and pad with dummy cells.

    Returns (cells_per_frame,) complex64: L1 + PLP slices + dummies.
    """
    total = p.cells_per_frame
    parts = [l1_cells] + plp_slices
    used = sum(len(x) for x in parts)
    if used > total:
        raise ValueError(f"frame overflow: {used} > {total} cells")
    parts.append(dummy_cells(total - used))
    return np.concatenate(parts)


def cells_to_symbols(p: T2Params, frame_cells: np.ndarray) -> list[np.ndarray]:
    """Split the frame cell stream into per-symbol data-cell vectors:
    n_p2 x c_p2, then (n_data - has_fc) x c_data, then optionally n_fc."""
    out = []
    pos = 0
    for _ in range(p.n_p2):
        out.append(frame_cells[pos:pos + p.c_p2])
        pos += p.c_p2
    n_plain = p.n_data - (1 if p.has_fc else 0)
    for _ in range(n_plain):
        out.append(frame_cells[pos:pos + p.c_data])
        pos += p.c_data
    if p.has_fc:
        out.append(frame_cells[pos:pos + p.n_fc])
        pos += p.n_fc
    assert pos == len(frame_cells)
    return out


def miso_group2_cells(y: np.ndarray) -> np.ndarray:
    """MISO processing for transmitter group 2 (EN 302 755 clause 9.1,
    the modified Alamouti encoding the reference's tables anticipate via
    the inverted-pilot carrier types): pairs of frequency-interleaved
    cells (e0, e1) are transmitted as (-e1*, e0*)."""
    assert len(y) % 2 == 0, "MISO requires an even number of data cells"
    out = np.empty_like(y)
    out[0::2] = -np.conj(y[1::2])
    out[1::2] = np.conj(y[0::2])
    return out


def symbols_to_carriers(p: T2Params, symbol_cells: list[np.ndarray]) -> np.ndarray:
    """Frequency-interleave each symbol's cells and insert pilots.

    Returns (len_frame, k_total) complex64 carrier vectors (no IFFT yet).
    For a MISO group-2 transmitter pass `dataclasses.replace(p,
    miso_group=1)`: the pilot tables then carry the clause-9.2 inversions
    and the data cells get the group-2 Alamouti pair encoding.
    """
    g2 = bool(p.miso and p.miso_group == 1)

    def fi(cells, tx):
        v = cells[tx]
        return miso_group2_cells(v) if g2 else v

    out = np.zeros((p.len_frame, p.k_total), dtype=np.complex64)

    p2_map = tables.p2_carrier_map(p)
    p2_refer = tables.p2_pilot_refer(p)
    p2_data_pos = np.where(p2_map == tables.DATA)[0]
    tx_e, tx_o, _, _ = interleavers.fi_gathers(p, "p2")
    for j in range(p.n_p2):
        tx = tx_e if j % 2 == 0 else tx_o
        out[j, p2_data_pos] = fi(symbol_cells[j], tx)
        out[j] += p2_refer[j]

    data_maps = tables.data_carrier_maps(p)
    data_refer = tables.data_pilot_refer(p)
    dy = data_maps.shape[0]
    tx_e, tx_o, _, _ = interleavers.fi_gathers(p, "data")
    n_plain = p.n_data - (1 if p.has_fc else 0)
    for i in range(n_plain):
        l = p.n_p2 + i
        cmap = data_maps[l % dy]
        dpos = np.where(cmap == tables.DATA)[0]
        tx = tx_e if l % 2 == 0 else tx_o
        out[l, dpos] = fi(symbol_cells[l], tx)
        out[l] += data_refer[i]

    if p.has_fc:
        l = p.len_frame - 1
        fc_map = tables.fc_carrier_map(p)
        fpos = np.where(fc_map == tables.DATA)[0]
        tx_e, tx_o, _, _ = interleavers.fi_gathers(p, "fc")
        tx = tx_e if l % 2 == 0 else tx_o
        # FC symbol: n_fc data positions but only c_fc carry real data; the
        # tail (n_fc - c_fc) are "unmodulated cells" -- we transmit them as
        # dummy fill already included in the frame stream slice.
        out[l, fpos] = fi(symbol_cells[l], tx)
        out[l] += tables.fc_pilot_refer(p)
    return out
