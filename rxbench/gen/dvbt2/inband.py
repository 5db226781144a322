"""In-band type-A signalling (ETSI EN 302 755 clause 5.2.3, table 15).

When a PLP's L1 `IN_BAND_A_FLAG` is set, the first BB frame of each
Interleaving Frame carries, at the start of its padding field, the dynamic
scheduling of the NEXT Interleaving Frame (PLP_START / PLP_NUM_BLOCKS /
SUB_SLICE_INTERVAL / TYPE_2_START) plus the L1 change counter — so a locked
receiver can follow scheduling changes without re-decoding L1-post every
frame.

The reference receiver parses only the flag (`p2_symbol.cpp:787-788`) and
never decodes the payload; this module implements both directions (the TX
side inserts it via `ModeAdapter.next_frame(padding_bits=...)`, the RX side
extracts it from the descrambled BB bytes) and the receivers cross-check the
signalled dynamic against the next frame's decoded L1 (`inband_mismatches`
stat).  Payload layout follows table 15 field-for-field; PADDING_TYPE=00
identifies type A.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .l1 import L1PostDynPLP, _get, _put

PADDING_TYPE_A = 0b00


@dataclass
class InBandA:
    """IN-BAND_A payload (table 15).  `current_*` fields describe THIS PLP
    in the next Interleaving Frame; `other_plp` carries (id, start,
    num_blocks) for the other in-band-signalled PLPs."""
    plp_l1_change_counter: int = 0
    reserved_1: int = 0
    sub_slice_interval: int = 0
    start_rf_idx: int = 0
    current_plp_start: int = 0
    reserved_2: int = 0
    current_plp_num_blocks: int = 0
    other_plp: list = field(default_factory=list)   # [L1PostDynPLP]
    type_2_start: int = 0

    def n_bits(self) -> int:
        return 2 + 8 + 8 + 22 + 3 + 22 + 8 + 10 + 8 + 48 * len(
            self.other_plp) + 22

    def pack(self) -> np.ndarray:
        """Serialize to bits, zero-padded to a byte boundary (keeps the BB
        data field length byte-aligned for the TS fast paths)."""
        n = self.n_bits()
        bits = np.zeros(-(-n // 8) * 8, dtype=np.uint8)
        pos = _put(bits, 0, PADDING_TYPE_A, 2)
        pos = _put(bits, pos, self.plp_l1_change_counter, 8)
        pos = _put(bits, pos, self.reserved_1, 8)
        pos = _put(bits, pos, self.sub_slice_interval, 22)
        pos = _put(bits, pos, self.start_rf_idx, 3)
        pos = _put(bits, pos, self.current_plp_start, 22)
        pos = _put(bits, pos, self.reserved_2, 8)
        pos = _put(bits, pos, self.current_plp_num_blocks, 10)
        pos = _put(bits, pos, len(self.other_plp), 8)
        for p in self.other_plp:
            pos = _put(bits, pos, p.id, 8)
            pos = _put(bits, pos, p.start, 22)
            pos = _put(bits, pos, p.num_blocks, 10)
            pos = _put(bits, pos, p.reserved_2, 8)
        pos = _put(bits, pos, self.type_2_start, 22)
        return bits

    @classmethod
    def parse(cls, bits: np.ndarray) -> "InBandA | None":
        """Parse from padding-field bits; None when the padding is not
        type-A or is too short to hold the fixed fields."""
        bits = np.asarray(bits, dtype=np.uint8)
        if len(bits) < 91:
            return None
        ptype, pos = _get(bits, 0, 2)
        if ptype != PADDING_TYPE_A:
            return None
        out = cls()
        out.plp_l1_change_counter, pos = _get(bits, pos, 8)
        out.reserved_1, pos = _get(bits, pos, 8)
        out.sub_slice_interval, pos = _get(bits, pos, 22)
        out.start_rf_idx, pos = _get(bits, pos, 3)
        out.current_plp_start, pos = _get(bits, pos, 22)
        out.reserved_2, pos = _get(bits, pos, 8)
        out.current_plp_num_blocks, pos = _get(bits, pos, 10)
        n_other, pos = _get(bits, pos, 8)
        if len(bits) < pos + 48 * n_other + 22:
            return None
        for _ in range(n_other):
            p = L1PostDynPLP()
            p.id, pos = _get(bits, pos, 8)
            p.start, pos = _get(bits, pos, 22)
            p.num_blocks, pos = _get(bits, pos, 10)
            p.reserved_2, pos = _get(bits, pos, 8)
            out.other_plp.append(p)
        out.type_2_start, pos = _get(bits, pos, 22)
        return out


def build_inband_a(plp_id: int, dyn_next, sub_slice_interval: int = 0,
                   type_2_start: int = 0) -> InBandA:
    """Build the payload for PLP `plp_id` from the next frame's dynamic
    (an `l1.L1PostDynamic`): this PLP's scheduling goes in the current_*
    fields, every other in-band PLP into the other_plp loop."""
    cur = next(p for p in dyn_next.plp if p.id == plp_id)
    others = [p for p in dyn_next.plp if p.id != plp_id]
    return InBandA(
        plp_l1_change_counter=dyn_next.l1_change_counter,
        sub_slice_interval=sub_slice_interval,
        start_rf_idx=dyn_next.start_rf_idx,
        current_plp_start=cur.start,
        current_plp_num_blocks=cur.num_blocks,
        other_plp=others,
        type_2_start=type_2_start)


def extract_from_bb_bytes(frame_bytes: np.ndarray) -> InBandA | None:
    """Pull the in-band payload out of one descrambled BB frame's bytes:
    the padding field starts right after the DFL-bit data field
    (clause 5.2.2); returns None when there is no padding or it does not
    parse as type A."""
    from . import bbframe
    by = np.asarray(frame_bytes, dtype=np.uint8)
    hdr = bbframe.BBHeader.from_bytes(by)
    if hdr is None or hdr.dfl % 8:
        return None
    pad = by[10 + hdr.dfl // 8:]
    if len(pad) == 0:
        return None
    return InBandA.parse(np.unpackbits(pad))
