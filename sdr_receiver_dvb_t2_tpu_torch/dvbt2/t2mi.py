"""T2-MI (ETSI TS 102 773) modulator-interface encapsulation.

The distribution layer of a real DVB-T2 network: a T2 *gateway* performs
mode adaptation and frame scheduling ONCE, then streams the resulting BB
frames plus the L1 signalling to every modulator of the (single-frequency)
network as T2-MI packets carried in an MPEG transport stream.  Each
modulator is a dumb playout device: FEC + framing + OFDM from the received
BB frames, bit-identical across the SFN.  The reference application is a
receiver only and has no equivalent of this interface; here the gateway and
the playout modulator are both implemented (tx/t2mi.py) on top of this
packet layer, so the full broadcast chain closes: TS -> gateway -> T2-MI
-> modulator -> air -> receiver -> TS.

This module is the transport-agnostic packet layer:
  - T2-MI packet pack/parse (header + bit payload + CRC-32),
  - payload builders/parsers for the three packet types the chain needs:
    BBFRAME (0x00), L1_CURRENT (0x10), TIMESTAMP (0x20),
  - MPEG-TS encapsulation (data piping on one PID with pointer_field
    resync and adaptation-field stuffing).

Provenance: the packet header layout (packet_type(8), packet_count(8),
superframe_idx(4), rfu(12), payload_len(16, in BITS), payload, CRC-32
with the MPEG polynomial) and the BBFRAME / L1-current payload heads
follow TS 102 773 clause 5; the TIMESTAMP payload follows the clause
5.2.3 shape (bandwidth + UTC seconds/subseconds + utco, see
`build_timestamp_payload`) with a configurable epoch so loopback streams
need no wall clock.  No external T2-MI stream or second implementation is
available in this environment, so conformance is validated by loopback
round-trip (gateway -> playout -> receiver TS bit-exact, playout waveform
bit-identical to the direct modulator) — disclosed, like the L1
puncture-order provenance note in dvbt2/l1.py.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

T2MI_BBFRAME = 0x00
T2MI_L1_CURRENT = 0x10
T2MI_TIMESTAMP = 0x20

_HDR_BYTES = 6
_CRC_BYTES = 4

TS_PACKET = 188
DEFAULT_PID = 0x1000


def _crc32_table() -> np.ndarray:
    poly = 0x04C11DB7
    tab = np.zeros(256, np.uint32)
    for i in range(256):
        c = i << 24
        for _ in range(8):
            c = ((c << 1) ^ poly) if (c & 0x80000000) else (c << 1)
            c &= 0xFFFFFFFF
        tab[i] = c
    return tab


_CRC_TAB = [int(x) for x in _crc32_table()]


def crc32_mpeg(data: np.ndarray) -> int:
    """MPEG CRC-32 over bytes (MSB-first, init 0xFFFFFFFF, no xorout) —
    the byte-table form of l1.crc32_bits."""
    crc = 0xFFFFFFFF
    for b in np.asarray(data, np.uint8).tolist():
        crc = ((crc << 8) & 0xFFFFFFFF) ^ _CRC_TAB[((crc >> 24) ^ b) & 0xFF]
    return crc


@dataclass
class T2MIPacket:
    packet_type: int
    packet_count: int          # global mod-256 packet counter
    superframe_idx: int        # 4 bits
    payload: np.ndarray        # uint8 BITS (length signalled in bits)


def pack_packet(pkt: T2MIPacket) -> np.ndarray:
    """Serialize one T2-MI packet to bytes (uint8 array)."""
    pay = np.asarray(pkt.payload, np.uint8)
    plen = len(pay)
    hdr = np.zeros(_HDR_BYTES, np.uint8)
    hdr[0] = pkt.packet_type & 0xFF
    hdr[1] = pkt.packet_count & 0xFF
    hdr[2] = ((pkt.superframe_idx & 0xF) << 4)  # + 4 bits rfu
    hdr[3] = 0                                  # rfu
    hdr[4] = (plen >> 8) & 0xFF
    hdr[5] = plen & 0xFF
    body = np.concatenate([hdr, np.packbits(pay)])
    crc = crc32_mpeg(body)
    tail = np.array([(crc >> 24) & 0xFF, (crc >> 16) & 0xFF,
                     (crc >> 8) & 0xFF, crc & 0xFF], np.uint8)
    return np.concatenate([body, tail])


def parse_packets(stream: np.ndarray) -> tuple[list[T2MIPacket], int]:
    """Parse a byte stream of back-to-back T2-MI packets.

    Returns (packets, bad_crc_count).  A CRC failure drops that packet and
    rescans byte-by-byte (there is no sync word inside the stream — the TS
    layer's pointer_field provides packet alignment on joins)."""
    data = np.asarray(stream, np.uint8)
    out: list[T2MIPacket] = []
    bad = 0
    i = 0
    while i + _HDR_BYTES + _CRC_BYTES <= len(data):
        plen = (int(data[i + 4]) << 8) | int(data[i + 5])
        nbytes = _HDR_BYTES + -(-plen // 8) + _CRC_BYTES
        if i + nbytes > len(data):
            # either a truncated tail or a garbage length field seen while
            # rescanning after a CRC failure — keep scanning byte-by-byte
            # (a later genuine packet start may still fit)
            i += 1
            continue
        blob = data[i:i + nbytes]
        want = (int(blob[-4]) << 24) | (int(blob[-3]) << 16) \
            | (int(blob[-2]) << 8) | int(blob[-1])
        if crc32_mpeg(blob[:-4]) != want:
            bad += 1
            i += 1   # rescan (corrupted length field cannot be trusted)
            continue
        pay = np.unpackbits(blob[_HDR_BYTES:-_CRC_BYTES])[:plen]
        out.append(T2MIPacket(
            packet_type=int(blob[0]), packet_count=int(blob[1]),
            superframe_idx=int(blob[2]) >> 4, payload=pay))
        i += nbytes
    return out, bad


# --------------------------------------------------------------------------
# Payload builders / parsers
# --------------------------------------------------------------------------

def _bits_from_int(value: int, width: int) -> np.ndarray:
    return np.array([(value >> (width - 1 - k)) & 1 for k in range(width)],
                    np.uint8)


def _int_from_bits(bits: np.ndarray) -> int:
    v = 0
    for b in bits:
        v = (v << 1) | int(b)
    return v


def build_bbframe_payload(frame_idx: int, plp_id: int, bb_bits: np.ndarray,
                          intl_frame_start: bool = False) -> np.ndarray:
    """BBFRAME (0x00): frame_idx(8), plp_id(8), intl_frame_start(1)+rfu(7),
    then the mode-adapted (unscrambled) BB frame: BBHEADER + data field."""
    head = np.concatenate([
        _bits_from_int(frame_idx & 0xFF, 8),
        _bits_from_int(plp_id & 0xFF, 8),
        _bits_from_int(0x80 if intl_frame_start else 0, 8)])
    return np.concatenate([head, np.asarray(bb_bits, np.uint8)])


def parse_bbframe_payload(pay: np.ndarray) -> tuple[int, int, np.ndarray]:
    """-> (frame_idx, plp_id, bb_bits)."""
    return (_int_from_bits(pay[0:8]), _int_from_bits(pay[8:16]), pay[24:])


def build_l1_current_payload(frame_idx: int, l1pre_bits: np.ndarray,
                             l1post_bits: np.ndarray) -> np.ndarray:
    """L1_CURRENT (0x10): frame_idx(8), rfu(24), L1-pre bits (200 incl.
    CRC-32), then the L1-post configurable+dynamic bits."""
    return np.concatenate([
        _bits_from_int(frame_idx & 0xFF, 8), np.zeros(24, np.uint8),
        np.asarray(l1pre_bits, np.uint8), np.asarray(l1post_bits, np.uint8)])


def parse_l1_current_payload(pay: np.ndarray,
                             l1pre_len: int = 200
                             ) -> tuple[int, np.ndarray, np.ndarray]:
    """-> (frame_idx, l1pre_bits, l1post_bits)."""
    return (_int_from_bits(pay[0:8]), pay[32:32 + l1pre_len],
            pay[32 + l1pre_len:])


# T2-MI timestamp (packet type 0x20), clause 5.2.3 shape:
#   rfu(2) | bandwidth(4) | seconds_since_2000(40) | subseconds(27) |
#   utco(13)  = 86 bits (payload length is signalled in bits).
# subseconds counts ELEMENTARY PERIODS within the UTC second — the unit the
# bandwidth field exists to resolve (2^27 > 10e6 covers every rate).  The
# epoch is configurable (epoch_seconds) so loopback streams stay
# deterministic with no wall clock.  Field widths/order reconstructed from
# the spec's field descriptions; the bandwidth code table below is this
# repo's ordering of the six EN 302 755 bandwidths — no real T2-MI stream
# is available here to cross-check (module docstring provenance note), so
# do not feed this to real SFN playout equipment expecting exact
# conformance.
_TS_BW_CODE = {"BW_1_7": 0, "BW_5": 1, "BW_6": 2, "BW_7": 3, "BW_8": 4,
               "BW_10": 5}


@dataclass
class T2Timestamp:
    bw_code: int
    seconds: int          # seconds since the epoch (spec: since 2000)
    subseconds: int       # elementary periods within the second
    utco: int             # UTC-TAI offset, seconds

    def sample_offset(self, bandwidth) -> int:
        """Back to the absolute elementary-sample offset (exact integer
        arithmetic on the bandwidth's rational rate)."""
        num, den = bandwidth.value
        spn = den * 1_000_000          # samples per `num` seconds
        start = -(-self.seconds * spn // num)   # ceil
        return start + self.subseconds


def build_timestamp_payload(sample_offset: int, bandwidth=None,
                            epoch_seconds: int = 0,
                            utco: int = 0) -> np.ndarray:
    """TIMESTAMP (0x20): absolute T2-frame start time as
    seconds/subseconds at the channel's elementary rate."""
    from .params import Bandwidth
    bw = bandwidth or Bandwidth.BW_8
    num, den = bw.value
    spn = den * 1_000_000
    off = int(sample_offset)
    secs = off * num // spn
    start = -(-secs * spn // num)
    sub = off - start
    secs += int(epoch_seconds)
    return np.concatenate([
        _bits_from_int(0, 2),
        _bits_from_int(_TS_BW_CODE[bw.name], 4),
        _bits_from_int(secs & ((1 << 40) - 1), 40),
        _bits_from_int(sub & ((1 << 27) - 1), 27),
        _bits_from_int(utco & ((1 << 13) - 1), 13)])


def parse_timestamp_payload(pay: np.ndarray) -> T2Timestamp:
    return T2Timestamp(
        bw_code=_int_from_bits(pay[2:6]),
        seconds=_int_from_bits(pay[6:46]),
        subseconds=_int_from_bits(pay[46:73]),
        utco=_int_from_bits(pay[73:86]))


# --------------------------------------------------------------------------
# MPEG-TS encapsulation (data piping on one PID)
# --------------------------------------------------------------------------

def to_ts(t2mi_packets: list[np.ndarray], pid: int = DEFAULT_PID
          ) -> np.ndarray:
    """Encapsulate serialized T2-MI packets into (n, 188) TS packets.

    Data piping: the byte stream of back-to-back T2-MI packets fills TS
    payloads; a TS packet in which a T2-MI packet begins carries PUSI=1 and
    a pointer_field as its first payload byte (section-style resync).  The
    final partial payload is completed with adaptation-field stuffing so
    no filler bytes enter the T2-MI stream."""
    # byte offsets at which each T2-MI packet starts in the joined stream
    starts = []
    off = 0
    for p in t2mi_packets:
        starts.append(off)
        off += len(p)
    stream = (np.concatenate(t2mi_packets) if t2mi_packets
              else np.zeros(0, np.uint8))
    starts_arr = np.array(starts, np.int64)
    out = []
    cc = 0
    pos = 0
    while pos < len(stream):
        # does a T2-MI packet start inside this TS packet's payload span?
        pkt = np.zeros(TS_PACKET, np.uint8)
        pkt[0] = 0x47
        # find first T2-MI start >= pos within what this packet could carry
        k = np.searchsorted(starts_arr, pos)
        delta = int(starts_arr[k] - pos) if k < len(starts_arr) else None
        if delta is not None and delta <= TS_PACKET - 6:
            ptr = delta
            cap = TS_PACKET - 5  # header(4) + pointer(1)
        else:
            ptr = None
            cap = TS_PACKET - 4
            if delta is not None and delta < cap:
                # the start would land at payload offset 183 — one byte too
                # far for a pointer to reach.  Truncate this packet before
                # it (the next TS packet then opens with PUSI/ptr=0) so
                # every T2-MI packet start is PUSI-announced.
                cap = delta
        take = min(cap, len(stream) - pos)
        # physical payload capacity (stuffing fills whatever take leaves)
        stuff = (TS_PACKET - 5 if ptr is not None else TS_PACKET - 4) - take
        pkt[1] = (0x40 if ptr is not None else 0) | ((pid >> 8) & 0x1F)
        pkt[2] = pid & 0xFF
        body = []
        if stuff > 0:
            # adaptation field of length stuff: 1 length byte + flags/0xFF
            pkt[3] = 0x30 | (cc & 0xF)   # adaptation + payload
            body.append(np.array([stuff - 1], np.uint8))
            if stuff > 1:
                af = np.full(stuff - 1, 0xFF, np.uint8)
                af[0] = 0x00  # adaptation flags
                body.append(af)
        else:
            pkt[3] = 0x10 | (cc & 0xF)   # payload only
        if ptr is not None:
            body.append(np.array([ptr], np.uint8))
        body.append(stream[pos:pos + take])
        b = np.concatenate(body)
        pkt[4:4 + len(b)] = b
        out.append(pkt)
        pos += take
        cc = (cc + 1) & 0xF
    return (np.stack(out) if out
            else np.zeros((0, TS_PACKET), np.uint8))


def from_ts(packets: np.ndarray, pid: int = DEFAULT_PID
            ) -> tuple[np.ndarray, int]:
    """De-encapsulate: (n,188) TS packets -> (t2mi byte stream, drops).

    Continuity-counter gaps (lost TS packets) discard buffered bytes and
    resynchronize at the next PUSI via its pointer_field; `drops` counts
    the discontinuities seen."""
    packets = np.asarray(packets, np.uint8).reshape(-1, TS_PACKET)
    done: list[np.ndarray] = []     # flushed, packet-start-aligned spans
    cur: list[np.ndarray] = []      # bytes since the last known start
    drops = 0
    expect_cc = None
    synced = False
    for pkt in packets:
        if pkt[0] != 0x47:
            continue
        p = ((int(pkt[1]) & 0x1F) << 8) | int(pkt[2])
        if p != pid:
            continue
        pusi = bool(pkt[1] & 0x40)
        afc = (pkt[3] >> 4) & 0x3
        cc = int(pkt[3]) & 0xF
        if not (afc & 1):
            continue  # no payload
        off = 4
        if afc & 2:
            off += 1 + int(pkt[4])
        payload = pkt[off:]
        if expect_cc is not None and cc != expect_cc:
            # lost TS packet(s): the T2-MI packet(s) being assembled are
            # missing bytes — discard them rather than splicing the halves
            # together, and wait for the next announced start
            drops += 1
            cur = []
            synced = False
        expect_cc = (cc + 1) & 0xF
        if pusi and len(payload) >= 1:
            ptr = int(payload[0])
            rest = payload[1:]
            if ptr > len(rest):
                continue  # corrupt pointer: skip, stay in current state
            if synced:
                cur.append(rest[:ptr])
                done.extend(cur)
            cur = [rest[ptr:]]
            synced = True
        elif synced and len(payload):
            cur.append(payload)
    done.extend(cur)
    stream = np.concatenate(done) if done else np.zeros(0, np.uint8)
    return stream, drops
