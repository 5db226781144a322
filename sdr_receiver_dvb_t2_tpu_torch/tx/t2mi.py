"""T2-MI gateway and playout modulator (ETSI TS 102 773).

Closes the full broadcast distribution chain on top of the packet layer in
`dvbt2/t2mi.py`:

  TS --T2MIGateway--> T2-MI/TS --T2MIPlayer--> IQ waveform --rx--> TS

- `T2MIGateway` is the network head-end: it runs mode adaptation + frame
  scheduling once (reusing the modulator's pipeline via its `bb_tap` hook)
  and serializes every BB frame + the per-frame L1 signalling + a
  timestamp into T2-MI packets in an MPEG TS.
- `T2MIPlayer` is the dumb SFN modulator: it parses the T2-MI stream,
  reconstructs the transmission mode FROM THE SIGNALLED L1 ALONE
  (rx.decode.params_from_l1 — the same code path the receiver trusts),
  and plays the received BB frames through the modulator with the
  gateway's L1 transmitted verbatim (`bb_injector`/`l1_injector` hooks).
  Every modulator fed the same T2-MI stream emits the identical waveform —
  the SFN property; the loopback test asserts the played waveform is
  bit-identical to the direct modulator's.

The reference application has no modulator at all, let alone the
distribution interface.  Provenance caveats: see dvbt2/t2mi.py.
"""
from __future__ import annotations

import sys

import numpy as np

from ..dvbt2 import l1 as l1mod
from ..dvbt2 import t2mi as mi
from ..dvbt2.params import FFTMode, T2Params, PLPParams
from .modulator import ModulatorOutput, T2Modulator

# S2 field-1 -> FFT mode uses the same profile-dependent table-49 coding
# the P1 carries (dvbt2.params.fft_from_s2_field1; L1-pre's S1 field says
# which column applies)


class T2MIGateway:
    """Mode adaptation + scheduling once, at the head-end."""

    def __init__(self, p: T2Params, plps: list[PLPParams],
                 l1_post_mod: int = 1, hem: bool = False,
                 l1_repetition: bool = False, pid: int = mi.DEFAULT_PID):
        self.p, self.plps = p, plps
        self.l1_post_mod = l1_post_mod
        self.hem = hem
        self.l1_repetition = l1_repetition
        self.pid = pid

    def build(self, ts: np.ndarray, n_frames: int
              ) -> tuple[np.ndarray, ModulatorOutput]:
        """-> ((n,188) T2-MI transport stream, the direct ModulatorOutput
        for comparison/air)."""
        taps: dict[int, dict[int, np.ndarray]] = {}

        def tap(fidx, plp_id, bb):
            taps.setdefault(fidx, {})[plp_id] = np.array(bb, np.uint8)

        mod = T2Modulator(self.p, self.plps, l1_post_mod=self.l1_post_mod,
                          hem=self.hem, l1_repetition=self.l1_repetition,
                          bb_tap=tap)
        out = mod.modulate(ts, n_frames)

        packets: list[np.ndarray] = []
        count = 0
        n_t2 = max(int(out.l1pre.num_t2_frames), 1)
        l1pre_bits = out.l1pre.pack()
        sample_off = 0

        def emit(ptype, payload, sf):
            nonlocal count
            packets.append(mi.pack_packet(mi.T2MIPacket(
                packet_type=ptype, packet_count=count,
                superframe_idx=sf, payload=payload)))
            count = (count + 1) % 256

        for fidx in range(n_frames):
            sf = (fidx // n_t2) & 0xF
            l1post = out.l1post_frames[fidx]
            frame_idx = int(l1post.dyn.frame_idx)
            emit(mi.T2MI_TIMESTAMP,
                 mi.build_timestamp_payload(sample_off,
                                            bandwidth=self.p.bandwidth), sf)
            emit(mi.T2MI_L1_CURRENT, mi.build_l1_current_payload(
                frame_idx, l1pre_bits,
                l1post.pack(repetition=self.l1_repetition)), sf)
            for cfg in self.plps:
                bb = taps[fidx][cfg.plp_id]
                for j in range(bb.shape[0]):
                    emit(mi.T2MI_BBFRAME, mi.build_bbframe_payload(
                        frame_idx, cfg.plp_id, bb[j],
                        intl_frame_start=(j == 0)), sf)
            sample_off += len(out.frames[fidx])
            if self.p.fef_after(fidx):
                sample_off += int(self.p.fef[1])
        return mi.to_ts(packets, pid=self.pid), out


class T2MIPlayer:
    """SFN playout modulator: T2-MI in, waveform out — no TS, no
    scheduling decisions, mode discovered from the signalled L1."""

    def __init__(self, t2mi_ts: np.ndarray, pid: int = mi.DEFAULT_PID):
        stream, self.ts_drops = mi.from_ts(t2mi_ts, pid=pid)
        pkts, self.bad_crc = mi.parse_packets(stream)
        self.frames: list[dict] = []   # arrival order; wraps at frame_idx
        self.timestamps: list[int] = []      # elementary-sample offsets
        self.utc_timestamps: list[mi.T2Timestamp] = []
        self.l1pre: l1mod.L1Pre | None = None
        cur = None
        from ..dvbt2.params import Bandwidth
        bw_by_code = {c: Bandwidth[n] for n, c in mi._TS_BW_CODE.items()}
        for p in pkts:
            if p.packet_type == mi.T2MI_TIMESTAMP:
                t = mi.parse_timestamp_payload(p.payload)
                self.utc_timestamps.append(t)
                self.timestamps.append(
                    t.sample_offset(bw_by_code.get(t.bw_code,
                                                   Bandwidth.BW_8)))
            elif p.packet_type == mi.T2MI_L1_CURRENT:
                fidx, pre_bits, post_bits = mi.parse_l1_current_payload(
                    p.payload)
                pre = l1mod.L1Pre.unpack(pre_bits)
                if pre is None:
                    raise ValueError("T2-MI L1-pre CRC failure")
                if self.l1pre is None:
                    self.l1pre = pre
                post = l1mod.L1Post.unpack(
                    post_bits, num_rf=pre.num_rf,
                    has_fef=bool(pre.s2_field2),
                    repetition=bool(pre.l1_repetition_flag))
                if post is None:
                    raise ValueError("T2-MI L1-post CRC failure")
                cur = {"frame_idx": fidx, "l1post": post, "plps": {}}
                self.frames.append(cur)
            elif p.packet_type == mi.T2MI_BBFRAME:
                fidx, plp_id, bb = mi.parse_bbframe_payload(p.payload)
                if cur is None or fidx != cur["frame_idx"]:
                    raise ValueError(
                        f"BBFRAME for frame {fidx} outside its L1 context")
                cur["plps"].setdefault(plp_id, []).append(bb)
        if self.l1pre is None or not self.frames:
            raise ValueError("no decodable L1 in the T2-MI stream")

    def modulator(self) -> T2Modulator:
        pre = self.l1pre
        from ..dvbt2.params import fft_from_s2_field1
        from ..rx.decode import params_from_l1
        fft = fft_from_s2_field1(pre.s2_field1, lite=pre.s1 in (3, 4))
        if fft is None:
            raise ValueError(
                f"reserved S2 field1 {pre.s2_field1} for S1 {pre.s1}")
        p, plps = params_from_l1(fft, pre, self.frames[0]["l1post"])

        def bb_injector(fidx, plp_id, nb):
            got = self.frames[fidx]["plps"].get(plp_id, [])
            if len(got) != nb:
                raise ValueError(
                    f"frame {fidx} PLP {plp_id}: {len(got)} BB frames "
                    f"in the T2-MI stream, L1 schedules {nb}")
            return np.stack(got)

        mod = T2Modulator(p, plps, l1_post_mod=pre.l1_post_mod,
                          l1_repetition=bool(pre.l1_repetition_flag),
                          bb_injector=bb_injector)
        mod.l1_injector = lambda fidx: (pre, self.frames[fidx]["l1post"])
        return mod

    def waveform(self) -> ModulatorOutput:
        return self.modulator().modulate(np.zeros(0, np.uint8),
                                         len(self.frames))


class T2MIRegenerator:
    """Receiver -> T2-MI: the DVB regenerative-repeater role.

    Attach to a `T2Receiver` (`rx.regen_sink = T2MIRegenerator()`); during
    `receive()` it observes every decoded frame's L1 signalling and the
    FEC-corrected, descrambled BB frames.  `t2mi_ts()` then serializes
    them exactly like the gateway — so a noisy off-air signal becomes a
    CLEAN T2-MI feed that any playout modulator re-emits bit-exactly
    (the L1-pre REGEN_FLAG regeneration counter is incremented per hop;
    caps at 7).  Requires a full decode: no plp_filter, every PLP's BB
    frames present.  Frames whose FEC did not fully converge (any
    LDPC/BCH failure reported by the receiver) are DROPPED from the feed
    — a regenerated stream advertises itself as clean (valid CRCs), so
    re-emitting corrupted BB frames would poison every downstream SFN
    transmitter; `dropped_frames` counts them."""

    def __init__(self, pid: int = mi.DEFAULT_PID):
        self.pid = pid
        self.frames: list[dict] = []
        self.params: T2Params | None = None
        self.l1pre: l1mod.L1Pre | None = None
        self.dropped_frames = 0

    # -- hooks the receiver calls -----------------------------------------
    def start_frame(self, params, l1pre, l1post) -> None:
        self.params = params
        self.l1pre = l1pre
        self.frames.append({"l1post": l1post, "plps": {}, "bad": False})

    def add_bb(self, plp_id: int, bb: np.ndarray) -> None:
        self.frames[-1]["plps"][plp_id] = np.asarray(bb, np.uint8)

    def mark_bad(self) -> None:
        """Current frame carried an LDPC- or BCH-failed BB frame: exclude
        it from the regenerated feed."""
        if self.frames:
            self.frames[-1]["bad"] = True

    # -- serialization (mirrors T2MIGateway.build) ------------------------
    def t2mi_ts(self) -> np.ndarray:
        if not self.frames or self.l1pre is None:
            raise ValueError("no decoded frames to regenerate")
        import dataclasses
        pre = dataclasses.replace(
            self.l1pre, regen_flag=min(int(self.l1pre.regen_flag) + 1, 7))
        pre_bits = pre.pack()
        rep = bool(pre.l1_repetition_flag)
        n_t2 = max(int(pre.num_t2_frames), 1)
        p = self.params
        packets: list[np.ndarray] = []
        count = 0
        sample_off = 0
        self.dropped_frames = 0

        def emit(ptype, payload, sf):
            nonlocal count
            packets.append(mi.pack_packet(mi.T2MIPacket(
                packet_type=ptype, packet_count=count,
                superframe_idx=sf, payload=payload)))
            count = (count + 1) % 256

        for i, fr in enumerate(self.frames):
            l1post = fr["l1post"]
            frame_idx = int(l1post.dyn.frame_idx)
            sf = (i // n_t2) & 0xF
            if fr["bad"]:
                # FEC-failed frame: advance the clock, emit nothing
                self.dropped_frames += 1
                sample_off += p.frame_samples + p.fef_after(frame_idx % n_t2)
                continue
            emit(mi.T2MI_TIMESTAMP,
                 mi.build_timestamp_payload(sample_off,
                                            bandwidth=p.bandwidth), sf)
            emit(mi.T2MI_L1_CURRENT, mi.build_l1_current_payload(
                frame_idx, pre_bits, l1post.pack(repetition=rep)), sf)
            for plp_id in sorted(fr["plps"]):
                bb = fr["plps"][plp_id]
                for j in range(bb.shape[0]):
                    emit(mi.T2MI_BBFRAME, mi.build_bbframe_payload(
                        frame_idx, plp_id, bb[j],
                        intl_frame_start=(j == 0)), sf)
            sample_off += p.frame_samples + p.fef_after(frame_idx % n_t2)
        return mi.to_ts(packets, pid=self.pid)


# --------------------------------------------------------------------------
# CLI: t2mi wrap / t2mi play
# --------------------------------------------------------------------------

def main(argv=None):
    import argparse

    from ..dvbt2.params import (Bandwidth, CodeRate, Constellation, FECFrame,
                                GuardInterval, PilotPattern)
    from ..io import iq as iqio
    from .cli import _FFT, _GI, _MOD, _RATE

    ap = argparse.ArgumentParser(
        description="T2-MI gateway/playout (TS 102 773): 'wrap' runs the "
                    "gateway (TS -> T2-MI/TS), 'play' runs the SFN playout "
                    "modulator (T2-MI/TS -> IQ)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    w = sub.add_parser("wrap")
    w.add_argument("ts_input")
    w.add_argument("t2mi_output")
    w.add_argument("--fft", choices=_FFT, default="8k")
    w.add_argument("--guard", choices=_GI, default="1/32")
    w.add_argument("--pp", type=int, default=1)
    w.add_argument("--extended", action="store_true")
    w.add_argument("--mod", choices=_MOD, default="16qam")
    w.add_argument("--rate", choices=_RATE, default="1/2")
    w.add_argument("--short-fec", action="store_true")
    w.add_argument("--no-rotation", action="store_true")
    w.add_argument("--blocks", type=int, default=3)
    w.add_argument("--n-data", type=int, default=9)
    w.add_argument("--frames", type=int, default=2)
    w.add_argument("--hem", action="store_true")
    w.add_argument("--miso", action="store_true")
    w.add_argument("--lite", action="store_true",
                   help="T2-Lite preamble (annex I)")
    w.add_argument("--fef", default=None, metavar="LEN[:INTERVAL[:TYPE]]")
    pl = sub.add_parser("play")
    pl.add_argument("t2mi_input")
    pl.add_argument("iq_output")
    pl.add_argument("--bandwidth", type=float, default=8.0,
                    choices=(1.7, 5.0, 6.0, 7.0, 8.0, 10.0))
    pl.add_argument("--out2", default=None,
                    help="second MISO transmitter group's waveform")
    pl.add_argument("--format", choices=iqio.FORMATS, default=None)
    args = ap.parse_args(argv)

    if args.cmd == "wrap":
        from ..dvbt2.params import Preamble
        fef = None
        if args.fef:
            parts = [int(v) for v in args.fef.split(":")]
            fef = (parts[2] if len(parts) > 2 else 0, parts[0],
                   parts[1] if len(parts) > 1 else 2)
        if args.lite:
            pre = (Preamble.T2_LITE_MISO if args.miso
                   else Preamble.T2_LITE_SISO)
        else:
            pre = Preamble.T2_MISO if args.miso else Preamble.T2_SISO
        p = T2Params(fft_mode=_FFT[args.fft], guard=_GI[args.guard],
                     pilot_pattern=PilotPattern(args.pp - 1),
                     extended_carrier=args.extended, n_data=args.n_data,
                     miso=args.miso, preamble=pre, fef=fef)
        plp = PLPParams(
            constellation=_MOD[args.mod], rate=_RATE[args.rate],
            fec_frame=FECFrame.SHORT if args.short_fec else FECFrame.NORMAL,
            rotated=not args.no_rotation, num_blocks_max=args.blocks,
            time_il_length=1)
        gw = T2MIGateway(p, [plp], hem=args.hem)
        ts = np.fromfile(args.ts_input, dtype=np.uint8)
        t2mi_ts, _ = gw.build(ts, args.frames)
        t2mi_ts.tofile(args.t2mi_output)
        print(f"wrote {t2mi_ts.shape[0]} T2-MI TS packets "
              f"-> {args.t2mi_output}", file=sys.stderr)
        return 0

    player = T2MIPlayer(np.fromfile(args.t2mi_input, dtype=np.uint8))
    out = player.waveform()
    iqio.write_iq(args.iq_output, out.samples, args.format)
    if args.out2 is not None and out.samples2 is not None:
        iqio.write_iq(args.out2, out.samples2, args.format)
    fs = Bandwidth.from_mhz(args.bandwidth).sample_rate
    print(f"played {len(player.frames)} frames "
          f"({player.ts_drops} TS drops, {player.bad_crc} bad CRCs): "
          f"{len(out.samples)} samples ({len(out.samples)/fs:.3f} s) "
          f"-> {args.iq_output}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
