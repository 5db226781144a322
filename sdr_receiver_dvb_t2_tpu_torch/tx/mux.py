"""Base + T2-Lite multiplexing through FEF parts (EN 302 755 clause 8.4
with the T2-Lite profile of annex I).

This is how real networks carry a mobile/low-rate T2-Lite service next to
a base T2 service on one RF channel: the base signal declares FEF parts,
and each FEF part IS one frame of an independent T2-Lite signal (own P1
with S1=T2-Lite, own L1, own PLPs).  Reciprocally, the lite signal's L1
declares the base frames between its own frames as ITS FEF parts, so a
lite-profile receiver's frame grid strides over them.  The receivers
select a service purely by preamble type (`T2Receiver(profile=...)`);
no other coordination is needed — the FEF scheduling machinery of both
signals composes.

The reference application supports neither T2-Lite nor FEF: it would
fail to lock on such a multiplex at all.

Timing invariants (asserted):
  base.fef = (type, lite.frame_samples, K)   — one lite frame per FEF
  lite.fef = (type, K * base.frame_samples, 1) — base frames are lite's FEFs

NOTE the T2-Lite P1 here encodes S2 field 1 with the base FFT-size table
(our TX and RX agree); the standard's table 49 uses a modified coding for
lite preambles (FFT+GI ranges) which a cross-vendor lite receiver would
expect — disclosed deviation, loopback-exact.
"""
from __future__ import annotations

import numpy as np

from ..dvbt2.params import PLPParams, Preamble, T2Params
from .modulator import ModulatorOutput, T2Modulator


class BaseLiteMux:
    """Builds the combined sample stream of a base T2 service and a
    T2-Lite service living in its FEF parts."""

    def __init__(self, base_p: T2Params, base_plps: list[PLPParams],
                 lite_p: T2Params, lite_plps: list[PLPParams],
                 hem: bool = False):
        if base_p.fef is None or base_p.fef[2] <= 0:
            raise ValueError("base params must declare FEF parts")
        if lite_p.preamble not in (Preamble.T2_LITE_SISO,
                                   Preamble.T2_LITE_MISO):
            raise ValueError("lite params must use a T2-Lite preamble")
        interval = base_p.fef[2]
        if base_p.fef[1] != lite_p.frame_samples:
            raise ValueError(
                f"base FEF_LENGTH {base_p.fef[1]} must equal the lite "
                f"frame length {lite_p.frame_samples}")
        want_gap = (0, interval * base_p.frame_samples, 1)
        if lite_p.fef is None or tuple(lite_p.fef[1:]) != want_gap[1:]:
            raise ValueError(
                f"lite params must declare the base frames as their FEF: "
                f"fef=(type, {want_gap[1]}, 1), got {lite_p.fef}")
        self.base_p, self.lite_p = base_p, lite_p
        self.interval = interval
        self.base_mod = T2Modulator(base_p, base_plps, hem=hem,
                                    fef_insert=False)
        self.lite_mod = T2Modulator(lite_p, lite_plps, hem=hem,
                                    fef_insert=False)

    @classmethod
    def auto(cls, base_p: T2Params, base_plps: list[PLPParams],
             lite_p: T2Params, lite_plps: list[PLPParams],
             interval: int = 2, hem: bool = False) -> "BaseLiteMux":
        """Fill in the reciprocal FEF tuples from the two modes' frame
        lengths (base_p/lite_p given WITHOUT fef)."""
        import dataclasses
        base0 = dataclasses.replace(base_p, fef=None)
        lite0 = dataclasses.replace(lite_p, fef=None)
        lite_p2 = dataclasses.replace(
            lite0, fef=(0, interval * base0.frame_samples, 1))
        base_p2 = dataclasses.replace(
            base0, fef=(0, lite_p2.frame_samples, interval))
        return cls(base_p2, base_plps, lite_p2, lite_plps, hem=hem)

    def lite_frames_for(self, n_base_frames: int) -> int:
        return sum(1 for f in range(n_base_frames)
                   if (f + 1) % self.interval == 0)

    def modulate(self, ts_base: np.ndarray, ts_lite: np.ndarray,
                 n_base_frames: int
                 ) -> tuple[np.ndarray, ModulatorOutput, ModulatorOutput]:
        """-> (combined samples, base ModulatorOutput, lite ModulatorOutput).

        The combined stream is [base frames | lite frames] interleaved on
        the base signal's FEF schedule; each service's TS is carried only
        in its own frames."""
        n_lite = self.lite_frames_for(n_base_frames)
        if n_lite == 0:
            raise ValueError("no FEF part inside the requested frames")
        base_out = self.base_mod.modulate(ts_base, n_base_frames)
        lite_out = self.lite_mod.modulate(ts_lite, n_lite)
        # power-match the two services so AGC sees one continuous level
        pb = float(np.mean(np.abs(base_out.samples) ** 2))
        pl = float(np.mean(np.abs(lite_out.samples) ** 2))
        scale = np.sqrt(pb / max(pl, 1e-30)).astype(np.float32)
        stream = []
        li = 0
        for fidx, fr in enumerate(base_out.frames):
            stream.append(fr)
            if self.base_p.fef_after(fidx):
                stream.append(lite_out.frames[li] * scale)
                li += 1
        assert li == n_lite
        return np.concatenate(stream), base_out, lite_out


def main(argv=None) -> int:
    """`t2mux`: base TS + lite TS -> one IQ capture carrying both
    services (base T2 + T2-Lite in its FEF parts).

        t2mux base.ts lite.ts mux.cf32 --frames 4 --interval 2
        t2rx mux.cf32 --profile base --out base.ts.out
        t2rx mux.cf32 --profile lite --out lite.ts.out
    """
    import argparse
    import sys

    from ..dvbt2.params import (CodeRate, Constellation, FECFrame, FFTMode,
                                GuardInterval, PilotPattern)
    from ..io import iq as iqio
    from .cli import _FFT, _GI, _MOD, _RATE

    ap = argparse.ArgumentParser(
        prog="t2mux", description="multiplex a T2-Lite service into the "
        "FEF parts of a base DVB-T2 signal")
    ap.add_argument("ts_base")
    ap.add_argument("ts_lite")
    ap.add_argument("iq_output")
    ap.add_argument("--frames", type=int, default=4,
                    help="base T2-frames (lite frames = frames/interval)")
    ap.add_argument("--interval", type=int, default=2,
                    help="FEF_INTERVAL: base frames between lite frames")
    ap.add_argument("--fft", choices=_FFT, default="8k")
    ap.add_argument("--guard", choices=_GI, default="1/32")
    ap.add_argument("--pp", type=int, default=1)
    ap.add_argument("--mod", choices=_MOD, default="16qam")
    ap.add_argument("--rate", choices=_RATE, default="1/2")
    ap.add_argument("--blocks", type=int, default=3)
    ap.add_argument("--n-data", type=int, default=9)
    ap.add_argument("--lite-fft", choices=_FFT, default=None,
                    help="lite FFT size (default: same as base)")
    ap.add_argument("--lite-mod", choices=_MOD, default="qpsk")
    ap.add_argument("--lite-rate", choices=_RATE, default="1/2")
    ap.add_argument("--lite-blocks", type=int, default=1)
    ap.add_argument("--lite-n-data", type=int, default=4)
    ap.add_argument("--format", choices=iqio.FORMATS, default=None)
    args = ap.parse_args(argv)

    base_p = T2Params(fft_mode=_FFT[args.fft], guard=_GI[args.guard],
                      pilot_pattern=PilotPattern(args.pp - 1),
                      extended_carrier=False, n_data=args.n_data)
    lite_p = T2Params(fft_mode=_FFT[args.lite_fft or args.fft],
                      guard=_GI[args.guard],
                      pilot_pattern=PilotPattern(args.pp - 1),
                      extended_carrier=False, n_data=args.lite_n_data,
                      preamble=Preamble.T2_LITE_SISO)
    base_plp = PLPParams(constellation=_MOD[args.mod], rate=_RATE[args.rate],
                         fec_frame=FECFrame.SHORT,
                         num_blocks_max=args.blocks, time_il_length=1)
    lite_plp = PLPParams(constellation=_MOD[args.lite_mod],
                         rate=_RATE[args.lite_rate],
                         fec_frame=FECFrame.SHORT, rotated=False,
                         num_blocks_max=args.lite_blocks, time_il_length=1)
    m = BaseLiteMux.auto(base_p, [base_plp], lite_p, [lite_plp],
                         interval=args.interval)
    tsb = np.fromfile(args.ts_base, dtype=np.uint8)
    tsl = np.fromfile(args.ts_lite, dtype=np.uint8)
    samples, base_out, lite_out = m.modulate(tsb, tsl, args.frames)
    iqio.write_iq(args.iq_output, samples, args.format)
    print(f"wrote {len(samples)} samples: {args.frames} base frames + "
          f"{lite_out.n_frames} lite frames (FEF multiplex) -> "
          f"{args.iq_output}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
