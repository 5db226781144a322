"""Modulator CLI: MPEG TS file -> DVB-T2 IQ capture.

    python -m sdr_receiver_dvb_t2_tpu_torch.tx.cli input.ts out.cf32 \
        --fft 32k --guard 1/128 --pp 7 --mod 256qam --rate 2/3 --frames 2
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from ..dvbt2.params import (CodeRate, Constellation, FECFrame, FFTMode,
                            GuardInterval, PilotPattern, PLPParams, T2Params)
from ..io import iq as iqio
from .modulator import T2Modulator

_FFT = {"1k": FFTMode.FFT_1K, "2k": FFTMode.FFT_2K, "4k": FFTMode.FFT_4K,
        "8k": FFTMode.FFT_8K, "16k": FFTMode.FFT_16K, "32k": FFTMode.FFT_32K}
_GI = {"1/4": GuardInterval.GI_1_4, "1/8": GuardInterval.GI_1_8,
       "1/16": GuardInterval.GI_1_16, "1/32": GuardInterval.GI_1_32,
       "1/128": GuardInterval.GI_1_128, "19/128": GuardInterval.GI_19_128,
       "19/256": GuardInterval.GI_19_256}
_MOD = {"qpsk": Constellation.QPSK, "16qam": Constellation.QAM16,
        "64qam": Constellation.QAM64, "256qam": Constellation.QAM256}
_RATE = {"1/2": CodeRate.C1_2, "3/5": CodeRate.C3_5, "2/3": CodeRate.C2_3,
         "3/4": CodeRate.C3_4, "4/5": CodeRate.C4_5, "5/6": CodeRate.C5_6}


def main(argv=None):
    ap = argparse.ArgumentParser(description="DVB-T2 modulator")
    ap.add_argument("ts_input")
    ap.add_argument("iq_output")
    ap.add_argument("--fft", choices=_FFT, default="32k")
    ap.add_argument("--guard", choices=_GI, default="1/128")
    ap.add_argument("--pp", type=int, default=7, help="pilot pattern 1-8")
    ap.add_argument("--extended", action="store_true", default=None)
    ap.add_argument("--mod", choices=_MOD, default="256qam")
    ap.add_argument("--rate", choices=_RATE, default="2/3")
    ap.add_argument("--short-fec", action="store_true")
    ap.add_argument("--no-rotation", action="store_true")
    ap.add_argument("--blocks", type=int, default=8,
                    help="FEC blocks per frame")
    ap.add_argument("--n-data", type=int, default=59,
                    help="data symbols per frame")
    ap.add_argument("--frames", type=int, default=1)
    ap.add_argument("--hem", action="store_true", help="high-efficiency mode")
    ap.add_argument("--inband", action="store_true",
                    help="carry in-band type-A signalling (clause 5.2.3) in "
                         "each Interleaving Frame's first BB frame")
    ap.add_argument("--fef", default=None, metavar="LEN[:INTERVAL[:TYPE]]",
                    help="insert FEF parts (clause 8.4): LEN elementary "
                         "periods incl. the FEF P1, after every INTERVAL-th "
                         "frame (default 2), signalled type TYPE (default 0)")
    ap.add_argument("--lite", action="store_true",
                    help="emit a T2-Lite profile signal (S1=T2-Lite "
                         "preamble); receive with t2rx --profile lite")
    ap.add_argument("--bandwidth", type=float, default=8.0,
                    choices=(1.7, 5.0, 6.0, 7.0, 8.0, 10.0),
                    help="channel bandwidth in MHz (sets the elementary "
                         "rate the capture plays at; sample-domain output "
                         "is bandwidth-invariant)")
    ap.add_argument("--format", choices=iqio.FORMATS, default=None)
    args = ap.parse_args(argv)

    fft = _FFT[args.fft]
    ext = args.extended
    if ext is None:
        ext = fft in (FFTMode.FFT_32K,)  # common broadcast config
    fef = None
    if args.fef:
        parts = [int(v) for v in args.fef.split(":")]
        fef = (parts[2] if len(parts) > 2 else 0,      # FEF_TYPE
               parts[0],                               # FEF_LENGTH
               parts[1] if len(parts) > 1 else 2)      # FEF_INTERVAL
    from ..dvbt2.params import Bandwidth, Preamble
    p = T2Params(fft_mode=fft, guard=_GI[args.guard],
                 pilot_pattern=PilotPattern(args.pp - 1),
                 extended_carrier=ext, n_data=args.n_data, fef=fef,
                 bandwidth=Bandwidth.from_mhz(args.bandwidth),
                 preamble=(Preamble.T2_LITE_SISO if args.lite
                           else Preamble.T2_SISO))
    plp = PLPParams(
        constellation=_MOD[args.mod], rate=_RATE[args.rate],
        fec_frame=FECFrame.SHORT if args.short_fec else FECFrame.NORMAL,
        rotated=not args.no_rotation, num_blocks_max=args.blocks,
        time_il_length=1, in_band_a=args.inband)
    mod = T2Modulator(p, [plp], hem=args.hem)

    ts = np.fromfile(args.ts_input, dtype=np.uint8)
    need = mod.packets_needed(args.frames)
    if len(ts) < need * 188:
        print(f"error: need {need} TS packets, file has {len(ts)//188}",
              file=sys.stderr)
        return 1
    out = mod.modulate(ts[:need * 188 + 188 * 4]
                       if len(ts) >= (need + 4) * 188 else ts, args.frames)
    iqio.write_iq(args.iq_output, out.samples, args.format)
    print(f"wrote {len(out.samples)} samples "
          f"({len(out.samples)/p.sample_rate:.3f} s of air time "
          f"@ {p.sample_rate/1e6:.4f} Msps) "
          f"-> {args.iq_output}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
