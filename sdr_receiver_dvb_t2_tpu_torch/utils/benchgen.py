"""Input synthesis and output checks for the receive superstep on the card.

What the repository's bench does around its timed superstep, for the
port: the headline mode (32K FFT, GI 1/128, PP7 extended carriers, 59 data
symbols, 256QAM C2/3 NORMAL, B=128), frames modulated on the host by the
port's `T2Modulator` (`tx/modulator.py`), impaired on the device by the port's
impairer with the bench's constants, the tracking state estimated by the
product's acquisition (`T2Receiver.refine_acquire`) on a 2-frame capture as
the bench's `estimate_tracking` does, and the TS reassembled by
`bbframe.TSAssembler`.  The JAX bench instead synthesizes F distinct frames
on the device (`utils/benchgen.make_frame_synth`); that is not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from ..dvbt2 import bbframe
from ..dvbt2 import ldpc as ldpcmod
from ..dvbt2.params import (
    CodeRate, Constellation, FECFrame, FFTMode, GuardInterval, PilotPattern,
    PLPParams, T2Params)
from ..rx.receiver import T2Receiver
from ..tx.modulator import T2Modulator

from ..ops import frontend_device as fdev
from ..rx.superstep import HALF

FS = 9.142857e6                # elementary sample rate (8 MHz channel)
# the bench's impairments: CFO, sample-clock offset (ratio = 1 + SCO), DC
# relative to the clean rms, IQ gain imbalance and quadrature skew, phase
CFO_HZ = 1200.0
SCO = 2.2e-5
DC_RE, DC_IM = 0.02, -0.015
IQ_G, IQ_C = 1.02, 0.012
PHASE0 = 0.35


def headline_mode(num_blocks: int = 128) -> tuple[T2Params, PLPParams]:
    p = T2Params(fft_mode=FFTMode.FFT_32K, guard=GuardInterval.GI_1_128,
                 pilot_pattern=PilotPattern.PP7, extended_carrier=True,
                 n_data=59)
    plp = PLPParams(constellation=Constellation.QAM256, rate=CodeRate.C2_3,
                    fec_frame=FECFrame.NORMAL, num_blocks_max=num_blocks,
                    time_il_length=1)
    return p, plp


def modulate(p: T2Params, plp: PLPParams, n_frames: int, seed: int = 0):
    """Modulate a random TS into n_frames frames on the host.
    -> (ts (bytes,) uint8, frames (F, frame_samples) complex64,
        rows (F, B, k_bch // 8) uint8: each frame's BB-frame bytes)."""
    rows = []
    mod = T2Modulator(p, [plp], bb_tap=lambda fi, pid, bb: rows.append(
        np.packbits(bb, axis=1)))
    rng = np.random.default_rng(seed)
    ts = rng.integers(0, 256, (mod.packets_needed(n_frames) + 4, 188)
                      ).astype(np.uint8)
    ts[:, 0] = 0x47
    out = mod.modulate(ts.reshape(-1), n_frames)
    return ts.reshape(-1), np.stack(out.frames), np.stack(rows)


def impaired(frames: np.ndarray, nvar_rel: float,
             generator: torch.Generator, device):
    """(F, n) complex frames -> raw (F, n_raw) planes on `device` with the
    bench's impairments; AWGN at nvar_rel of the signal power (0: none)
    before the int16 ADC."""
    pad = 2 * HALF
    n_raw = int(np.ceil((frames.shape[1] + pad) * (1 + SCO))) + 4 * HALF
    clean = torch.from_numpy(np.stack([frames.real, frames.imag], -1)
                             .astype(np.float32)).to(device)
    clean = torch.nn.functional.pad(clean, (0, 0, pad, 0))
    pwr = (clean ** 2).sum(-1).mean()
    rms = torch.sqrt(pwr)
    dc = torch.stack([DC_RE * rms, DC_IM * rms])
    giq = torch.tensor([IQ_G, IQ_C], device=device)
    raw = fdev.make_impairer(n_raw, FS, half=HALF)(
        clean, CFO_HZ, 1 + SCO, PHASE0, dc, giq, generator,
        float(nvar_rel * pwr))
    return raw[..., 0].contiguous(), raw[..., 1].contiguous()


def estimate_tracking(frames: np.ndarray, nvar_rel: float,
                      generator: torch.Generator, device):
    """The product's tracking state from an impaired contiguous capture of
    frames 0 and 1: acquisition + the streaming refine sequence on the
    host.  -> (track (4,) f32 [cfo_hz, ratio, pos0, 0] on `device`,
    (cfo_hz, ratio, pos0) as floats)."""
    ar, ai = impaired(np.concatenate(frames[:2])[None], nvar_rel, generator,
                      device)
    x = (ar[0].cpu().numpy() + 1j * ai[0].cpu().numpy()).astype(np.complex64)
    # DC: the superstep estimates it on the device
    ls, cfo, ratio, _ = T2Receiver(fs=FS).refine_acquire(x - x.mean())
    if ls is None:
        raise RuntimeError("acquisition failed to lock")
    # the Farrow stencil reaches HALF samples left of the read position
    pos0 = max(float(ls.frame_start) * ratio, float(HALF))
    return (torch.tensor([cfo, ratio, pos0, 0.0], device=device),
            (cfo, ratio, pos0))


def reassemble_ts(byts: np.ndarray) -> np.ndarray:
    """(F, k_bch // 8, B) descrambled BB bytes of consecutive frames ->
    the reassembled TS bytes."""
    asm = bbframe.TSAssembler()
    for f in range(byts.shape[0]):
        asm.push_frames(np.ascontiguousarray(byts[f].astype(np.uint8).T))
    return asm.ts_bytes()


def codewords(frame: FECFrame, rate: CodeRate, b: int,
              seed: int) -> np.ndarray:
    """(b, n) uint8 random LDPC codewords."""
    code = ldpcmod.get_code(frame, rate)
    rng = np.random.default_rng(seed)
    return ldpcmod.encode(code, rng.integers(0, 2, (b, code.k)
                                             ).astype(np.uint8))
