"""Input synthesis and output checks for the receive superstep.

The headline mode (32K FFT, GI 1/128, PP7 extended carriers, 59 data
symbols, 256QAM C2/3 NORMAL; `headline_mode`); F frames modulated on the
host by the port's `T2Modulator` (`modulate`); impaired on the device by
the port's impairer with the JAX bench's constants (`impaired`); the
tracking state estimated by the product's acquisition
(`T2Receiver.refine_acquire`) on a 2-frame capture (`estimate_tracking`);
the TS reassembled by `bbframe.TSAssembler` (`reassemble_ts`); random LDPC
codewords (`codewords`).
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
# the JAX bench's impairments: CFO, sample-clock offset (ratio = 1 + SCO),
# DC relative to the clean rms, IQ gain imbalance and quadrature skew, phase
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


def impaired(frames, nvar_rel: float, generator: torch.Generator, device,
             echo: tuple[float, int] = (0.0, 0)):
    """(F, n) complex frames (numpy, or a complex tensor) -> raw (F, n_raw)
    planes on `device` with the JAX bench's impairments; AWGN at nvar_rel
    of the signal power (0: none) before the int16 ADC.  `echo` (amp,
    delay) adds a static echo delayed by `delay` elementary-rate samples
    before the impairer."""
    full = torch.as_tensor(frames).to(device)
    amp, delay = echo
    if delay > 0:
        delayed = torch.nn.functional.pad(full, (delay, 0))[:, :full.shape[1]]
        full = full + amp * delayed
    pad = 2 * HALF
    clean = torch.nn.functional.pad(
        torch.stack([full.real, full.imag], -1).float(), (0, 0, pad, 0))
    pwr = (clean ** 2).sum(-1).mean()
    n_raw = fdev.frontend_raw_len(full.shape[1], SCO, HALF)
    rms = torch.sqrt(pwr)
    dc = torch.stack([DC_RE * rms, DC_IM * rms])
    giq = torch.tensor([IQ_G, IQ_C], device=device)
    raw = fdev.make_impairer(n_raw, FS, half=HALF)(
        clean, CFO_HZ, 1 + SCO, PHASE0, dc, giq, generator,
        float(nvar_rel * pwr))
    return raw[..., 0].contiguous(), raw[..., 1].contiguous()


def estimate_tracking(frames, nvar_rel: float,
                      generator: torch.Generator, device):
    """The product's tracking state from an impaired contiguous capture of
    frames 0 and 1 (numpy, or a complex tensor on any device): acquisition
    + the streaming refine sequence on the host.  The capture comes to the
    host as f32 planes.
    -> (track (4,) f32 [cfo_hz, ratio, pos0, 0] on `device`,
    (cfo_hz, ratio, pos0) as floats)."""
    ar, ai = impaired(frames[:2].reshape(1, -1), nvar_rel, generator, device)
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
    """(F, k_bch // 8, B) descrambled BB bytes of consecutive frames
    (the superstep's uint8) -> the reassembled TS bytes."""
    asm = bbframe.TSAssembler()
    for f in range(byts.shape[0]):
        # one copy, the transpose's; a cast only where bytes come wider
        asm.push_frames(np.ascontiguousarray(byts[f].T, dtype=np.uint8))
    return asm.ts_bytes()


def codewords(frame: FECFrame, rate: CodeRate, b: int,
              seed: int) -> np.ndarray:
    """(b, n) uint8 random LDPC codewords."""
    code = ldpcmod.get_code(frame, rate)
    rng = np.random.default_rng(seed)
    return ldpcmod.encode(code, rng.integers(0, 2, (b, code.k)
                                             ).astype(np.uint8))
