"""Input synthesis and output checks for the receive superstep on the card.

What the repository's bench does around its timed superstep, for the
port: the headline mode (32K FFT, GI 1/128, PP7 extended carriers, 59 data
symbols, 256QAM C2/3 NORMAL, B=128); F distinct frames synthesised on the
device (`make_frame_synth`: frame f carries the FEC blocks rolled by f,
from one frame's ingredients probed through the modulator by
`probe_maps`), or frames modulated on the host by the port's `T2Modulator`
(`modulate`); impaired on the device by the port's impairer with the
bench's constants (`impaired`); the tracking state estimated by the
product's acquisition (`T2Receiver.refine_acquire`) on a 2-frame capture,
as the bench's `estimate_tracking` does; and the TS reassembled by
`bbframe.TSAssembler`.
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
from ..tx import frame as txframe
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


def probe_maps(p: T2Params, plp: PLPParams, l1_arr: np.ndarray,
               cells0: np.ndarray):
    """Probe the TX interleave+framing chain for the composed map.

    cells0: (nb, cpf) rotated/Q-delayed cells (tx.fec.plp_encode output).
    Returns (stream0 (nb*cpf,) complex, cellmap (len_frame, k_total) int64
    with -1 = overlay position, overlay (len_frame, k_total) complex).
    Asserts the decomposition reproduces the direct modulator's carriers.
    """
    nb, cpf = cells0.shape
    n_cells = nb * cpf
    probe_slice = txframe.interleave_plp_frame(
        plp, (np.arange(n_cells, dtype=np.float64) + 1.0
              ).astype(np.complex64).reshape(nb, cpf))
    carriers_probe = txframe.symbols_to_carriers(
        p, txframe.cells_to_symbols(
            p, txframe.build_frame_cells(p, l1_arr, [probe_slice])))
    overlay = txframe.symbols_to_carriers(
        p, txframe.cells_to_symbols(
            p, txframe.build_frame_cells(
                p, l1_arr, [np.zeros(n_cells, np.complex64)])))
    diff = carriers_probe - overlay
    is_cell = np.abs(diff) > 0.5
    cellmap = np.full(overlay.shape, -1, np.int64)
    cellmap[is_cell] = np.round(np.real(diff[is_cell])).astype(np.int64) - 1
    assert (np.sort(cellmap[is_cell]) == np.arange(n_cells)).all()
    # cross-check against the direct modulator path
    sl0 = txframe.interleave_plp_frame(plp, cells0)
    carriers_ref = txframe.symbols_to_carriers(
        p, txframe.cells_to_symbols(
            p, txframe.build_frame_cells(p, l1_arr, [sl0])))
    stream0 = cells0.reshape(-1)
    recon = overlay.copy()
    recon[is_cell] = recon[is_cell] + stream0[cellmap[is_cell]]
    assert np.allclose(recon, carriers_ref, atol=1e-5)
    return stream0, cellmap, overlay


def _int16(planes: np.ndarray, scale: float) -> np.ndarray:
    """The shipped coding of a complex array: re/im in a last axis of two,
    scaled so that the peak |plane| is 32000, rounded to int16."""
    return np.round(np.stack([planes.real, planes.imag], axis=-1)
                    / scale * 32000.0).astype(np.int16)


def make_frame_synth(p: T2Params, cpf: int, n_frames: int,
                     stream0: np.ndarray, cellmap: np.ndarray,
                     overlay: np.ndarray, p1: np.ndarray, device):
    """Device synthesis of F distinct frames from one frame's ingredients:
    frame f's codeword slot b carries codeword (b + f) mod nb, a valid
    DVB-T2 frame (the roll acts on whole FEC blocks before the cell and
    time interleavers, and rotation and Q-delay are per block).

    Returns (synth, ship).  `ship` holds the int16-coded ingredients on
    `device` (the JAX version's integers exactly): "stream" (nb*cpf, 2)
    rotated cells before the interleavers, "overlay" (len_frame, k_total,
    2) L1, pilots and dummy cells, "cmap" (len_frame*k_total,) int32 the
    carrier -> stream index map (-1: overlay) and "p1" (2048, 2).
    synth(ship) -> (F, frame_samples) complex64 on the ship's device."""
    s_scale = float(np.max(np.abs(np.stack([stream0.real, stream0.imag]))))
    o_scale = float(np.max(np.abs(np.stack([overlay.real, overlay.imag]))))
    p_scale = float(np.max(np.abs(np.stack([p1.real, p1.imag]))))
    ship = {k: torch.from_numpy(v).to(device) for k, v in (
        ("stream", _int16(stream0, s_scale)),
        ("overlay", _int16(overlay, o_scale)),
        ("cmap", cellmap.reshape(-1).astype(np.int32)),
        ("p1", _int16(p1, p_scale)))}
    n_cells = len(stream0)
    nb = n_cells // cpf
    if n_frames > nb:
        # rolls by nb or more repeat earlier frames' payloads
        raise ValueError(f"n_frames ({n_frames}) must be <= the FEC-block "
                         f"count ({nb}) for distinct per-frame rolls")
    g, n_fft, body_len = p.guard_size, p.fft_size, p.frame_samples - 2048
    right = n_fft - p.k_total - p.left_nulls

    def planes(v, scale):
        """int16 pairs -> complex64, each plane times the f32 scale."""
        s = torch.tensor(scale / 32000.0, dtype=torch.float32)
        return torch.complex(v[..., 0].float() * s.to(v.device),
                             v[..., 1].float() * s.to(v.device))

    def synth(ship):
        dev = ship["cmap"].device
        cmap = ship["cmap"].long()
        overlay_c = planes(ship["overlay"], o_scale).reshape(-1)
        stream = planes(ship["stream"], s_scale)
        neg = cmap < 0
        safe = cmap.clamp(min=0)
        out = torch.empty((n_frames, p.frame_samples), dtype=torch.complex64,
                          device=dev)
        out[:, :2048] = planes(ship["p1"], p_scale)
        for f in range(n_frames):
            # frame f's stream is stream0 rolled by f codewords
            data = stream[(safe + f * cpf) % n_cells]
            car = torch.where(neg, overlay_c, data).reshape(p.len_frame,
                                                            p.k_total)
            spec = torch.roll(torch.nn.functional.pad(
                car, (p.left_nulls, right)), -(n_fft // 2), dims=1)
            sym = torch.fft.ifft(spec, dim=1) * torch.tensor(
                n_fft / np.sqrt(p.k_total), dtype=torch.float32, device=dev)
            out[f, 2048:] = torch.cat([sym[:, -g:], sym], 1).reshape(body_len)
        return out

    return synth, ship


def impaired(frames, nvar_rel: float, generator: torch.Generator, device,
             echo: tuple[float, int] = (0.0, 0), impair: bool = True):
    """(F, n) complex frames (numpy, or a complex tensor) -> raw (F, n_raw)
    planes on `device` with the bench's impairments; AWGN at nvar_rel of
    the signal power (0: none) before the int16 ADC.  `echo` (amp, delay)
    adds a static echo delayed by `delay` elementary-rate samples before
    the impairer.  impair=False keeps the clean samples behind the 2*HALF
    pre-pad (read them at pos0 = 2*HALF, ratio 1, no CFO) and adds only
    the AWGN."""
    full = torch.as_tensor(frames).to(device)
    amp, delay = echo
    if delay > 0:
        delayed = torch.nn.functional.pad(full, (delay, 0))[:, :full.shape[1]]
        full = full + amp * delayed
    pad = 2 * HALF
    clean = torch.nn.functional.pad(
        torch.stack([full.real, full.imag], -1).float(), (0, 0, pad, 0))
    pwr = (clean ** 2).sum(-1).mean()
    if not impair:
        if nvar_rel > 0:
            clean = clean + torch.randn(
                clean.shape, generator=generator, device=clean.device) \
                * torch.sqrt(nvar_rel * pwr / 2.0)
        return clean[..., 0].contiguous(), clean[..., 1].contiguous()
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
    frames 0 and 1 (numpy, or a tensor such as `make_frame_synth`'s
    output): acquisition + the streaming refine sequence on the host.  The
    capture comes to the host as f32 planes (the JAX bench fetches f16 to
    halve its transfer through the TPU's host link).
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
