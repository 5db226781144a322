"""The benchmark's input generator: frames synthesised on the card and
impaired there, from one frame's ingredients encoded on the host.

A frozen copy of what the port's bench does around its timed step
(`sdr_receiver_dvb_t2_tpu_torch/utils/benchgen.py`: `probe_maps`,
`make_frame_synth`, `impaired`) and of the impairment model it uses
(`ops/frontend_device.py`: the generalized-Farrow bank, the chunked
resampler, `_mod2pi_prod`, `make_impairer`).  It imports nothing of the
program: the host transmitter and the standard's tables are the copies in
`gen/tx/` and `gen/dvbt2/`.  Deliberate differences from the originals:
`make_frame_synth`'s synth takes a roll offset (frame f carries the FEC
blocks rolled by f + offset, so two step inputs of one pool differ in
every frame), `probe_maps` skips the second direct-modulator chain it
used as a self-check (`tests/test_rxbench_gen.py` keeps that check), and
the base frame's ingredients come from `base_frame`.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .dvbt2 import bbframe, bch, interleavers, ldpc, l1 as l1mod
from .dvbt2.params import (
    CodeRate, Constellation, FECFrame, FFTMode, GuardInterval, PilotPattern,
    PLPParams, T2Params)
from .tx import fec as txfec
from .tx import frame as txframe
from .tx import ofdm as txofdm
from .tx.modulator import T2Modulator

FS = 9.142857e6                # elementary sample rate (8 MHz channel)
HALF = 8                       # Farrow half-width (17 taps)
# the bench's impairments: CFO, sample-clock offset (ratio = 1 + SCO), DC
# relative to the clean rms, IQ gain imbalance and quadrature skew, phase
CFO_HZ = 1200.0
SCO = 2.2e-5
DC_RE, DC_IM = 0.02, -0.015
IQ_G, IQ_C = 1.02, 0.012
PHASE0 = 0.35
# tracking state the front end would need with no estimation error:
# [cfo_hz, ratio, pos0, phase0]
TRUTH = (CFO_HZ, 1.0 + SCO, HALF * (1.0 + SCO), PHASE0)


def mode(cfg: dict) -> tuple[T2Params, PLPParams]:
    """A configuration file's `mode` -> the generator's (T2Params,
    PLPParams); enum fields by member name."""
    m = cfg["mode"]
    p = T2Params(fft_mode=FFTMode[m["fft_mode"]],
                 guard=GuardInterval[m["guard"]],
                 pilot_pattern=PilotPattern[m["pilot_pattern"]],
                 extended_carrier=bool(m["extended_carrier"]),
                 n_data=int(m["n_data"]))
    plp = PLPParams(constellation=Constellation[m["constellation"]],
                    rate=CodeRate[m["rate"]],
                    fec_frame=FECFrame[m["fec_frame"]],
                    rotated=bool(m["rotated"]),
                    num_blocks_max=int(m["num_blocks"]),
                    time_il_length=int(m["time_il_length"]))
    return p, plp


def fec_blocks_per_frame(p: T2Params, plp: PLPParams) -> int:
    """The FEC blocks that fill a frame: the frame's cells less the L1
    signalling, over the cells of one block."""
    pre, _ = l1mod.build_l1(p, [plp])
    l1_cells = l1mod.L1_PRE_CELLS + pre.l1_post_size
    return (p.cells_per_frame - l1_cells) // plp.cells_per_fec_block


def probe_maps(p: T2Params, plp: PLPParams, l1_arr: np.ndarray,
               cells0: np.ndarray):
    """Probe the TX interleave+framing chain for the composed map.

    cells0: (nb, cpf) rotated/Q-delayed cells (tx.fec.plp_encode output).
    Returns (stream0 (nb*cpf,) complex, cellmap (len_frame, k_total) int64
    with -1 = overlay position, overlay (len_frame, k_total) complex)."""
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
    if not (np.sort(cellmap[is_cell]) == np.arange(n_cells)).all():
        raise RuntimeError("the probe does not map every PLP cell once")
    return cells0.reshape(-1), cellmap, overlay


def encode(plp: PLPParams, bb: np.ndarray):
    """(n, k_bch) unscrambled BB frames -> (rows (n, k_bch // 8) uint8 as
    the receiver's byte pack returns them, codewords (n, n_ldpc) uint8 in
    natural order, cells (n, cpf) complex: rotated and Q-delayed, before
    the cell and time interleavers)."""
    fec = plp.fec
    rows = np.packbits(bb, axis=1)
    scrambled = bbframe.scramble(bb)
    bch_cw = bch.encode(plp.fec_frame, scrambled, fec.t_bch)
    codewords = ldpc.encode(ldpc.get_code(plp.fec_frame, plp.rate), bch_cw)
    pperm = interleavers.parity_interleaver_perm(fec.n_ldpc, fec.k_ldpc,
                                                fec.q_ldpc)
    addr = interleavers.bit_interleaver_perm(plp.constellation,
                                            plp.fec_frame, plp.rate)
    return rows, codewords, txfec.map_cells(plp, codewords[:, pperm][:, addr])


class BaseFrame:
    """One frame's payload and ingredients, from a seed: a random TS
    through the mode adapter into nb BB frames, their codewords and cells,
    the L1 signalling, the composed carrier map and the P1 symbol.

    rows (nb, k_bch // 8) uint8: the BB frames' bytes as the receiver's
    byte pack returns them (unscrambled); codewords (nb, n_ldpc) uint8 in
    natural order (BCH codeword, then LDPC parity)."""

    def __init__(self, p: T2Params, plp: PLPParams, seed: int):
        self.p, self.plp = p, plp
        taps = []
        mod = T2Modulator(p, [plp], bb_tap=lambda fi, pid, bb: taps.append(bb))
        rng = np.random.default_rng(seed)
        ts = rng.integers(0, 256, (mod.packets_needed(1) + 4, 188)
                          ).astype(np.uint8)
        ts[:, 0] = 0x47
        out = mod.modulate(ts.reshape(-1), 1)
        self.rows, self.codewords, cells0 = encode(plp, taps[0])
        self.nb, self.cpf = cells0.shape
        self.l1_arr = np.concatenate([
            l1mod.l1pre_encode(out.l1pre),
            l1mod.l1post_encode(out.l1post_frames[0], mod.l1_post_mod)])
        self.stream0, self.cellmap, self.overlay = probe_maps(
            p, plp, self.l1_arr, cells0)
        self.p1 = txofdm.generate_p1(p)

    def slots(self, n_frames: int, offset: int) -> np.ndarray:
        """(F, nb) source block of each frame's codeword slot: frame f
        slot b carries block (b + f + offset) mod nb."""
        return (np.arange(self.nb)[None, :]
                + np.arange(n_frames)[:, None] + offset) % self.nb


def _int16(planes: np.ndarray, scale: float) -> np.ndarray:
    """re/im in a last axis of two, scaled so that the peak |plane| is
    32000, rounded to int16."""
    return np.round(np.stack([planes.real, planes.imag], axis=-1)
                    / scale * 32000.0).astype(np.int16)


def make_frame_synth(base: BaseFrame, n_frames: int, device):
    """Device synthesis of F distinct frames from one frame's ingredients.

    -> synth(offset) -> (F, frame_samples) complex64 on `device`: frame f
    carries the FEC blocks rolled by f + offset (a valid frame: the roll
    acts on whole blocks before the cell and time interleavers).  The
    ingredients ship as int16 (`_int16`), as the bench's do."""
    p, cpf = base.p, base.cpf
    stream0, cellmap, overlay, p1 = (base.stream0, base.cellmap,
                                     base.overlay, base.p1)
    s_scale = float(np.max(np.abs(np.stack([stream0.real, stream0.imag]))))
    o_scale = float(np.max(np.abs(np.stack([overlay.real, overlay.imag]))))
    p_scale = float(np.max(np.abs(np.stack([p1.real, p1.imag]))))
    ship = {k: torch.from_numpy(v).to(device) for k, v in (
        ("stream", _int16(stream0, s_scale)),
        ("overlay", _int16(overlay, o_scale)),
        ("cmap", cellmap.reshape(-1).astype(np.int32)),
        ("p1", _int16(p1, p_scale)))}
    n_cells = len(stream0)
    if n_frames > n_cells // cpf:
        raise ValueError(f"n_frames ({n_frames}) must be <= the FEC-block "
                         f"count ({n_cells // cpf}) for distinct frames")
    def synth(offset: int) -> torch.Tensor:
        dev = ship["cmap"].device
        cmap = ship["cmap"].long()
        overlay_c = _planes(ship["overlay"], o_scale).reshape(-1)
        stream = _planes(ship["stream"], s_scale)
        neg = cmap < 0
        safe = cmap.clamp(min=0)
        out = torch.empty((n_frames, p.frame_samples), dtype=torch.complex64,
                          device=dev)
        out[:, :2048] = _planes(ship["p1"], p_scale)
        for f in range(n_frames):
            data = stream[(safe + (f + offset) * cpf) % n_cells]
            out[f, 2048:] = _ofdm_body(p, torch.where(neg, overlay_c, data))
        return out

    return synth


def _planes(v: torch.Tensor, scale: float) -> torch.Tensor:
    """Shipped int16 re/im (`_int16`) back to complex64 at `scale`."""
    s = torch.tensor(scale / 32000.0, dtype=torch.float32, device=v.device)
    return torch.complex(v[..., 0].float() * s, v[..., 1].float() * s)


def _ofdm_body(p: T2Params, cells: torch.Tensor) -> torch.Tensor:
    """One frame's carriers ((len_frame * k_total,) complex, symbol-major)
    -> its samples after P1: each symbol's IFFT with its guard interval."""
    g, n_fft = p.guard_size, p.fft_size
    right = n_fft - p.k_total - p.left_nulls
    scale = torch.tensor(n_fft / np.sqrt(p.k_total), dtype=torch.float32,
                         device=cells.device)
    spec = torch.roll(torch.nn.functional.pad(
        cells.reshape(p.len_frame, p.k_total), (p.left_nulls, right)),
        -(n_fft // 2), dims=1)
    sym = torch.fft.ifft(spec, dim=1) * scale
    return torch.cat([sym[:, -g:], sym], 1).reshape(p.frame_samples - 2048)


def make_slot_synth(base: BaseFrame, cells: np.ndarray, device):
    """Device synthesis of frames whose FEC-block slots carry any rows of
    a table of blocks: base's frame (its L1, carrier map and P1) with slot
    b carrying `cells[sources[b]]` ((n, cpf) rotated, Q-delayed cells, as
    `encode` returns them; a valid frame, as in `make_frame_synth`).

    -> synth(sources (nb,) ints) -> (frame_samples,) complex64 on
    `device`.  The ingredients ship as int16, as `make_frame_synth`'s do."""
    p, cpf = base.p, base.cpf
    c_scale = float(np.max(np.abs(np.stack([cells.real, cells.imag]))))
    o_scale = float(np.max(np.abs(np.stack([base.overlay.real,
                                            base.overlay.imag]))))
    p_scale = float(np.max(np.abs(np.stack([base.p1.real, base.p1.imag]))))
    table = _planes(torch.from_numpy(_int16(cells.reshape(-1), c_scale)
                                     ).to(device), c_scale)
    overlay = _planes(torch.from_numpy(_int16(base.overlay, o_scale)
                                       ).to(device), o_scale).reshape(-1)
    p1 = _planes(torch.from_numpy(_int16(base.p1, p_scale)).to(device),
                 p_scale)
    cmap = torch.from_numpy(base.cellmap.reshape(-1)).to(device)
    neg = cmap < 0
    slot, within = cmap.clamp(min=0) // cpf, cmap.clamp(min=0) % cpf

    def synth(sources) -> torch.Tensor:
        src = torch.as_tensor(np.asarray(sources, np.int64), device=device)
        data = table[src[slot] * cpf + within]
        return torch.cat([p1, _ofdm_body(p, torch.where(neg, overlay,
                                                        data))])

    return synth


# --------------------------------------------------------------------------
# Impairment model (the inverse of the receiver's front end)
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def farrow_bank(half: int = HALF, deg: int = 7, m_max: float = 2.0):
    """Windowed-sinc interpolation taps fitted by per-tap polynomials in
    mu: taps j in [-half+1 .. half+1], weight f(j - m), f(d) = sinc(d) *
    cos^2(pi d / (2 (half+1))), each fitted over m in [0, m_max) by a
    degree-`deg` polynomial on Chebyshev nodes (highest degree first)."""
    j = np.arange(-half + 1, half + 2)
    support = half + 1
    nn = 64
    t = np.cos((2 * np.arange(nn) + 1) * np.pi / (2 * nn))
    m = (t + 1.0) * 0.5 * m_max
    d = j[None, :] - m[:, None]
    w = np.sinc(d) * np.cos(np.pi * d / (2.0 * support)) ** 2
    w[np.abs(d) >= support] = 0.0
    v = np.vander(m, deg + 1)
    coeffs, *_ = np.linalg.lstsq(v, w, rcond=None)
    return [[float(c) for c in coeffs[:, t]] for t in range(len(j))]


def _horner(cf_t: list, mu: torch.Tensor) -> torch.Tensor:
    wt = torch.full_like(mu, cf_t[0])
    for c in cf_t[1:]:
        wt = wt * mu + c
    return wt


def _mod2pi_prod(w: torch.Tensor, n: int) -> torch.Tensor:
    """(w * n) mod 2pi for a static int n < 2^24 and f32 w (a Dekker
    two-product and a 3-constant Cody-Waite reduction)."""
    two_pi = 2.0 * np.pi
    c1 = float(np.float32(6.28125))
    c2 = float(np.float32(two_pi - 6.28125))
    c3 = float(np.float32(two_pi - 6.28125 - float(np.float32(two_pi
                                                               - 6.28125))))
    t = w * 4097.0
    w_hi = t - (t - w)
    w_lo = w - w_hi
    n_hi = float(n & ~0xFFF)
    n_lo = float(n & 0xFFF)
    p = w * float(n)
    err = ((w_hi * n_hi - p) + w_hi * n_lo + w_lo * n_hi) + w_lo * n_lo
    k = torch.round(p / two_pi)
    return ((p - k * c1) + err) - k * c2 - k * c3


def _resample(x, n_out: int, ratio: float, pos0: float, chunk: int = 16384):
    """(F, n_in, 2) -> (F, n_out, 2): output k interpolates x at pos0 +
    k*ratio, in chunks whose stencil start is fixed (the drift folds into
    mu in [0, ~2))."""
    cf = farrow_bank()
    f, n_in, dev = x.shape[0], x.shape[1], x.device
    n_chunks = -(-n_out // chunk)
    slice_len = chunk + 2 * HALF + 2
    pad = n_chunks * chunk + slice_len - n_in + HALF
    x = torch.nn.functional.pad(x, (0, 0, 0, max(pad, 0)))
    ratio = torch.tensor(ratio, dtype=torch.float32, device=dev)
    delta = ratio - 1.0
    pos0 = torch.tensor(pos0, dtype=torch.float32, device=dev)
    k_local = torch.arange(chunk, dtype=torch.float32, device=dev)
    c = torch.arange(n_chunks, dtype=torch.float32, device=dev)
    r0 = pos0 + c * chunk * delta
    r = r0[:, None] + k_local * delta
    b = torch.floor(torch.minimum(r0, r0 + (chunk - 1) * delta))
    mu = r - b[:, None]
    s = (c * chunk + b).to(torch.int64) - (HALF - 1)
    s = s.clamp(0, x.shape[1] - slice_len)
    sl = x[:, s[:, None] + torch.arange(slice_len, device=dev)]
    acc = None
    for t, cf_t in enumerate(cf):
        term = sl[:, :, t:t + chunk] * _horner(cf_t, mu)[..., None]
        acc = term if acc is None else acc + term
    return acc.reshape(f, n_chunks * chunk, 2)[:, :n_out]


def raw_len(n_samp: int) -> int:
    """Raw device-rate samples a frame of n_samp elementary samples takes:
    the 2*HALF clean pre-pad and interpolation slack included."""
    return int(np.ceil((n_samp + 2 * HALF) * (1.0 + SCO))) + 4 * HALF


def impaired(frames: torch.Tensor, nvar_rel: float, generator, device,
             echo=(0.0, 0)):
    """(F, n) complex frames -> raw (F, n_raw) f32 planes on `device`: an
    optional static echo (amp, delay in elementary samples), resampled to
    the device rate (SCO), rotated by the CFO (the phase runs on across
    frames as in one capture), IQ imbalance, DC, AWGN at nvar_rel of the
    signal power (0: none), and the int16 ADC grid."""
    full = torch.as_tensor(frames).to(device)
    amp, delay = echo
    if delay > 0:
        delayed = torch.nn.functional.pad(full, (delay, 0))[:, :full.shape[1]]
        full = full + amp * delayed
    clean = torch.nn.functional.pad(
        torch.stack([full.real, full.imag], -1).float(), (0, 0, 2 * HALF, 0))
    pwr = (clean ** 2).sum(-1).mean()
    n_raw = raw_len(full.shape[1])
    f, dev = clean.shape[0], clean.device
    ratio = torch.tensor(1.0 + SCO, dtype=torch.float32, device=dev)
    x = _resample(clean, n_raw, float(1.0 / ratio), float(HALF))
    cfo = torch.tensor(CFO_HZ, dtype=torch.float32, device=dev)
    w = 2.0 * math.pi * cfo / (FS * ratio)
    m = torch.arange(n_raw, dtype=torch.float32, device=dev)
    base = PHASE0 + _mod2pi_prod(w, n_raw) * torch.arange(
        f, dtype=torch.float32, device=dev)
    ph = torch.remainder(base[:, None] + w * m[None, :], 2.0 * math.pi)
    cs, sn = torch.cos(ph), torch.sin(ph)
    i, q = x[..., 0], x[..., 1]
    i, q = i * cs - q * sn, q * cs + i * sn
    g = torch.tensor(IQ_G, device=dev)
    c = torch.tensor(IQ_C, device=dev)
    q = (q * torch.sqrt(1.0 - c * c) + c * i) / g
    rms = torch.sqrt(pwr)
    x = torch.stack([i, q], -1) + torch.stack([DC_RE * rms, DC_IM * rms])
    if nvar_rel > 0:
        noise = torch.randn(x.shape, generator=generator, device=dev)
        x = x + noise * torch.sqrt(nvar_rel * pwr / 2.0)
    s = 32000.0 / clean.abs().max()
    raw = torch.round(torch.clamp(x * s, -32767.0, 32767.0)) / s
    return raw[..., 0].contiguous(), raw[..., 1].contiguous()
