"""The plain reference that decides `correct`: what the receiver's front end
and its demod + LLR stage should give on one frame, worked out again in
float64 from the raw samples and the generator's truth.

It imports nothing of the program.  The standard's tables (pilot
references, constellation, bit interleaver) are the generator's copies
under `gen/dvbt2/`; where each PLP cell sits in the frame is the
generator's composed carrier map (`gen/synth.probe_maps`), not the
receiver's tables.  The tracking state [cfo_hz, ratio, pos0, phase0] it
reads the raw samples with is the generator's truth (`gen/synth.TRUTH`),
not the program's estimate: `band_err` compares the program's planes after
taking out what the receiver's pilots take out, and `check.timing_err`
holds the estimate itself.

- `frontend`: per-frame DC removal, the 1-bit IQ-imbalance correction,
  NCO derotation at the device rate with the phase running on across the
  frames of a step, and windowed-sinc interpolation (sinc(d) cos^2(pi d /
  18), |d| < 9, evaluated exactly) at the post-guard grid (p1 + l *
  symbol_size + guard + j) * ratio + pos0.
- `demod_llrs`: FFT, per-symbol least-squares pilot estimates, the [1, 2,
  1] / 4 smoother along the pilots (edges replicated), linear interpolation
  over carriers (edges clamped), one-tap equalization, the PLP cells by the
  generator's map, the cyclic Q-delay undone, the rotation undone, and
  max-log LLRs over the whole constellation (log P(0) - log P(1) scaled by
  1 / noise variance), in codeword order.

`quant`, when given, rounds every stored intermediate to that dtype (the
control: the same computation at a precision below the one the
configuration states)."""
from __future__ import annotations

import numpy as np
import torch

from .gen.dvbt2 import interleavers, tables
from .gen.dvbt2.params import SP_PATTERN, T2Params, PLPParams
from .gen.synth import HALF

P1_LEN = 2048
SUPPORT = HALF + 1            # the interpolator's half-width


def _q(x: torch.Tensor, quant) -> torch.Tensor:
    """x rounded to `quant` (fp8 saturates at its largest value)."""
    if quant is None:
        return x
    if x.is_complex():
        return torch.complex(_q(x.real, quant), _q(x.imag, quant))
    big = torch.finfo(quant).max
    return x.clamp(-big, big).to(quant).to(x.dtype)


def symbol_order(p: T2Params) -> np.ndarray:
    """The receiver's symbol emission order: P2 symbols even then odd,
    data symbols grouped by their scattered-pilot phase (l mod D_y), the
    frame-closing symbol last."""
    dy = SP_PATTERN[p.pilot_pattern][1]
    n_plain = p.n_data - (1 if p.has_fc else 0)
    rows = [j for j in range(p.n_p2) if j % 2 == 0]
    rows += [j for j in range(p.n_p2) if j % 2 == 1]
    for c in range(dy):
        rows += [p.n_p2 + i for i in range(n_plain) if (p.n_p2 + i) % dy == c]
    if p.has_fc:
        rows.append(p.len_frame - 1)
    return np.asarray(rows, np.int64)


def frontend(raw_r: torch.Tensor, raw_i: torch.Tensor, frame: int, track,
             p: T2Params, fs: float, quant=None) -> torch.Tensor:
    """One frame's raw planes (n_raw,) -> its GI-stripped symbols
    (len_frame, fft) complex128 in natural order.  `frame` is the frame's
    index in its step (the NCO phase runs on across frames); `track` is
    [cfo_hz, ratio, pos0, phase0]."""
    dev = raw_r.device
    cfo, ratio, pos0, phase0 = (float(v) for v in track)
    xr, xi = raw_r.double(), raw_i.double()
    n_in = xr.shape[0]
    i0, q0 = xr - xr.mean(), xi - xi.mean()
    ei, eq = i0.abs().mean(), q0.abs().mean()
    g = ei / eq
    c = (torch.sign(i0) * q0).mean() / ei
    q = (q0 * g - c * i0) / torch.sqrt(1.0 - c * c)
    w = 2.0 * np.pi * cfo / (fs * ratio)
    m = torch.arange(n_in, dtype=torch.float64, device=dev)
    phase = phase0 + w * (frame * n_in + m)
    x = torch.complex(i0, q) * torch.exp(-1j * phase)
    n_fft, g_len = p.fft_size, p.guard_size
    k = (P1_LEN + torch.arange(p.len_frame, device=dev)[:, None]
         * p.symbol_size + g_len
         + torch.arange(n_fft, device=dev)[None, :]).double()
    pos = k * ratio + pos0                             # (len_frame, fft)
    base = torch.floor(pos).long()
    out = torch.zeros(pos.shape, dtype=torch.complex128, device=dev)
    for j in range(-SUPPORT + 1, SUPPORT + 1):
        n = base + j
        d = n.double() - pos
        wt = torch.sinc(d) * torch.cos(np.pi * d / (2.0 * SUPPORT)) ** 2
        wt = torch.where(d.abs() < SUPPORT, wt, torch.zeros_like(wt))
        out += x[n.clamp(0, n_in - 1)] * wt
    return _q(out, quant)


class Demod:
    """The frame's pilot tables and PLP cell map, from the standard's
    tables and the generator's composed map (`cellmap` (len_frame,
    k_total): the PLP cell, slot * cpf + cell, each carrier holds, or -1)."""

    def __init__(self, p: T2Params, plp: PLPParams, cellmap: np.ndarray,
                 device):
        self.p, self.plp, self.dev = p, plp, device
        refs = list(tables.p2_pilot_refer(p))
        refs += list(tables.data_pilot_refer(p))
        if p.has_fc:
            refs.append(tables.fc_pilot_refer(p))
        self.refs = [np.asarray(r) for r in refs]       # len_frame rows
        self.nb = plp.num_blocks_max
        self.cpf = plp.cells_per_fec_block
        sel = cellmap >= 0
        self.cell_rows = torch.from_numpy(np.nonzero(sel)[0]).to(device)
        self.cell_cols = torch.from_numpy(np.nonzero(sel)[1]).to(device)
        self.cell_idx = torch.from_numpy(cellmap[sel]).to(device)
        fec = plp.fec
        pperm = interleavers.parity_interleaver_perm(fec.n_ldpc, fec.k_ldpc,
                                                    fec.q_ldpc)
        addr = interleavers.bit_interleaver_perm(plp.constellation,
                                                plp.fec_frame, plp.rate)
        # v-stream bit i carries codeword bit pperm[addr[i]]
        self.cw_of_v = torch.from_numpy(pperm[addr].astype(np.int64)).to(
            device)
        pts = tables.constellation_points(plp.constellation)
        self.pts_r = torch.from_numpy(pts.real.astype(np.float64)).to(device)
        self.pts_i = torch.from_numpy(pts.imag.astype(np.float64)).to(device)
        m = plp.bits_per_cell
        words = np.arange(len(pts))
        self.bit1 = torch.from_numpy(np.stack(
            [(words >> (m - 1 - b)) & 1 for b in range(m)]).astype(bool)
        ).to(device)
        self.rot = (np.exp(-1j * tables.ROTATION_ANGLE[plp.constellation])
                    if plp.rotated else 1.0)

    def carriers(self, sym: torch.Tensor, quant=None) -> torch.Tensor:
        """(len_frame, fft) symbols -> (len_frame, k_total) equalized
        carriers."""
        p = self.p
        spec = torch.fft.fftshift(torch.fft.fft(sym, dim=1), dim=1)
        car = _q(spec[:, p.left_nulls:p.left_nulls + p.k_total], quant)
        kk = torch.arange(p.k_total, dtype=torch.float64, device=self.dev)
        out = torch.empty_like(car)
        for row, ref in enumerate(self.refs):
            pos = np.nonzero(ref)[0]
            pt = torch.from_numpy(pos).to(self.dev)
            est = _q(car[row, pt] / torch.from_numpy(
                ref[pos].astype(np.complex128)).to(self.dev), quant)
            sm = torch.cat([est[:1], est, est[-1:]])
            est = _q(0.25 * sm[:-2] + 0.5 * sm[1:-1] + 0.25 * sm[2:], quant)
            # linear interpolation over carriers, edges held
            pf = pt.double()
            right = torch.searchsorted(pf, kk).clamp(max=len(pos) - 1)
            left = (right - 1).clamp(min=0)
            on = pf[right] == kk
            left = torch.where(on, right, left)
            span = pf[right] - pf[left]
            wr = ((kk - pf[left]) / torch.where(span == 0, 1.0, span)
                  ).clamp(0.0, 1.0)
            h = _q(est[left] * (1.0 - wr) + est[right] * wr, quant)
            out[row] = _q(car[row] / h, quant)
        return out

    def llrs(self, sym: torch.Tensor, inv_nvar: float,
             quant=None) -> torch.Tensor:
        """(len_frame, fft) symbols -> (n_ldpc, nb) LLRs, codeword order,
        slot b of the frame in column b."""
        plp, nb, cpf = self.plp, self.nb, self.cpf
        eq = self.carriers(sym, quant)
        cells = torch.empty(nb * cpf, dtype=eq.dtype, device=self.dev)
        cells[self.cell_idx] = eq[self.cell_rows, self.cell_cols]
        cells = cells.reshape(nb, cpf)
        if plp.rotated:
            z = torch.complex(cells.real, torch.roll(cells.imag, -1, 1))
            z = z * complex(self.rot)
        else:
            z = cells
        z = _q(z.reshape(-1), quant)
        m = plp.bits_per_cell
        v = torch.empty((z.shape[0], m), dtype=torch.float64,
                        device=self.dev)
        big = torch.tensor(float("inf"), dtype=torch.float64, device=self.dev)
        for lo in range(0, z.shape[0], 1 << 16):
            zc = z[lo:lo + (1 << 16)]
            d2 = ((zc.real[:, None] - self.pts_r) ** 2
                  + (zc.imag[:, None] - self.pts_i) ** 2)
            for b in range(m):
                d1 = torch.where(self.bit1[b], d2, big).min(1).values
                d0 = torch.where(self.bit1[b], big, d2).min(1).values
                v[lo:lo + (1 << 16), b] = (d1 - d0) * inv_nvar
        v = _q(v, quant).reshape(nb, cpf * m)
        out = torch.empty_like(v)
        out[:, self.cw_of_v] = v
        return out.T                                   # (n_ldpc, nb)


def band_err(got: torch.Tensor, ref: torch.Tensor, lo: int,
             hi: int) -> float:
    """||got - ref|| / ||ref|| over the carriers [lo, hi) of each row
    (bins of its centred FFT: the band the receiver demodulates), after
    each row of `got` (S, n) is turned by the common phase and shifted by
    the delay that bring it closest to `ref`'s row there: what the
    receiver's per-symbol pilots take out.  A tracking state's small CFO
    and timing errors leave a phase and a delay per symbol that grow over
    the frame (and the NCO's rounding of its rate a phase that grows over
    the frames of a step); what remains is what the pilots cannot take
    out: the drift of phase and timing within one symbol, and rounding.
    NaN when there is nothing to compare."""
    if got is None or got.shape != ref.shape:
        return float("nan")
    n = ref.shape[1]

    def band(x):
        return torch.fft.fftshift(torch.fft.fft(x, dim=1), dim=1)[:, lo:hi]
    g, r = band(got.to(ref.dtype)), band(ref)
    k = torch.arange(lo, hi, dtype=torch.float64, device=ref.device) - n // 2
    c = r * g.conj()
    # the cross-spectrum's phase slope (radians per bin): coarse from the
    # phase steps of neighbouring carriers, then twice a least-squares
    # line through its phase, each carrier weighted by its power
    slope = torch.angle((c[:, 1:] * c[:, :-1].conj()).sum(1, keepdim=True))
    w = c.abs()
    kw = k - (w * k).sum(1, keepdim=True) / w.sum(1, keepdim=True)
    for _ in range(2):
        cs = c * torch.exp(-1j * slope * k)
        zs = cs.sum(1, keepdim=True)
        th = torch.angle(cs * (zs.conj() / zs.abs().clamp(min=1e-300)))
        slope = slope + ((w * kw * th).sum(1, keepdim=True)
                         / (w * kw * kw).sum(1, keepdim=True))
    g = g * torch.exp(1j * slope * k)
    z = (r * g.conj()).sum(1, keepdim=True)
    g = g * (z / z.abs().clamp(min=1e-300))
    return float(torch.linalg.vector_norm(g - r)
                 / torch.linalg.vector_norm(r))


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """||got - ref|| / ||ref|| over all elements (complex or real); NaN
    when there is nothing to compare."""
    if got is None or got.shape != ref.shape:
        return float("nan")
    got = got.to(ref.dtype)
    return float(torch.linalg.vector_norm(got - ref)
                 / torch.linalg.vector_norm(ref))
