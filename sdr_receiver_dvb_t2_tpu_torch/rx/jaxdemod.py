"""The v1 per-frame demod path: frame samples -> codeword LLRs, in plain
PyTorch.

Port of `sdr_receiver_dvb_t2_tpu/rx/jaxdemod.py`; the module keeps the JAX
package's name so that a reader finds its counterpart, but nothing in it
is JAX.  It is the path the v1 sharded step runs
(`parallel/sharding.sharded_receive_step`, part 2 of `dryrun`); the
receivers and the bench run `rx/fusedpath.py`.

  - `FrameDemod` (one frame): GI strip, one batched complex FFT over the
    frame's symbols, fftshift and the active carriers, then per group of
    symbols with identical tables (P2 / data / frame closing): the pilot
    estimate over the BPSK references, linear interpolation through the
    host-built stencils (`_interp_stencil`, shared with
    `rx/fusedpath.py`), the one-tap complex division, the data-carrier and
    frequency-deinterleave gathers, the frame's cells concatenated;
  - `PLPDecodePath` (one PLP at a fixed num_blocks): the TI inverse
    gather, the rotation with its cyclic Q-delay, separable max-log LLRs
    over each axis's PAM levels, and the bit-deinterleave gather to
    (nb, n_ldpc).

Both work on f32 (re, im) pairs, as the JAX entry points do; `fn` runs on
the device its input lies on, `__call__` takes host arrays and a device.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from .._device import DeviceConst, resolve
from ..dvbt2 import interleavers, tables
from ..dvbt2.params import PLPParams, T2Params
from . import demod as npdemod
from .fusedpath import _interp_stencil

_INF = np.float32(1e30)


@dataclass
class _SymGroup:
    rows: DeviceConst         # symbol indices in the frame
    pilot_pos: DeviceConst    # (g, n_pilots)
    pilot_ref: DeviceConst    # (g, n_pilots) f32 (BPSK: imag == 0)
    data_pos: DeviceConst     # (g, n_data)
    rx_gather: DeviceConst    # (g, n_data)
    il: tuple                 # interp stencils (g, k_total) x3


class FrameDemod:
    """Tables and the samples -> cells pipeline of one mode."""

    def __init__(self, p: T2Params):
        self.p = p
        tabs = npdemod.pilot_tables(p)
        groups = []
        # group symbols with identical table shapes: P2s / plain data / FC
        n_plain = p.n_data - (1 if p.has_fc else 0)
        spans = [list(range(p.n_p2)),
                 list(range(p.n_p2, p.n_p2 + n_plain))]
        if p.has_fc:
            spans.append([p.len_frame - 1])
        for rows in spans:
            if not rows:
                continue

            def dc(key, dtype=np.int64):
                return DeviceConst(np.stack(
                    [tabs[r][key] for r in rows]).astype(dtype))
            st = [np.stack(x) for x in zip(
                *[_interp_stencil(tabs[r]["pilot_pos"], p.k_total)
                  for r in rows])]
            groups.append(_SymGroup(
                DeviceConst(np.array(rows, np.int64)), dc("pilot_pos"),
                DeviceConst(np.stack([np.real(tabs[r]["pilot_ref"])
                                      for r in rows]).astype(np.float32)),
                dc("data_pos"), dc("rx_gather"),
                (DeviceConst(st[0].astype(np.int64)),
                 DeviceConst(st[1].astype(np.int64)), DeviceConst(st[2]))))
        self.groups = groups

    def fn(self, body2: torch.Tensor) -> torch.Tensor:
        """body2: (len_frame*symbol_size, 2) f32 -> cells (n, 2) f32, on
        body2's device."""
        p, dev = self.p, body2.device
        body = torch.complex(body2[:, 0].float(), body2[:, 1].float())
        sym = body.reshape(p.len_frame, p.symbol_size)[:, p.guard_size:]
        spec = torch.fft.fftshift(torch.fft.fft(sym, dim=1), dim=1)
        carriers = spec[:, p.left_nulls:p.left_nulls + p.k_total]
        cells = []
        for g in self.groups:
            rowsc = carriers[g.rows.on(dev)]                  # (g, k_total)
            est_p = (torch.gather(rowsc, 1, g.pilot_pos.on(dev))
                     / g.pilot_ref.on(dev))
            il, ir, w = (t.on(dev) for t in g.il)
            est = (torch.gather(est_p, 1, il) * (1 - w)
                   + torch.gather(est_p, 1, ir) * w)
            eq = rowsc / est
            data = torch.gather(eq, 1, g.data_pos.on(dev))
            deint = torch.gather(data, 1, g.rx_gather.on(dev))
            cells.append(deint.reshape(-1))
        out = torch.cat(cells)
        return torch.stack([out.real, out.imag], -1)

    def __call__(self, frame_body: np.ndarray, device="cuda") -> np.ndarray:
        """frame_body: (len_frame*symbol_size,) complex64 (P1 stripped) on
        the host -> (cells_per_frame,) complex64 on the host, computed on
        `device`."""
        dev = resolve(device, "FrameDemod")
        pair = np.stack([np.real(frame_body), np.imag(frame_body)],
                        axis=-1).astype(np.float32)
        out = self.fn(torch.from_numpy(pair).to(dev)).cpu().numpy()
        return (out[:, 0] + 1j * out[:, 1]).astype(np.complex64)


class PLPDecodePath:
    """Cells -> codeword LLRs of one PLP at a fixed num_blocks."""

    def __init__(self, plp: PLPParams, num_blocks: int):
        self.plp = plp
        self.num_blocks = num_blocks
        cpf = plp.cells_per_fec_block
        from .decode import _ti_inverse_perm
        from ..tx.frame import ti_blocks_split
        n_ti = max(1, plp.time_il_length if plp.time_il_type == 0 else 1)
        perms = []
        off = 0
        for nb in ti_blocks_split(num_blocks, n_ti):
            if nb == 0:
                continue
            perms.append(_ti_inverse_perm(cpf, nb) + off)
            off += nb * cpf
        self.ti_perm = np.concatenate(perms)
        fec = plp.fec
        addr = interleavers.bit_interleaver_perm(plp.constellation,
                                                plp.fec_frame, plp.rate)
        pperm = interleavers.parity_interleaver_perm(fec.n_ldpc, fec.k_ldpc,
                                                    fec.q_ldpc)
        g = pperm[addr]                      # TX: v = cw[g]
        g_inv = np.empty_like(g)
        g_inv[g] = np.arange(len(g), dtype=np.int32)
        self.bit_gather = g                  # RX gather: cw = v[g_inv]
        self.bit_inv = g_inv
        self.pts = tables.constellation_points(plp.constellation)
        self.rot = np.exp(-1j * tables.ROTATION_ANGLE[plp.constellation]) \
            if plp.rotated else 1.0
        # separable demap: square gray QAM -> per-axis PAM levels; I
        # carries the even cell-word bits (y0, y2, ..), Q the odd ones
        m = plp.bits_per_cell
        half = m // 2
        levels = (tables._gray_levels(m) * tables.NORM_FACTOR[
            plp.constellation]).astype(np.float32)
        words = np.arange(len(levels))
        self._levels = DeviceConst(levels)
        self._masks = DeviceConst(np.stack(
            [(words >> (half - 1 - b)) & 1 for b in range(half)]
        ).astype(bool))                                  # (half, 2^half)
        self._ti_perm = DeviceConst(self.ti_perm.astype(np.int64))
        self._bit_inv = DeviceConst(self.bit_inv.astype(np.int64))

    def _axis_llrs(self, x, inv_nvar):
        """x: (n,) PAM observations -> (n, half) LLRs."""
        dev = x.device
        lv, masks = self._levels.on(dev), self._masks.on(dev)
        d2 = (x[:, None] - lv[None, :]) ** 2             # (n, 2^half)
        inf = torch.tensor(_INF, device=dev)
        out = []
        for mb in masks:
            d0 = torch.where(mb[None, :], inf, d2).min(1).values
            d1 = torch.where(mb[None, :], d2, inf).min(1).values
            out.append((d1 - d0) * inv_nvar)
        return torch.stack(out, 1)

    def fn(self, slice2: torch.Tensor, inv_nvar) -> torch.Tensor:
        """slice2: (n_cells, 2) f32 -> (nb, n_ldpc) f32 LLRs, on slice2's
        device."""
        plp, dev = self.plp, slice2.device
        nb, cpf, m = self.num_blocks, plp.cells_per_fec_block, \
            plp.bits_per_cell
        inv = torch.as_tensor(inv_nvar, dtype=torch.float32, device=dev)
        cells = slice2[self._ti_perm.on(dev)]
        re = cells[:, 0].reshape(nb, cpf)
        im = cells[:, 1].reshape(nb, cpf)
        if plp.rotated:
            rot_re = float(np.float32(np.real(self.rot)))
            rot_im = float(np.float32(np.imag(self.rot)))
            im = torch.roll(im, -1, -1)
            re, im = (re * rot_re - im * rot_im, re * rot_im + im * rot_re)
        flat_re, flat_im = re.reshape(-1), im.reshape(-1)
        li = self._axis_llrs(flat_re, inv)               # (n, half)
        lq = self._axis_llrs(flat_im, inv)
        # interleave: y0 from I, y1 from Q, y2 from I, ...
        v = torch.stack([li, lq], 2).reshape(flat_re.shape[0], m)
        return v.reshape(nb, cpf * m)[:, self._bit_inv.on(dev)]

    def __call__(self, slice_cells: np.ndarray, inv_nvar,
                 device="cuda") -> torch.Tensor:
        """slice_cells: (num_blocks*cells_per_fec,) complex on the host ->
        (nb, n_ldpc) f32 LLRs on `device`."""
        dev = resolve(device, "PLPDecodePath")
        pair = np.stack([np.real(slice_cells), np.imag(slice_cells)],
                        axis=-1).astype(np.float32)
        return self.fn(torch.from_numpy(pair).to(dev), inv_nvar)


@functools.lru_cache(maxsize=None)
def get_frame_demod(p: T2Params) -> FrameDemod:
    return FrameDemod(p)


@functools.lru_cache(maxsize=None)
def get_plp_path(plp: PLPParams, num_blocks: int) -> PLPDecodePath:
    return PLPDecodePath(plp, num_blocks)
