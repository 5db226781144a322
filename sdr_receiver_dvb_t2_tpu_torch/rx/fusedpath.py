"""Fused receive path: frame samples -> codeword LLRs in (n_ldpc, B)
layout.  Port of `sdr_receiver_dvb_t2_tpu/rx/fusedpath.py`:

  - `FusedFrameDemod` (one frame, SISO or MISO): the class tables, and its
    frame entry (`__call__`, JAX `_fn`): f32 FFT, fftshift, the active
    carriers, per-class strided symbol slices, pilot estimates, the SISO
    one-tap or the MISO Alamouti equalizer, the flat (total, 2) class
    layout that `layout` indexes;
  - `FusedPLPPath` (one PLP of one frame, JAX `_fn`): the composed cell
    gather (TI, type-2 sub-slices, cell and frequency deinterleave), the
    rotated Q-delay, masked-min max-log LLRs over the level table, the
    bit-deinterleave row gather to (n_ldpc, nb);
  - `MultiFramePath` (F frames, the frame axis minor in every array):
    the class-ordered `syms` entry (the comp-first SISO equalizer with the
    fftshift folded into the row tables), the `planes` and `__call__`
    entries on (F, len_frame*symbol_size) bodies, the paired (total, 2F)
    cell layout, one LLR tail per PLP (`ops/llr_tail.LLRTail`: K7 on the
    card), the L1 cells and the cell-weighted EVM.

The FFT is `torch.fft` (cuFFT on the card) in f32, cast to the demod dtype.
The table builds are the port's copies of `FusedFrameDemod.__init__`,
`_resolve_miso_partners` and `FusedPLPPath.__init__` (their module imports
jax); `_interp_stencil` is copied from `rx/jaxdemod.py` for the same reason.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..dvbt2 import interleavers, l1 as l1mod, tables
from ..dvbt2.params import PLPParams, T2Params
from ..rx import demod as npdemod
from ..rx.decode import _ti_inverse_perm
from ..tx.frame import ti_blocks_split

from .._device import DeviceConst
from ..ops.llr_tail import LLRTail
from ..utils.metrics import count


def _interp_stencil(pilot_pos: np.ndarray, k_total: int):
    """For each carrier k: (left_idx, right_idx, weight_right) into the
    pilot array, linear interpolation with edge clamping."""
    right = np.searchsorted(pilot_pos, np.arange(k_total), side="left")
    right = np.clip(right, 0, len(pilot_pos) - 1)
    left = np.clip(right - 1, 0, len(pilot_pos) - 1)
    on_pilot = pilot_pos[right] == np.arange(k_total)
    left = np.where(on_pilot, right, left)
    denom = (pilot_pos[right] - pilot_pos[left]).astype(np.float32)
    denom[denom == 0] = 1.0
    w = (np.arange(k_total) - pilot_pos[left]).astype(np.float32) / denom
    w = np.clip(w, 0.0, 1.0)
    return left.astype(np.int32), right.astype(np.int32), w


class _Class:
    """One symbol class: symbols with identical pilot/data tables."""

    def __init__(self, sym_cols, pilot_rows, inv_ref, stencil, comp_rows,
                 miso=None):
        self.sym_cols = sym_cols        # (nc,) symbol indices
        self.pilot_rows = pilot_rows    # (np_c,)
        self.inv_ref = inv_ref          # (np_c, nc) float32, 1/ref
        self.stencil = stencil          # (il, ir, w): row indices + weight
        self.comp_rows = comp_rows      # (n_data_c,) data rows, sorted
        self.miso = miso                # dict, see FusedFrameDemod
        il, ir, w = stencil
        wf = np.asarray(w).reshape(-1)
        # the interpolation stencil remapped to the composed data rows
        self.comp_stencil = (il[comp_rows], ir[comp_rows],
                             wf[comp_rows].reshape(-1, 1))
        self.pilot_rows_wrapped = None
        self.comp_rows_wrapped = None
        # classes are arithmetic progressions of symbol indices
        self.start = int(sym_cols[0])
        self.step = int(sym_cols[1] - sym_cols[0]) if len(sym_cols) > 1 else 1
        self.count = len(sym_cols)
        if not np.array_equal(np.asarray(sym_cols),
                              self.start + self.step * np.arange(self.count)):
            raise ValueError("a symbol class is not an arithmetic progression")


class FusedFrameDemod:
    """Class tables of one mode: `classes`, the host `layout` map (frame
    cell index -> flat class-output position), `sym_order` (the symbol
    emission order that makes each class contiguous), the fftshift-wrapped
    row tables and, for MISO, each class's channel sources.

    `demod(body2)`: (len_frame*symbol_size, 2) f32 body -> (total, 2) f32
    equalized cells in the flat class layout (JAX `_fn`)."""

    def __init__(self, p: T2Params):
        self.p = p
        if p.miso:
            tabs = npdemod.pilot_tables(dataclasses.replace(p, miso_group=0))
            tabs2 = npdemod.pilot_tables(dataclasses.replace(p, miso_group=1))
        else:
            tabs = npdemod.pilot_tables(p)
            tabs2 = None
        n_plain = p.n_data - (1 if p.has_fc else 0)
        dy = tables.SP_PATTERN[p.pilot_pattern][1]
        class_rows: list[list[int]] = []
        for rows in ([j for j in range(p.n_p2) if j % 2 == 0],
                     [j for j in range(p.n_p2) if j % 2 == 1]):
            if rows:
                class_rows.append(rows)
        for c in range(dy):
            rows = [p.n_p2 + i for i in range(n_plain)
                    if (p.n_p2 + i) % dy == c]
            if rows:
                class_rows.append(rows)
        if p.has_fc:
            class_rows.append([p.len_frame - 1])
        self.classes = []
        cells_per_sym = [len(tabs[r]["data_pos"]) for r in range(p.len_frame)]
        sym_cell_off = np.concatenate([[0], np.cumsum(cells_per_sym)])
        total = int(sym_cell_off[-1])
        layout = np.empty(total, dtype=np.int64)
        flat_off = 0
        for rows in class_rows:
            t0 = tabs[rows[0]]
            pilot_rows = t0["pilot_pos"]
            n_data_c = len(t0["data_pos"])
            nc = len(rows)
            inv_ref = np.stack(
                [1.0 / np.real(tabs[r]["pilot_ref"]).astype(np.float32)
                 for r in rows], axis=1)
            il, ir, w = _interp_stencil(pilot_rows, p.k_total)
            miso = None
            if p.miso:
                # the TX2 pilot-inversion subset depends on the carrier map
                # alone, identical for every symbol of a class
                inverted = np.real(tabs2[rows[0]]["pilot_ref"]
                                   * np.conj(t0["pilot_ref"])) < 0
                for r in rows[1:]:
                    inv_r = np.real(tabs2[r]["pilot_ref"]
                                    * np.conj(tabs[r]["pilot_ref"])) < 0
                    if not np.array_equal(inv_r, inverted):
                        raise ValueError("MISO inversions differ in a class")
                if n_data_c % 2:
                    raise ValueError("Alamouti pairs need even cells")
                miso = dict(inverted=inverted,
                            data_rows=t0["data_pos"].astype(np.int32))
            # data rows in sorted carrier order; the frequency deinterleave
            # folds into `layout` and rides the downstream cell gather
            rxg = t0["rx_gather"]
            for ci, r in enumerate(rows):
                f0 = sym_cell_off[r]
                layout[f0:f0 + n_data_c] = (flat_off
                                            + rxg.astype(np.int64) * nc + ci)
            self.classes.append(_Class(
                np.array(rows, np.int32), pilot_rows.astype(np.int32),
                inv_ref, (il, ir, w.reshape(-1, 1)),
                t0["data_pos"].astype(np.int32), miso=miso))
            flat_off += n_data_c * nc
        self.layout = layout
        self.total_cells = total
        self.sym_order = np.concatenate(
            [np.asarray(c.sym_cols) for c in self.classes]).astype(np.int32)
        # carrier row r lives at FFT output row (s0 + r) % fft
        s0 = (p.left_nulls - p.fft_size // 2) % p.fft_size
        for c in self.classes:
            c.pilot_rows_wrapped = ((s0 + c.pilot_rows) % p.fft_size
                                    ).astype(np.int32)
            c.comp_rows_wrapped = ((s0 + c.comp_rows) % p.fft_size
                                   ).astype(np.int32)
        if p.miso:
            self._resolve_miso_partners()
        self._consts: dict[int, list] = {}

    def _resolve_miso_partners(self):
        """For each class and each pilot subset (sum = non-inverted, dif =
        inverted), pick the channel source.  On data symbols the inversion
        parity equals the row parity, so one subset per class is just the
        few continual pilots; that subset's channel comes from the class of
        adjacent symbols, where it is dense, lane-aligned to the nearest
        partner symbol.  P2/FC classes stay self-contained."""
        p = self.p
        dx, dy = tables.SP_PATTERN[p.pilot_pattern]

        def density_ok(pos):
            return len(pos) >= 8 and int(np.diff(np.sort(pos)).max()) \
                <= 4 * dx * dy

        for ci, c in enumerate(self.classes):
            mi = c.miso
            inv = mi.pop("inverted")
            mi["self_idx"] = ci
            for side, mask in (("sum", ~inv), ("dif", inv)):
                sel = np.nonzero(mask)[0].astype(np.int32)
                pos = c.pilot_rows[mask]
                src_idx, lane_map, nc_src = None, None, None
                if not density_ok(pos):
                    best = None
                    for pj, pc in enumerate(self.classes):
                        if pj == ci or pc.miso is None:
                            continue
                        pinv = pc.miso.get("inverted")
                        if pinv is None:   # already resolved
                            pinv = pc.miso["_inv_cache"]
                        pmask = ~pinv if side == "sum" else pinv
                        ppos = pc.pilot_rows[pmask]
                        if not density_ok(ppos):
                            continue
                        dist = abs(int(pc.sym_cols[0]) - int(c.sym_cols[0]))
                        if best is None or dist < best[0]:
                            best = (dist, pj, pmask, ppos)
                    if best is not None:
                        _, pj, pmask, ppos = best
                        pc = self.classes[pj]
                        src_idx = pj
                        sel = np.nonzero(pmask)[0].astype(np.int32)
                        pos = ppos
                        lane_map = np.array(
                            [int(np.argmin(np.abs(
                                np.asarray(pc.sym_cols) - r)))
                             for r in c.sym_cols], np.int32)
                        nc_src = int(pc.count)
                il, ir, w = _interp_stencil(np.sort(pos), p.k_total)
                order = np.argsort(pos)
                mi[side] = dict(src_idx=src_idx, sel=sel[order],
                                stencil=(il, ir, w.reshape(-1, 1)),
                                lane_map=lane_map, nc_src=nc_src)
            mi["_inv_cache"] = inv

    def consts(self, rep: int) -> list:
        """The classes' device tables for `rep` frames folded into the lane
        axis."""
        if rep not in self._consts:
            self._consts[rep] = [_ClassConsts(c, rep) for c in self.classes]
        return self._consts[rep]

    def __call__(self, body2: torch.Tensor) -> torch.Tensor:
        p = self.p
        body = torch.complex(body2[:, 0].float(), body2[:, 1].float())
        sym = body.reshape(p.len_frame, p.symbol_size)[:, p.guard_size:]
        spec = torch.fft.fftshift(torch.fft.fft(sym, dim=1), dim=1)
        car = spec[:, p.left_nulls:p.left_nulls + p.k_total]
        xr, xi = car.real.T, car.imag.T                  # (k_total, n_sym)
        ccs = self.consts(1)
        dev = body2.device
        xs = [(xr[:, cc.cols.on(dev)], xi[:, cc.cols.on(dev)]) for cc in ccs]
        ests = None
        if p.miso:
            ests = [class_pilot_est(cc, a, b) for cc, (a, b) in zip(ccs, xs)]
        outs_r, outs_i = [], []
        for cc, (a, b) in zip(ccs, xs):
            er, ei = _eq_class_planar(cc, a, b, ests)
            outs_r.append(er.reshape(-1))
            outs_i.append(ei.reshape(-1))
        return torch.stack([torch.cat(outs_r), torch.cat(outs_i)], -1)


class FusedPLPPath:
    """One PLP of one frame: the composed cell gather `comp` (plain PLP
    cell -> class-flat position, with type-2 sub-slices), the bit
    deinterleave `bit_inv` and the constellation rotation `rot`.

    `path(flat2, inv_nvar)`: (total, 2) f32 class-layout cells ->
    (n_ldpc, nb) f32 LLRs (JAX `_fn`)."""

    def __init__(self, p: T2Params, plp: PLPParams, num_blocks: int,
                 demod: FusedFrameDemod, plp_start_cell: int = 0,
                 l1_cells: int | None = None, sub_slices: int = 1,
                 slice_interval: int = 0):
        self.plp = plp
        self.num_blocks = num_blocks
        cpf = plp.cells_per_fec_block
        n_ti = max(1, plp.time_il_length if plp.time_il_type == 0 else 1)
        perms = []
        off = 0
        for nb in ti_blocks_split(num_blocks, n_ti):
            if nb == 0:
                continue
            perms.append(_ti_inverse_perm(cpf, nb) + off)
            off += nb * cpf
        ti = np.concatenate(perms).astype(np.int64)
        if l1_cells is None:
            pre, _ = l1mod.build_l1(p, [plp])
            l1_cells = l1mod.L1_PRE_CELLS + pre.l1_post_size
        # plain-cell position of PLP-stream cell j: type-2 PLPs are cut
        # into sub_slices round-robin slices `slice_interval` cells apart
        n_cells = num_blocks * cpf
        j = np.arange(n_cells, dtype=np.int64)
        if sub_slices > 1:
            ln = n_cells // sub_slices
            substream = (plp_start_cell + (j // ln) * slice_interval
                         + (j % ln))
        else:
            substream = plp_start_cell + j
        self.comp = demod.layout[l1_cells + substream[ti]].astype(np.int32)
        fec = plp.fec
        addr = interleavers.bit_interleaver_perm(plp.constellation,
                                                plp.fec_frame, plp.rate)
        pperm = interleavers.parity_interleaver_perm(fec.n_ldpc, fec.k_ldpc,
                                                    fec.q_ldpc)
        g = pperm[addr]
        g_inv = np.empty_like(g)
        g_inv[g] = np.arange(len(g), dtype=np.int32)
        self.bit_inv = g_inv
        self.rot = np.exp(-1j * tables.ROTATION_ANGLE[plp.constellation]) \
            if plp.rotated else 1.0
        m = plp.bits_per_cell
        half = m // 2
        levels = (tables._gray_levels(m)
                  * tables.NORM_FACTOR[plp.constellation]).astype(np.float32)
        words = np.arange(len(levels))
        # axis_masks[b, level]: bit b of the level's Gray word is 1
        self._levels = DeviceConst(levels)
        self._masks = DeviceConst(np.stack(
            [(words >> (half - 1 - b)) & 1 for b in range(half)]
        ).astype(bool))
        self._comp = DeviceConst(self.comp.astype(np.int64))
        self._bit_inv = DeviceConst(self.bit_inv.astype(np.int64))

    def _axis_llrs(self, xax, inv_nvar):
        dev = xax.device
        levels, masks = self._levels.on(dev), self._masks.on(dev)
        d2 = (xax[:, None] - levels[None, :]) ** 2
        inf = torch.tensor(1e30, dtype=torch.float32, device=dev)
        out = []
        for mb in masks:
            d0 = torch.where(mb[None, :], inf, d2).min(1).values
            d1 = torch.where(mb[None, :], d2, inf).min(1).values
            out.append((d1 - d0) * inv_nvar)
        return torch.stack(out, 1)

    def __call__(self, flat2: torch.Tensor, inv_nvar) -> torch.Tensor:
        plp = self.plp
        nb, cpf = self.num_blocks, plp.cells_per_fec_block
        dev = flat2.device
        inv = torch.as_tensor(inv_nvar, dtype=torch.float32, device=dev)
        cells = flat2[self._comp.on(dev)]                # (nb*cpf, 2)
        re = cells[:, 0].reshape(nb, cpf)
        im = cells[:, 1].reshape(nb, cpf)
        if plp.rotated:
            rot_re = float(np.float32(np.real(self.rot)))
            rot_im = float(np.float32(np.imag(self.rot)))
            im = torch.roll(im, -1, -1)
            re, im = (re * rot_re - im * rot_im, re * rot_im + im * rot_re)
        li = self._axis_llrs(re.reshape(-1), inv)        # (n, half)
        lq = self._axis_llrs(im.reshape(-1), inv)
        v = torch.stack([li, lq], 2).reshape(nb, cpf * plp.bits_per_cell)
        return v.T[self._bit_inv.on(dev)]                # (n_ldpc, nb)


def _smooth_pilot_est(epr, epi):
    """3-tap [1,2,1]/4 smoothing along the pilot axis (edge-replicated)."""
    def sm(e):
        top = torch.cat([e[:1], e[:-1]])
        bot = torch.cat([e[1:], e[-1:]])
        return 0.25 * top + 0.5 * e + 0.25 * bot
    return sm(epr), sm(epi)


class _ClassConsts:
    """A class's tables on the device side of the equalizer, for `rep`
    frames folded into the lane axis."""

    def __init__(self, c: _Class, rep: int):
        def dc(a, dtype=np.int64):
            return DeviceConst(np.asarray(a, dtype))
        self.c, self.rep = c, rep
        self.cols = dc(c.sym_cols)
        self.iref = dc(np.repeat(c.inv_ref, rep, axis=1), np.float32)
        self.prow = dc(c.pilot_rows)
        self.drow = dc(c.comp_rows)
        self.prow_w = dc(c.pilot_rows_wrapped)
        self.drow_w = dc(c.comp_rows_wrapped)
        il, ir, w = c.comp_stencil
        self.il, self.ir, self.w = dc(il), dc(ir), dc(w, np.float32)
        self.miso = None
        if c.miso is not None:
            mi = c.miso
            self.miso = dict(self_idx=mi["self_idx"],
                             data_rows=dc(mi["data_rows"]))
            for side in ("sum", "dif"):
                s = mi[side]
                sil, sir, sw = s["stencil"]
                self.miso[side] = dict(
                    src_idx=s["src_idx"], nc_src=s["nc_src"], sel=dc(s["sel"]),
                    lane_map=(None if s["lane_map"] is None
                              else dc(s["lane_map"])),
                    il=dc(sil), ir=dc(sir), w=dc(sw, np.float32))


def class_pilot_est(cc: _ClassConsts, xcr, xci):
    """Pilot channel estimates of one class: (epr, epi) of
    (np_c, nc*rep), on carrier-ordered rows."""
    dev = xcr.device
    iref = cc.iref.on(dev).to(xcr.dtype)
    prow = cc.prow.on(dev)
    return xcr[prow] * iref, xci[prow] * iref


def _eq_class_comp(cc: _ClassConsts, xcr, xci, wrapped: bool):
    """SISO one-tap equalizer of one class: pilot estimates, the 3-tap
    smoother, linear interpolation evaluated only at the composed data
    rows, output in composed (sorted data carrier) order.  With wrapped,
    xcr/xci are the raw (fft, lanes) FFT output and the row tables carry
    the fftshift; otherwise they are (k_total, lanes) carrier rows.  The
    same arithmetic, element for element, as JAX `_eq_class_planar`'s SISO
    branch and `_eq_class_comp`."""
    dev, dt = xcr.device, xcr.dtype
    iref = cc.iref.on(dev).to(dt)
    prow = (cc.prow_w if wrapped else cc.prow).on(dev)
    epr = xcr[prow] * iref
    epi = xci[prow] * iref
    epr, epi = _smooth_pilot_est(epr, epi)
    il, ir = cc.il.on(dev), cc.ir.on(dev)
    w = cc.w.on(dev).to(dt)
    chr_ = epr[il] * (1.0 - w) + epr[ir] * w
    chi_ = epi[il] * (1.0 - w) + epi[ir] * w
    drow = (cc.drow_w if wrapped else cc.drow).on(dev)
    xdr = xcr[drow]
    xdi = xci[drow]
    inv = 1.0 / (chr_ * chr_ + chi_ * chi_)
    eqr = (xdr * chr_ + xdi * chi_) * inv
    eqi = (xdi * chr_ - xdr * chi_) * inv
    return eqr, eqi


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _eq_class_planar(cc: _ClassConsts, xcr, xci, ests=None):
    """Equalize one symbol class on (k_total, nc*rep) carrier rows ->
    (n_data_c, nc*rep) cells in sorted data-carrier order.

    SISO: `_eq_class_comp`.  MISO: the received pilots carry ref*(h1+h2) on
    non-inverted positions and ref*(h1-h2) on the TX2-inverted subset; each
    subset's channel comes from its source class (`ests`: every class's
    `class_pilot_est`), lane-aligned to the nearest partner symbol, and
    interpolated; adjacent data carriers form Alamouti pairs solved as a
    2x2 system (zero-forcing)."""
    mi = cc.miso
    if mi is None:
        return _eq_class_comp(cc, xcr, xci, wrapped=False)
    dev, dt = xcr.device, xcr.dtype
    rep = cc.rep
    own = ests[mi["self_idx"]] if ests is not None \
        else class_pilot_est(cc, xcr, xci)

    def subset_channel(sub):
        sr_, si_ = own if sub["src_idx"] is None else ests[sub["src_idx"]]
        sel = sub["sel"].on(dev)
        sr_, si_ = sr_[sel], si_[sel]
        if sub["lane_map"] is not None:
            # align partner symbols to this class's lanes (nearest row)
            lm = sub["lane_map"].on(dev)
            nc_src = sub["nc_src"]
            sr_ = sr_.reshape(sr_.shape[0], nc_src, rep)[:, lm, :].reshape(
                sr_.shape[0], -1)
            si_ = si_.reshape(si_.shape[0], nc_src, rep)[:, lm, :].reshape(
                si_.shape[0], -1)
        il, ir = sub["il"].on(dev), sub["ir"].on(dev)
        w = sub["w"].on(dev).to(dt)
        return (sr_[il] * (1.0 - w) + sr_[ir] * w,
                si_[il] * (1.0 - w) + si_[ir] * w)

    hs_r, hs_i = subset_channel(mi["sum"])
    hd_r, hd_i = subset_channel(mi["dif"])
    h1r, h1i = 0.5 * (hs_r + hd_r), 0.5 * (hs_i + hd_i)
    h2r, h2i = 0.5 * (hs_r - hd_r), 0.5 * (hs_i - hd_i)
    dp = mi["data_rows"].on(dev)
    r_r, r_i = xcr[dp], xci[dp]             # (n_data_c, lanes)
    h1r_d, h1i_d = h1r[dp], h1i[dp]
    h2r_d, h2i_d = h2r[dp], h2i[dp]
    # Alamouti pairs on adjacent data carriers:
    #   r0 = h1_0 e0 - h2_0 e1*,   r1 = h1_1 e1 + h2_1 e0*
    r0r, r0i = r_r[0::2], r_i[0::2]
    r1r, r1i = r_r[1::2], r_i[1::2]
    a_r, a_i = h1r_d[0::2], h1i_d[0::2]     # h1_0
    b_r, b_i = h2r_d[0::2], h2i_d[0::2]     # h2_0
    c_r, c_i = h1r_d[1::2], h1i_d[1::2]     # h1_1
    d_r, d_i = h2r_d[1::2], h2i_d[1::2]     # h2_1
    # det = h1_0 * conj(h1_1) + h2_0 * conj(h2_1)
    t0r, t0i = _cmul(a_r, a_i, c_r, -c_i)
    t1r, t1i = _cmul(b_r, b_i, d_r, -d_i)
    det_r, det_i = t0r + t1r, t0i + t1i
    inv_d2 = 1.0 / torch.clamp(det_r * det_r + det_i * det_i, min=1e-24)
    # e0 = (conj(h1_1) * r0 + h2_0 * conj(r1)) / det
    n0r, n0i = _cmul(c_r, -c_i, r0r, r0i)
    m0r, m0i = _cmul(b_r, b_i, r1r, -r1i)
    n0r, n0i = n0r + m0r, n0i + m0i
    e0r, e0i = _cmul(n0r, n0i, det_r * inv_d2, -det_i * inv_d2)
    # e1 = conj((-conj(h2_1) * r0 + h1_0 * conj(r1)) / det)
    n1r, n1i = _cmul(-d_r, d_i, r0r, r0i)
    m1r, m1i = _cmul(a_r, a_i, r1r, -r1i)
    n1r, n1i = n1r + m1r, n1i + m1i
    e1r, e1i = _cmul(n1r, n1i, det_r * inv_d2, -det_i * inv_d2)
    e1i = -e1i
    # sorted carrier order; the frequency deinterleave is in demod.layout
    out_r = torch.stack([e0r, e1r], 1).reshape(r_r.shape)
    out_i = torch.stack([e0i, e1i], 1).reshape(r_i.shape)
    return out_r, out_i


def fft_carrier_major(sym_r, sym_i, dtype):
    """(F, S, n) planar time-domain symbols -> (n, S, F) planar spectra
    (natural DFT order) in `dtype`; the transform runs in f32."""
    x = torch.complex(sym_r.float(), sym_i.float())
    spec = torch.fft.fft(x, dim=-1).permute(2, 1, 0)
    return spec.real.to(dtype), spec.imag.to(dtype)


class MultiFramePath:
    """F-frame batched demod + PLP LLR path with the frame axis minor in
    every array.

    Entries (JAX `_fn_syms`, `_fn_planes`, `_fn`):
      - `syms(sym_r, sym_i, inv_nvar)`: GI-stripped (F, len_frame, fft)
        symbol planes in class order (`demod.sym_order`);
      - `planes(body_r, body_i, inv_nvar)`: (F, len_frame*symbol_size)
        body planes in natural symbol order;
      - `path(bodies, inv_nvar)`: (F, len_frame*symbol_size, 2) bodies.
    Each returns (n_ldpc, nb, F) LLRs in `llr_dtype` (a tuple of them, one
    per PLP, with `plp_specs`; on the card views of frame-major (F, n_ldpc,
    nb) storage, contiguous on the CPU), followed, when asked, by the L1 cells
    (l1_size, F, 2) (`emit_l1`) and the cell-weighted (F,) EVM
    (`emit_evm`).  `plp_specs` = [(plp, num_blocks, start_cell,
    sub_slices, slice_interval), ...] decodes every PLP of the frames in
    one call."""

    def __init__(self, p: T2Params, plp: PLPParams | None = None,
                 num_blocks: int = 0, n_frames: int = 1,
                 llr_dtype=torch.float32, emit_l1: bool = False,
                 emit_evm: bool = False, l1_cells: int | None = None,
                 plp_specs=None):
        self.p = p
        self.n_frames = n_frames
        # the demod computes and stores in the LLR dtype too (bf16 on the
        # batched path); the FFT itself runs in f32
        self.llr_dtype = llr_dtype
        self.emit_l1 = emit_l1
        self.emit_evm = emit_evm
        self.demod = get_fused_demod(p)
        self.multi = plp_specs is not None
        if plp_specs is None:
            plp_specs = [(plp, num_blocks, 0, 1, 0)]
        self.specs = list(plp_specs)
        self.plp = self.specs[0][0]
        self.num_blocks = self.specs[0][1]
        if l1_cells is not None:
            self.l1_size = l1_cells
        else:
            pre, _ = l1mod.build_l1(p, [s[0] for s in self.specs])
            self.l1_size = l1mod.L1_PRE_CELLS + pre.l1_post_size
        self.paths = []
        for (pl, nb, sc, ss, iv) in self.specs:
            if sc == 0 and ss == 1 and l1_cells is None \
                    and len(self.specs) == 1:
                self.paths.append(get_fused_plp_path(p, pl, nb))
            else:
                self.paths.append(FusedPLPPath(
                    p, pl, nb, self.demod, plp_start_cell=sc,
                    l1_cells=self.l1_size, sub_slices=ss,
                    slice_interval=iv))
        self.path = self.paths[0]
        self._tails = [LLRTail(pa, n_frames, llr_dtype)
                       for pa in self.paths]
        # cell-count weights for the cross-PLP EVM average
        wts = np.array([pa.num_blocks * pa.plp.cells_per_fec_block
                        for pa in self.paths], np.float64)
        self._wts = (wts / wts.sum()).tolist()
        self._l1_rows = DeviceConst(
            self.demod.layout[:self.l1_size].astype(np.int64))
        self._classes = self.demod.consts(n_frames)
        self._sym_off = np.concatenate(
            [[0], np.cumsum([c.count for c in self.demod.classes])]
        ).astype(int)

    def syms(self, sym_r, sym_i, inv_nvar):
        p, f = self.p, self.n_frames
        if sym_r.shape != (f, p.len_frame, p.fft_size):
            raise ValueError(f"expected ({f}, {p.len_frame}, {p.fft_size}) "
                             f"symbol planes, got {tuple(sym_r.shape)}")
        return self._core(sym_r, sym_i, inv_nvar, ordered=True)

    def planes(self, body_r, body_i, inv_nvar):
        p, f = self.p, self.n_frames
        if body_r.shape != (f, p.len_frame * p.symbol_size):
            raise ValueError(f"expected ({f}, {p.len_frame * p.symbol_size})"
                             f" body planes, got {tuple(body_r.shape)}")
        sym_r = body_r.reshape(f, p.len_frame, p.symbol_size
                               )[:, :, p.guard_size:]
        sym_i = body_i.reshape(f, p.len_frame, p.symbol_size
                               )[:, :, p.guard_size:]
        return self._core(sym_r, sym_i, inv_nvar)

    def __call__(self, bodies, inv_nvar):
        return self.planes(bodies[..., 0], bodies[..., 1], inv_nvar)

    def _to_carriers(self, v):
        """Natural-order (fft, ...) spectrum -> (k_total, ...) active
        carriers: the fftshift and carrier slice as wrapped row slices."""
        p = self.p
        s0 = (p.left_nulls - p.fft_size // 2) % p.fft_size
        if s0 + p.k_total <= p.fft_size:
            return v[s0:s0 + p.k_total]
        return torch.cat([v[s0:], v[:s0 + p.k_total - p.fft_size]])

    def class_views(self, xr, xi, ordered: bool) -> list:
        """Each class's (rows, nc*F) planes out of the (rows, n_sym, F)
        spectra: a contiguous column view of class-ordered symbols, or a
        strided slice of natural-order ones."""
        f = self.n_frames
        xs = []
        for ci, cc in enumerate(self._classes):
            c = cc.c
            if ordered:
                lo, hi = int(self._sym_off[ci]) * f, \
                    int(self._sym_off[ci + 1]) * f
                xs.append((xr.reshape(xr.shape[0], -1)[:, lo:hi],
                           xi.reshape(xi.shape[0], -1)[:, lo:hi]))
            else:
                sl = slice(c.start, c.start + c.step * (c.count - 1) + 1,
                           c.step)
                xs.append((xr[:, sl].reshape(xr.shape[0], -1),
                           xi[:, sl].reshape(xi.shape[0], -1)))
        return xs

    def equalize(self, xs, wrapped: bool) -> torch.Tensor:
        """Every class equalized into the paired class-flat layout (total,
        2F), row j = [re_j | im_j].  wrapped: the views are raw FFT rows
        and the SISO comp-first tables carry the fftshift; otherwise they
        are active-carrier rows (SISO or MISO)."""
        f = self.n_frames
        ests = None
        if self.p.miso:
            ests = [class_pilot_est(cc, a, b)
                    for cc, (a, b) in zip(self._classes, xs)]
        outs = []
        for cc, (a, b) in zip(self._classes, xs):
            if wrapped:
                eqr, eqi = _eq_class_comp(cc, a, b, wrapped=True)
            else:
                eqr, eqi = _eq_class_planar(cc, a, b, ests)
            outs.append(torch.cat([eqr.reshape(-1, f), eqi.reshape(-1, f)],
                                  1))
        return torch.cat(outs)                       # (total, 2F)

    def tails(self, both, inv_nvar):
        """-> ([(n_ldpc, nb, F) LLRs per PLP], the cell-weighted (F,)
        EVM, or None without `emit_evm`) of the paired layout.  On the
        card each tail is one launch of K7 (`ops/llr_tail.py`), whose LLRs
        are views of frame-major (F, n_ldpc, nb) storage; the counter
        "demod.llr_kernel_frames" adds the frames it ran (0 on the CPU)."""
        outs, evm = [], 0.0
        for w, tail in zip(self._wts, self._tails):
            out_p, evm_p = tail(both, inv_nvar, evm=self.emit_evm)
            outs.append(out_p)
            if self.emit_evm:
                evm = evm + evm_p * w
        count("demod.llr_kernel_frames", self.n_frames if both.is_cuda else 0)
        return outs, (evm if self.emit_evm else None)

    def carriers(self, xkr, xki, ordered: bool):
        """The (fft, n_sym, F) FFT output -> (xr, xi, wrapped): on the
        comp-first route (ordered SISO) the row tables carry the fftshift
        wrap, so the raw FFT output is indexed directly (wrapped=True);
        otherwise the active carriers are sliced out first."""
        if ordered and not self.p.miso:
            return xkr, xki, True
        return self._to_carriers(xkr), self._to_carriers(xki), False

    def _core(self, sym_r, sym_i, inv_nvar, ordered=False):
        f = self.n_frames
        xkr, xki = fft_carrier_major(sym_r, sym_i, self.llr_dtype)
        xr, xi, wrapped = self.carriers(xkr, xki, ordered)
        both = self.equalize(self.class_views(xr, xi, ordered), wrapped)
        outs, evm = self.tails(both, inv_nvar)
        out = tuple(outs) if self.multi else outs[0]
        if not (self.emit_l1 or self.emit_evm):
            return out
        res = [out]
        if self.emit_l1:
            l1c = both[self._l1_rows.on(both.device)]
            res.append(torch.stack([l1c[:, :f], l1c[:, f:]], -1))
        if self.emit_evm:
            res.append(evm)                          # (F,) cell-weighted
        return tuple(res)


@functools.lru_cache(maxsize=None)
def get_fused_demod(p: T2Params) -> FusedFrameDemod:
    return FusedFrameDemod(p)


@functools.lru_cache(maxsize=None)
def get_fused_plp_path(p: T2Params, plp: PLPParams,
                       num_blocks: int) -> FusedPLPPath:
    return FusedPLPPath(p, plp, num_blocks, get_fused_demod(p))
