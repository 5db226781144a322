"""One PLP's max-log LLR tail (K7): the paired class-flat cells of F frames
-> the PLP's (n_ldpc, nb, F) LLRs and the per-frame mean least distance
(the EVM).  Port of the JAX `MultiFramePath._make_tail`: the composed cell
gather, the rotated constellation's cyclic Q-delay and rotation, max-log
LLRs over the PLP's Gray level table, the bit-deinterleave row gather.

Two implementations:

- `csrc/llr_tail.cu`, the hand-written CUDA kernel (one pass: each cell
  read once, each LLR written once to its deinterleaved row), for CUDA
  tensors; it writes the LLRs frame-major, as (F, n_ldpc, nb) storage
  returned as the (n_ldpc, nb, F) view, and the EVM planes only when
  asked;
- `LLRTail.plain`, plain PyTorch (an explicit level loop of element-wise
  passes), the kernel's reference and the path CPU tensors take.

The two are bit-equal: the kernel rounds every operation to the LLR dtype
where PyTorch's eager kernels do (the source note says how).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from .._device import DeviceConst
from ..dvbt2 import tables

_DTYPES = {torch.bfloat16: 2, torch.float32: 4}


class LLRTail:
    """One PLP's LLR tail: fn(both (total, 2F), inv_nvar, evm=True) ->
    ((n_ldpc, nb, F) LLRs in `llr_dtype`, the (F,) f32 mean least distance
    of both axes, or None where `evm` is False).  `path` is the PLP's
    `rx/fusedpath.FusedPLPPath` (its `plp`, `num_blocks`, `comp`, `bit_inv`
    and `rot`).  A CPU tensor takes `plain`, a CUDA tensor `kernel`."""

    def __init__(self, path, n_frames: int, llr_dtype):
        plp = path.plp
        self.plp, self.f, self.llr_dtype = plp, n_frames, llr_dtype
        self.nb, self.cpf = path.num_blocks, plp.cells_per_fec_block
        m = plp.bits_per_cell
        half = m // 2
        # cell-major composed PLP permutation: (nb, F) stay minor
        self._comp_cm = DeviceConst(
            path.comp.reshape(self.nb, self.cpf).T.reshape(-1).astype(
                np.int64))
        # bit deinterleave remapped to plane-major LLR storage: v-flat
        # index cell*m + bitpos (y0=I0, y1=Q0, ...) -> plane*cpf + cell
        bi = path.bit_inv.astype(np.int64)
        cell_ix, bitpos = bi // m, bi % m
        plane = (bitpos % 2) * half + bitpos // 2
        self.bit_inv_pm = plane * self.cpf + cell_ix
        self._bit_inv_pm = DeviceConst(self.bit_inv_pm)
        # its inverse, for the kernel: (plane, cell) -> the output row
        self.rows = np.empty(len(self.bit_inv_pm), np.int32)
        self.rows[self.bit_inv_pm] = np.arange(len(self.bit_inv_pm),
                                               dtype=np.int32)
        self._rows = DeviceConst(self.rows)
        self._levels = [float(v) for v in (tables._gray_levels(m)
                        * tables.NORM_FACTOR[plp.constellation])]
        words = np.arange(len(self._levels))
        # bit b of level w is bit half-1-b of w: the kernel's convention
        self._axis_masks = np.stack(
            [(words >> (half - 1 - b)) & 1 for b in range(half)]
        ).astype(bool)
        # python floats keep bf16 arithmetic in bf16
        self._rot = (float(np.real(path.rot)), float(np.imag(path.rot)))
        self._levels_c = (ctypes.c_float * len(self._levels))(*self._levels)

    def __call__(self, both, inv_nvar, evm: bool = True):
        if both.device.type == "cpu":
            out, e = self.plain(both, inv_nvar)
            return out, (e if evm else None)
        return self.kernel(both, inv_nvar, evm)

    def _axis_llrs(self, xax, inv_t):
        """Max-log LLRs of one axis by an explicit level loop (no
        (levels, ...) distance tensor), min distances kept in llr_dtype."""
        half = self._axis_masks.shape[0]
        acc0 = [None] * half
        acc1 = [None] * half
        for lvl_i, lvl in enumerate(self._levels):
            d = ((xax - lvl) ** 2).to(self.llr_dtype)
            for b in range(half):
                acc = acc1 if self._axis_masks[b][lvl_i] else acc0
                acc[b] = d if acc[b] is None else torch.minimum(acc[b], d)
        llrs = torch.stack([(acc1[b] - acc0[b]) * inv_t
                            for b in range(half)])
        # bit 0 partitions all levels: its two minima hold the per-axis
        # unconditional min distance (the EVM)
        return llrs, torch.minimum(acc0[0], acc1[0])

    def plain(self, both, inv_nvar):
        """The plain PyTorch version on any device -> ((n_ldpc, nb, F)
        contiguous LLRs, the (F,) EVM)."""
        nb, cpf, f = self.nb, self.cpf, self.f
        dev = both.device
        g = both[self._comp_cm.on(dev)].reshape(cpf, nb, 2, f)
        re, im = g[:, :, 0, :], g[:, :, 1, :]
        if self.plp.rotated:
            rot_re, rot_im = self._rot
            im = torch.roll(im, -1, 0)              # cyclic Q-delay per block
            re, im = (re * rot_re - im * rot_im, re * rot_im + im * rot_re)
        inv_t = torch.as_tensor(inv_nvar, dtype=torch.float32,
                                device=dev).to(self.llr_dtype)
        li, mi_ = self._axis_llrs(re, inv_t)        # (half, cpf, nb, F)
        lq, mq_ = self._axis_llrs(im, inv_t)
        v = torch.cat([li, lq]).reshape(self.plp.bits_per_cell * cpf, nb, f)
        out = v[self._bit_inv_pm.on(dev)]           # (n_ldpc, nb, F)
        evm = (mi_.float().mean((0, 1)) + mq_.float().mean((0, 1)))
        return out, evm

    def kernel(self, both, inv_nvar, evm: bool = True):
        """K7 (CUDA tensors only): ((n_ldpc, nb, F) LLRs, the view of
        frame-major (F, n_ldpc, nb) storage; the (F,) EVM or None)."""
        dev, f = both.device, self.f
        if not both.is_cuda or both.dtype != self.llr_dtype \
                or both.dtype not in _DTYPES or both.dim() != 2 \
                or both.shape[1] != 2 * f or not both.is_contiguous():
            raise ValueError(
                f"llr_tail_cuda: expected a contiguous CUDA {self.llr_dtype}"
                f" (total, {2 * f}) tensor (bf16 or f32), got "
                f"{tuple(both.shape)} {both.dtype} on {dev}")
        inv_t = torch.as_tensor(inv_nvar, dtype=torch.float32,
                                device=dev).to(self.llr_dtype)
        if inv_t.numel() != 1:
            raise ValueError("llr_tail_cuda: inv_nvar must be one value, "
                             f"got {tuple(inv_t.shape)}")
        n_ldpc = self.plp.bits_per_cell * self.cpf
        out = torch.empty((f, n_ldpc, self.nb), dtype=self.llr_dtype,
                          device=dev).permute(1, 2, 0)
        planes = (torch.empty((2, self.cpf, self.nb, f), dtype=self.llr_dtype,
                              device=dev) if evm else None)
        llr_tail_cuda(self, both, inv_t, out, planes)
        if planes is None:
            return out, None
        return out, planes[0].float().mean((0, 1)) + planes[1].float().mean(
            (0, 1))


def _lib() -> ctypes.CDLL:
    lib = _build.load("llr_tail")
    if lib.llr_tail.argtypes is None:
        p, i, f, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                       ctypes.c_longlong)
        lib.llr_tail.argtypes = ([p] * 8 + [ll] * 3 + [i] * 6 + [f] * 2
                                 + [i] * 2 + [p])
        lib.llr_tail.restype = i
        lib.llr_tail_error_string.argtypes = [i]
        lib.llr_tail_error_string.restype = ctypes.c_char_p
    return lib


def llr_tail_cuda(tail: LLRTail, both, inv_t, out, planes=None):
    """K7 on the card: `tail`'s tables, the contiguous (total, 2F) cells
    `both`, inv_t (one value) and the (n_ldpc, nb, F) output `out` (any
    strides), all CUDA tensors of the LLR dtype; `planes`, when given, a
    contiguous (2, cpf, nb, F) tensor for the two axes' least distances."""
    dev = both.device
    for t in (inv_t, out) + (() if planes is None else (planes,)):
        if not t.is_cuda or t.device != dev or t.dtype != both.dtype:
            raise ValueError("llr_tail_cuda needs CUDA tensors of one dtype "
                             "on one device")
    if planes is not None and (
            tuple(planes.shape) != (2, tail.cpf, tail.nb, tail.f)
            or not planes.is_contiguous()):
        raise ValueError("llr_tail_cuda: planes must be a contiguous "
                         f"(2, {tail.cpf}, {tail.nb}, {tail.f}) tensor")
    elem = _DTYPES[both.dtype]
    comp, rows = tail._comp_cm.on(dev), tail._rows.on(dev)
    vec = int((tail.f * elem) % 16 == 0 and both.data_ptr() % 16 == 0)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.llr_tail(
            both.data_ptr(), comp.data_ptr(), rows.data_ptr(),
            out.data_ptr(),
            None if planes is None else planes[0].data_ptr(),
            None if planes is None else planes[1].data_ptr(),
            inv_t.data_ptr(), ctypes.addressof(tail._levels_c), *out.stride(),
            tail.nb * tail.cpf, tail.nb, tail.cpf, tail.f,
            tail.plp.bits_per_cell, int(tail.plp.rotated), *tail._rot,
            elem, vec, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("llr_tail_cuda: "
                           + lib.llr_tail_error_string(err).decode())
    llr_tail_cuda.launches += 1
    return out


llr_tail_cuda.launches = 0
