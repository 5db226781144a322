"""FFT stage 1 fused with the twiddle (K6): the port of the TPU kernel
`s1_kernel` of the JAX repository's `tools/fft_microbench.py`.

For symbols y (F, S, n1, n2) of a length n = n1*n2 Cooley-Tukey FFT
(`ops/mxu_fft.py`):

    a = W1^T . y        complex, as four real bf16 products summed in f32
    b = a * tw          complex elementwise in f32
    out = bf16(b)       the one rounding to bf16

a_r and a_i are NOT rounded to bf16 before the twiddle (unlike
`mxu_fft.fft_carrier_major_planar`, which rounds them).

Two implementations:

- `csrc/fft_stage1.cu`, the hand-written CUDA kernel (persistent CTAs with
  bands of W1^T resident in shared memory, y through a TMA ring, `wgmma`
  products with f32 accumulators, the twiddle as its epilogue), for CUDA
  tensors; it reads the tables in the layout of `pack_tables`;
- `stage1_plain`, plain PyTorch (`torch.matmul` on the bf16-valued inputs
  widened to f32), the kernel's reference and the path CPU tensors take.

A product of two bf16 numbers is exact in f32, but the two sum the n1
terms of a row in different orders, so they are not bit-equal: see
`compare` for the tolerance.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import _build
from . import mxu_fft


def stage1_plain(yr, yi, w1r_t, w1i_t, twr, twi):
    """The plain version on any device: bf16 (..., n1, n2) symbols, bf16
    W1^T (n1, n1) and twiddles (n1, n2) -> bf16 (b_r, b_i)."""
    yr, yi, wr, wi, tr, ti = (t.float() for t in
                              (yr, yi, w1r_t, w1i_t, twr, twi))
    ar = torch.matmul(wr, yr) - torch.matmul(wi, yi)
    ai = torch.matmul(wr, yi) + torch.matmul(wi, yr)
    return ((ar * tr - ai * ti).to(torch.bfloat16),
            (ar * ti + ai * tr).to(torch.bfloat16))


# the layout the kernel reads (the same constants as in csrc/fft_stage1.cu)
BAND = 64     # rows of k1 per band of W1^T: the kernel's wgmma M
KCH = 64      # n1 values per block row: one 128-byte swizzled row


@functools.lru_cache(maxsize=None)
def bf16_tables(n: int) -> tuple:
    """bf16 (W1^T r, W1^T i, tw r, tw i) on the CPU, cast as the JAX tool
    casts them."""
    w1, _, tw = mxu_fft._tables(n)
    return tuple(
        torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            torch.bfloat16)
        for a in (w1.real.T, w1.imag.T, tw.real, tw.imag))


def twiddle_index(n1: int, n2: int) -> tuple:
    """(rows, columns) of the packed twiddle's entries, each shaped
    (bands, n2 // 8, 128, 8): thread T of a band's consumer warpgroup holds
    the accumulators of rows r = 16 (T // 32) + (T % 32) // 4 and r + 8 and
    columns c = 8 j + 2 (T % 4) and c + 1; its 8 values for column group j
    are (tr, tr, ti, ti) at row r, then at row r + 8 (tr at c, c + 1)."""
    bands = max(n1 // BAND, 1)
    b = torch.arange(bands)[:, None, None, None]
    j = torch.arange(n2 // 8)[None, :, None, None]
    t = torch.arange(128)[None, None, :, None]
    e = torch.arange(8)[None, None, None, :]
    rows = b * BAND + 16 * (t // 32) + (t % 32) // 4 + 8 * (e // 4)
    cols = 8 * j + 2 * (t % 4) + e % 2
    return rows.expand(-1, n2 // 8, 128, 8), cols.expand(bands, -1, 128, 8)


def pack_tables(n: int) -> tuple:
    """The kernel's tables for length n, built from `bf16_tables(n)`:
    -> (w, tw) bf16 CPU tensors.

    w (bands, 2 planes, chunks, BAND * KCH): W1^T cut into bands of BAND
    rows of k1 and chunks of KCH values of n1 (zero-padded where n1 < 64),
    each block in the 128-byte swizzle `wgmma` reads (element (m, k) in
    16-byte chunk (k // 8) XOR (m % 8) of row m); a CTA copies its bands'
    blocks to shared memory as they lie.  tw (bands, n2 // 8, 128,
    8): the twiddle in the accumulators' order (`twiddle_index`; rows past
    n1 are zero)."""
    n1, n2 = mxu_fft._FACTORS[n]
    w1r_t, w1i_t, twr, twi = bf16_tables(n)
    bands, chunks = max(n1 // BAND, 1), max(n1 // KCH, 1)
    w = torch.zeros(bands, 2, chunks, BAND * KCH, dtype=torch.bfloat16)
    m = torch.arange(BAND)[:, None]
    k = torch.arange(KCH)[None, :]
    dest = (m * KCH + ((k // 8) ^ (m % 8)) * 8 + k % 8).flatten()
    for plane, t in enumerate((w1r_t, w1i_t)):
        pad = torch.zeros(bands * BAND, chunks * KCH, dtype=torch.bfloat16)
        pad[:n1, :n1] = t
        blocks = pad.reshape(bands, BAND, chunks, KCH).permute(0, 2, 1, 3)
        w[:, plane, :, dest] = blocks.reshape(bands, chunks, BAND * KCH)
    rows, cols = twiddle_index(n1, n2)
    tr = torch.zeros(bands * BAND, n2, dtype=torch.bfloat16)
    ti = torch.zeros_like(tr)
    tr[:n1], ti[:n1] = twr, twi
    plane = torch.arange(8) % 4 // 2          # 0: tr, 1: ti
    tw = torch.where(plane == 0, tr[rows, cols], ti[rows, cols])
    return w, tw.contiguous()


def _lib() -> ctypes.CDLL:
    lib = _build.load("fft_stage1")
    if lib.fft_stage1.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fft_stage1.argtypes = [p] * 6 + [i] * 3 + [p]
        lib.fft_stage1.restype = i
        lib.fft_stage1_supported.argtypes = [i, i]
        lib.fft_stage1_supported.restype = i
        lib.fft_stage1_plan.argtypes = [i, i, i, p]
        lib.fft_stage1_plan.restype = i
        lib.fft_stage1_error_string.argtypes = [i]
        lib.fft_stage1_error_string.restype = ctypes.c_char_p
    return lib


def plan(n1: int, n2: int, n_sym: int) -> dict:
    """The launch the kernel makes for n_sym symbols of n1 x n2 on the
    current CUDA device: column tile, consumer warpgroups, ring stages,
    dynamic shared memory bytes and CTAs of the persistent grid."""
    out = (ctypes.c_int * 5)()
    lib = _lib()
    err = lib.fft_stage1_plan(n1, n2, n_sym, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError("fft_stage1_plan: "
                           + lib.fft_stage1_error_string(err).decode())
    return dict(zip(("tile", "warpgroups", "stages", "smem", "ctas"), out))


def packed_shapes(n1: int, n2: int) -> tuple:
    """Shapes of `pack_tables`' (w, tw) for factors n1 x n2."""
    bands, chunks = max(n1 // BAND, 1), max(n1 // KCH, 1)
    return (bands, 2, chunks, BAND * KCH), (bands, n2 // 8, 128, 8)


def fft_stage1_cuda(yr, yi, w, tw):
    """K6 on the card: contiguous bf16 CUDA tensors, y (..., n1, n2) and
    the tables of `pack_tables` -> bf16 (b_r, b_i) shaped like y."""
    if yr.dim() < 3:
        raise ValueError("fft_stage1_cuda: y must be (..., n1, n2) with at "
                         "least one leading axis")
    n1, n2 = yr.shape[-2], yr.shape[-1]
    shapes = (yr.shape, yr.shape) + packed_shapes(n1, n2)
    for t, shape in zip((yr, yi, w, tw), shapes):
        if not t.is_cuda or t.device != yr.device:
            raise ValueError("fft_stage1_cuda needs CUDA tensors on one "
                             "device")
        if t.dtype != torch.bfloat16 or tuple(t.shape) != tuple(shape) \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(
                f"fft_stage1_cuda: expected a contiguous 16-byte-aligned "
                f"bf16 tensor of shape {tuple(shape)}, got "
                f"{tuple(t.shape)} {t.dtype}")
    lib = _lib()
    if lib.fft_stage1_supported(n1, n2) != 0:
        raise ValueError(f"fft_stage1_cuda: unsupported factors {n1} x {n2}")
    br, bi = torch.empty_like(yr), torch.empty_like(yi)
    with torch.cuda.device(yr.device):
        err = lib.fft_stage1(
            yr.data_ptr(), yi.data_ptr(), w.data_ptr(), tw.data_ptr(),
            br.data_ptr(), bi.data_ptr(), yr.numel() // (n1 * n2), n1, n2,
            torch.cuda.current_stream(yr.device).cuda_stream)
    if err != 0:
        raise RuntimeError("fft_stage1_cuda: "
                           + lib.fft_stage1_error_string(err).decode())
    fft_stage1_cuda.launches += 1
    return br, bi


fft_stage1_cuda.launches = 0


class Stage1:
    """fn(x_r, x_i (F, S, n) any float dtype) -> bf16 (b_r, b_i)
    (F, S, n1, n2): the inputs rounded to bf16 and reshaped to (n1, n2)
    rows, then stage 1 and the twiddle.  A CUDA tensor goes through the
    CUDA kernel, a CPU tensor through the plain version; `.kernel` and
    `.plain` force either side."""

    def __init__(self, n: int):
        self.n = n
        self.n1, self.n2 = mxu_fft._FACTORS[n]
        self._on: dict = {}
        self._packed_on: dict = {}

    @staticmethod
    def _device(device) -> torch.device:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return device

    def tables(self, device) -> tuple:
        """bf16 (W1^T r, W1^T i, tw r, tw i) on `device`."""
        device = self._device(device)
        if device not in self._on:
            self._on[device] = tuple(t.to(device)
                                     for t in bf16_tables(self.n))
        return self._on[device]

    def packed(self, device) -> tuple:
        """The kernel's tables (`pack_tables`) on `device`."""
        device = self._device(device)
        if device not in self._packed_on:
            self._packed_on[device] = tuple(
                t.to(device) for t in pack_tables(self.n))
        return self._packed_on[device]

    def _input(self, xr, xi):
        if xr.shape != xi.shape or xr.dim() != 3 or xr.shape[-1] != self.n:
            raise ValueError(f"expected two (F, S, {self.n}) planes, got "
                             f"{tuple(xr.shape)} and {tuple(xi.shape)}")
        shape = xr.shape[:2] + (self.n1, self.n2)
        return (xr.to(torch.bfloat16).reshape(shape).contiguous(),
                xi.to(torch.bfloat16).reshape(shape).contiguous())

    def __call__(self, xr, xi):
        if xr.device.type == "cpu":
            return self.plain(xr, xi)
        return self.kernel(xr, xi)

    def kernel(self, xr, xi):
        """The CUDA kernel (CUDA tensors only)."""
        yr, yi = self._input(xr, xi)
        return fft_stage1_cuda(yr, yi, *self.packed(yr.device))

    def plain(self, xr, xi):
        """The plain PyTorch version on any device."""
        yr, yi = self._input(xr, xi)
        return stage1_plain(yr, yi, *self.tables(yr.device))


def compare(got, ref) -> dict:
    """Hold one bf16 stage-1 output plane against another.

    The tolerance: the f32 row sums differ only in the order of 256 exact
    products, so an element may land on the neighbouring bf16 value.  An
    element passes if |got - ref| <= one bf16 ulp of the larger magnitude
    (2^-7 relative covers the ulp of any bf16 binade) plus 2^-18 of the
    plane's largest magnitude, the f32 summation error that shows where
    the sum cancels to a small output; and fewer than 1% of the elements
    may differ at all.
    -> {"max_abs_err", "frac_differ", "n_beyond", "ok"}."""
    g, r = got.float(), ref.float()
    d = (g - r).abs()
    scale = float(r.abs().max())
    tol = torch.maximum(g.abs(), r.abs()) * 2.0 ** -7 + scale * 2.0 ** -18
    n_beyond = int((d > tol).sum())
    frac = float((d > 0).float().mean())
    return {"max_abs_err": float(d.max()), "frac_differ": frac,
            "n_beyond": n_beyond, "ok": n_beyond == 0 and frac < 0.01}
