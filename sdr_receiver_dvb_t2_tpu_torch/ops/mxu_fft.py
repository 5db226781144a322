"""Matmul-factorized FFT: the OFDM FFT as two batched matrix products.
Port of `sdr_receiver_dvb_t2_tpu/ops/mxu_fft.py` in plain PyTorch (the JAX
package computes these products outside any Pallas kernel, so they are
`torch.matmul`/`torch.einsum` here).

A Cooley-Tukey split N = N1*N2 turns the FFT into a DFT-N1 and a DFT-N2
(matrix products) with an elementwise twiddle between them: 40x the FLOPs
of a radix-2 FFT, but on the matrix units.

Factorization (n = n1*N2 + n2, k = k1 + N1*k2):
  X[k1,k2] = sum_n2 W_N^{n2 k1} W_N2^{n2 k2} ( sum_n1 x[n1,n2] W_N1^{n1 k1} )

The receive path (`rx/fusedpath.py`) keeps cuFFT; this module serves
`tools/fft_microbench.py`, which measures one against the other, and
`ops/fft_stage1.py` (its tables and its second stage).

Precision: with f32 tensors the products run in full f32
(`torch.backends.cuda.matmul.allow_tf32` must stay False, as it is by
default); with dtype=bfloat16 every intermediate is stored in bf16 and the
products are bf16 with f32 accumulation: ~-40 dB EVM from the input
quantization.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

_FACTORS = {32768: (256, 128), 16384: (128, 128), 8192: (128, 64),
            4096: (64, 64), 2048: (64, 32), 1024: (32, 32)}


@functools.lru_cache(maxsize=None)
def _tables(n: int):
    n1, n2 = _FACTORS[n]
    assert n1 * n2 == n
    j1 = np.arange(n1)
    j2 = np.arange(n2)
    w1 = np.exp(-2j * np.pi * np.outer(j1, j1) / n1)       # (n1, k1)
    w2 = np.exp(-2j * np.pi * np.outer(j2, j2) / n2)       # (n2, k2)
    tw = np.exp(-2j * np.pi * np.outer(j1, j2) / n)        # (k1, n2)
    f32 = np.complex64
    return (w1.astype(f32), w2.astype(f32), tw.astype(f32))


def _planes(z: np.ndarray, dtype, device):
    """Complex table -> (real, imag) tensors in `dtype` on `device`."""
    return tuple(torch.from_numpy(np.ascontiguousarray(p)).to(
        device=device, dtype=dtype) for p in (z.real, z.imag))


def _prod(a: torch.Tensor, b: torch.Tensor, dt, op=torch.matmul):
    """op(a, b), a product accumulated in f32 and stored in `dt`.  The CPU
    has no bf16 product with f32 accumulation, so there bf16 operands are
    widened first (exact in f32: the same product up to the order of the
    sum)."""
    if dt == torch.bfloat16 and a.device.type == "cpu":
        return op(a.float(), b.float()).to(dt)
    return op(a, b)


def _mm(eq: str, a: torch.Tensor, w: torch.Tensor, dt) -> torch.Tensor:
    """torch.einsum(eq, a, w) through `_prod`."""
    return _prod(a, w, dt, functools.partial(torch.einsum, eq))


def _stage1(y: torch.Tensor, w: torch.Tensor, dt) -> torch.Tensor:
    """The first stage's product "fsnm,nk->fskm" as one batched product
    w^T (k, n) . y (n, m) per symbol: accumulated in f32, stored in `dt`
    and contiguous (the einsum's result is laid out (f, s, m, k), and the
    second stage would have to copy it across its innermost axis)."""
    return _prod(w.t(), y, dt)


def fft_stages(x: torch.Tensor, n: int) -> torch.Tensor:
    """(..., n) complex -> (..., k1: n1, k2: n2) complex with
    X[k] = out[..., k % n1, k // n1] (natural DFT ordering split)."""
    n1, n2 = _FACTORS[n]
    w1, w2, tw = (torch.from_numpy(t).to(x.device) for t in _tables(n))
    y = x.reshape(x.shape[:-1] + (n1, n2))
    a = torch.einsum("...nm,nk->...km", y, w1)
    b = a * tw
    return torch.einsum("...km,ml->...kl", b, w2)


def fft_stages_planar(xr: torch.Tensor, xi: torch.Tensor, n: int,
                      dtype=None):
    """Planar variant: (..., n) real pairs -> (..., k1, k2) real pairs, no
    complex tensor materialized.  dtype=bfloat16 stores every intermediate
    in bf16 (products in bf16 with f32 accumulation)."""
    n1, n2 = _FACTORS[n]
    w1, w2, tw = _tables(n)
    dt = dtype or xr.dtype
    dev = xr.device
    w1r, w1i = _planes(w1, dt, dev)
    w2r, w2i = _planes(w2, dt, dev)
    twr, twi = _planes(tw, dt, dev)
    yr = xr.to(dt).reshape(xr.shape[:-1] + (n1, n2))
    yi = xi.to(dt).reshape(xi.shape[:-1] + (n1, n2))
    s1, s2 = "...nm,nk->...km", "...km,ml->...kl"
    ar = _mm(s1, yr, w1r, dt) - _mm(s1, yi, w1i, dt)
    ai = _mm(s1, yr, w1i, dt) + _mm(s1, yi, w1r, dt)
    br = ar * twr - ai * twi
    bi = ar * twi + ai * twr
    out_r = _mm(s2, br, w2r, dt) - _mm(s2, bi, w2i, dt)
    out_i = _mm(s2, br, w2i, dt) + _mm(s2, bi, w2r, dt)
    return out_r, out_i


def stage2_carrier_major(br: torch.Tensor, bi: torch.Tensor, n: int):
    """The second Cooley-Tukey stage of `fft_carrier_major_planar` on its
    own: twiddled stage-1 output (F, S, k1, n2) -> (n, S, F) spectra in
    carrier-major layout, in the dtype of `br`.

    The JAX package writes it as the einsum "fskm,ml->lksf".  Here the
    planes are first copied to (k1, S, F, m), a copy of whole rows of m,
    and each product is one matrix product W2^T (l, m) . b^T (m, k1 S F)
    whose result is already (l, k1, S, F): the carrier-major layout with
    no copy after it.  (An einsum's permuted result has to be copied with
    F, its innermost axis, strided by S*n.)  Each product is accumulated in
    f32 and stored in the planes' dtype, then the two are combined in it,
    as in the einsum route."""
    _, w2, _ = _tables(n)
    dt = br.dtype
    f, s, n1, n2 = br.shape
    w2r, w2i = _planes(w2, dt, br.device)                    # (m, l)
    pr = br.permute(2, 1, 0, 3).reshape(n1 * s * f, n2)      # (k1 S F, m)
    pi = bi.permute(2, 1, 0, 3).reshape(n1 * s * f, n2)

    def mm(b, w):                                # -> (l, k1 S F) in dt
        return _prod(w.t(), b.t(), dt)
    out_r = mm(pr, w2r) - mm(pi, w2i)
    out_i = mm(pr, w2i) + mm(pi, w2r)
    # row-major (k2, k1) flatten IS the DFT index k = k1 + n1*k2
    return out_r.reshape(n, s, f), out_i.reshape(n, s, f)


def fft_carrier_major_planar(xr: torch.Tensor, xi: torch.Tensor, n: int,
                             dtype=None):
    """(F, S, n) planar time-domain symbols -> (n, S, F) planar spectra in
    CARRIER-MAJOR layout: the second stage writes k-major (the JAX
    package's transposed einsum "fskm,ml->lksf", `stage2_carrier_major`)."""
    n1, n2 = _FACTORS[n]
    w1, _, tw = _tables(n)
    dt = dtype or xr.dtype
    dev = xr.device
    f, s = xr.shape[0], xr.shape[1]
    yr = xr.to(dt).reshape(f, s, n1, n2)
    yi = xi.to(dt).reshape(f, s, n1, n2)
    w1r, w1i = _planes(w1, dt, dev)
    twr, twi = _planes(tw, dt, dev)
    ar = _stage1(yr, w1r, dt) - _stage1(yi, w1i, dt)
    ai = _stage1(yr, w1i, dt) + _stage1(yi, w1r, dt)
    br = ar * twr - ai * twi
    bi = ar * twi + ai * twr
    return stage2_carrier_major(br, bi, n)


def fft(x: torch.Tensor, n: int | None = None) -> torch.Tensor:
    """Drop-in torch.fft.fft replacement over the last axis (supported n)."""
    n = n or x.shape[-1]
    if n not in _FACTORS:
        return torch.fft.fft(x, dim=-1)
    out = fft_stages(x, n)                       # (..., k1, k2)
    out = out.transpose(-1, -2)                  # (..., k2, k1): flat = k
    return out.reshape(x.shape[:-1] + (n,))
