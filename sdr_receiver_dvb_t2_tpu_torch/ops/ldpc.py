"""Batched flooding-schedule offset min-sum LDPC decoder in plain PyTorch.

Port of `sdr_receiver_dvb_t2_tpu/ops/ldpc.py` (XLA there, no Pallas
kernel): a dense (R, deg_max) check-node adjacency, gathers and reductions
over an arbitrary codeword batch, every message and sum in one dtype:
bf16 for the receivers (the dtype the JAX receivers ask of it, for every
batch that is not a multiple of 128, `rx/device_receiver.py`), f32 (the
JAX default) for `t2rx --flood-ldpc`, the sharded step
(`parallel/sharding.py`) and `entry.py`.  `_vn_adjacency` is the port's own
copy (the JAX module imports jax at the top).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..dvbt2.ldpc import get_code
from ..dvbt2.params import CodeRate, FECFrame

from .._device import DeviceConst

_BIG = 1e30
OFFSET = 0.5      # offset min-sum correction
DTYPE = torch.bfloat16            # the receivers' dtype, and the default
DTYPES = (torch.bfloat16, torch.float32)


@functools.lru_cache(maxsize=None)
def _vn_adjacency(frame: FECFrame, rate: CodeRate) -> np.ndarray:
    """Variable-node edge lists: (N+1, vdeg_max) indices into the flat
    (R*dmax) edge space, padded with R*dmax (a zero slot)."""
    code = get_code(frame, rate)
    r, dmax = code.cn_idx.shape
    edges_of = [[] for _ in range(code.n + 1)]
    for e, bit in enumerate(code.cn_idx.reshape(-1)):
        edges_of[bit].append(e)
    vdeg = max(len(x) for x in edges_of[:code.n])
    out = np.full((code.n + 1, vdeg), r * dmax, dtype=np.int64)
    for nbit in range(code.n):
        out[nbit, :len(edges_of[nbit])] = edges_of[nbit]
    return out


class FloodDecoder:
    """fn(llrs (B, N)) -> (B, N) uint8 hard bits (positive LLR = bit 0):
    `iters` flooding iterations of offset min-sum in `dtype`."""

    def __init__(self, frame: FECFrame, rate: CodeRate, iters: int,
                 dtype: torch.dtype = DTYPE):
        if dtype not in DTYPES:
            raise ValueError(f"the flooding decoder runs in bf16 or f32, "
                             f"not {dtype}")
        code = get_code(frame, rate)
        self.n = code.n
        self.iters = iters
        self.dtype = dtype
        self._idx = DeviceConst(code.cn_idx.astype(np.int64))   # (R, dmax)
        self._valid = DeviceConst(code.cn_idx < code.n)
        self._vn = DeviceConst(_vn_adjacency(frame, rate))      # (N+1, vdeg)

    def __call__(self, llrs: torch.Tensor) -> torch.Tensor:
        dev, dt = llrs.device, self.dtype
        idx, valid, vn = (c.on(dev) for c in (self._idx, self._valid,
                                              self._vn))
        b = llrs.shape[0]
        llr_pad = torch.cat([llrs.to(dt),
                             torch.full((b, 1), _BIG, dtype=dt, device=dev)],
                            1)
        big = torch.tensor(_BIG, dtype=dt, device=dev)
        off = torch.tensor(OFFSET, dtype=dt, device=dev)
        zero = torch.zeros((), dtype=dt, device=dev)
        lanes = torch.arange(idx.shape[1], device=dev)
        total = llr_pad
        c2v = torch.zeros((b,) + idx.shape, dtype=dt, device=dev)
        for _ in range(self.iters):
            v2c = torch.where(valid, total[:, idx] - c2v, big)
            mag = v2c.abs()
            neg = v2c < 0
            # leave-one-out sign: parity of the row's signs minus its own
            row_neg = neg.sum(-1, keepdim=True) - neg.int()
            loo_sign = torch.where(row_neg % 2 == 1, -1.0, 1.0).to(dt)
            # two minima; only the first occurrence of min1 takes min2 (the
            # index `min` returns: JAX's cumsum mask of the first minimum,
            # without an int64 scan along the short row axis)
            min1, i1 = mag.min(-1, keepdim=True)
            first_min = lanes == i1
            min2 = torch.where(first_min, big, mag).min(
                -1, keepdim=True).values
            loo_min = torch.where(first_min, min2, min1)
            c2v = torch.where(valid, loo_sign * torch.maximum(loo_min - off,
                                                              zero), zero)
            # variable-node update as a gather of each bit's edges
            flat = torch.cat([c2v.reshape(b, -1),
                              torch.zeros((b, 1), dtype=dt, device=dev)], 1)
            total = llr_pad + flat[:, vn].sum(-1)
        return (total[:, :self.n] < 0).to(torch.uint8)


@functools.lru_cache(maxsize=None)
def make_decoder(frame: FECFrame, rate: CodeRate, iters: int = 25,
                 dtype: torch.dtype = DTYPE) -> FloodDecoder:
    """Batched decoder for the (frame, rate) code: (B, N) llrs -> (B, N)
    hard bits; one per code, iteration count and dtype (bf16 or f32)."""
    return FloodDecoder(frame, rate, iters, dtype)


def syndrome_ok(code, bits: np.ndarray) -> np.ndarray:
    """Batched syndrome check on host: (B, N) -> (B,) bool (the JAX
    module's NumPy `syndrome_ok`; `code` is a `dvbt2.ldpc.LDPCCode`)."""
    bits = np.asarray(bits, dtype=np.uint8)
    padded = np.concatenate(
        [bits, np.zeros((bits.shape[0], 1), np.uint8)], axis=1)
    return ~np.any(
        np.bitwise_xor.reduce(padded[:, code.cn_idx], axis=2) & 1, axis=1)
