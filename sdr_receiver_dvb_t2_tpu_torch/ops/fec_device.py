"""FEC tail: batched BCH parity check and BB descramble + byte packing of
decoded (N, B) codewords on the device, and the host BCH gate and
correction the receivers call.  Port of
`sdr_receiver_dvb_t2_tpu/ops/fec_device.py`: `make_bch_check_nb` and
`make_bb_bytes_nb` in PyTorch; `remainder_matrix`, `_scramble_prbs`,
`bch_correct_batch` and `bch_check_host` in NumPy, as they are there.

GF(2) check: rem(c) = XOR of the rows of the (n_bch, parity) remainder
matrix where codeword bit c_j is 1, so the check is one f32 matrix product
of 0/1 values followed by mod 2.  Sums stay below 2^24: exact in f32.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..dvbt2 import bbframe, bch
from ..dvbt2.params import CodeRate, FECFrame, PLPParams, fec_params

from .._device import DeviceConst


@functools.lru_cache(maxsize=None)
def remainder_matrix(frame: FECFrame, n_bch: int, t: int) -> np.ndarray:
    """(n_bch, parity) uint8: row j = remainder of x^(n_bch-1-j) mod g(x).

    rem(codeword) = XOR of rows where the codeword bit is 1."""
    f = bch.field(frame, t)
    parity = f.parity
    mask = (1 << parity) - 1
    gen_low = f.gen_poly & mask
    out = np.empty((n_bch, parity), dtype=np.uint8)
    r = 1  # x^0
    for d in range(n_bch):
        j = n_bch - 1 - d
        for b in range(parity):
            out[j, b] = (r >> (parity - 1 - b)) & 1
        top = r & (1 << (parity - 1))
        r = (r << 1) & mask
        if top:
            r ^= gen_low
    return out


@functools.lru_cache(maxsize=None)
def _scramble_prbs(k_bch: int) -> np.ndarray:
    return bbframe.scramble(np.zeros((1, k_bch), np.uint8))[0]



def make_bch_check_nb(frame: FECFrame, rate: CodeRate):
    """fn(bits (n_bch, B) uint8) -> ok (B,) bool: all-zero remainder
    <=> all 2t syndromes zero."""
    fec = fec_params(frame, rate)
    rm_t = DeviceConst(
        remainder_matrix(frame, fec.n_bch, fec.t_bch).T.astype(np.float32))

    def check(bits: torch.Tensor) -> torch.Tensor:
        synd = torch.matmul(rm_t.on(bits.device), bits.float())
        return (synd.to(torch.int32) % 2).sum(0) == 0

    return check


def make_bb_bytes_nb(frame: FECFrame, rate: CodeRate):
    """fn(bits (>= k_bch, B) uint8) -> BB-frame bytes (k_bch // 8, B) int32:
    descramble (XOR with the BB PRBS) then pack each 8 bits MSB first."""
    k = fec_params(frame, rate).k_bch
    prbs = DeviceConst(
        _scramble_prbs(k).astype(np.int32).reshape(k // 8, 8, 1))
    w = DeviceConst(
        (1 << np.arange(7, -1, -1)).astype(np.int32).reshape(8, 1))

    def to_bytes(bits: torch.Tensor) -> torch.Tensor:
        b = bits[:k].to(torch.int32).reshape(k // 8, 8, -1)
        db = torch.bitwise_xor(b, prbs.on(bits.device))
        return (db * w.on(bits.device)).sum(1, dtype=torch.int32)

    return to_bytes


def bch_correct_batch(plp: PLPParams, info_bits: np.ndarray,
                      stats) -> np.ndarray:
    """(B, n_bch) decoded bits -> (B, k_bch) corrected payload bits.

    Batched GEMM syndrome gate; full BM/Chien decode only on codewords the
    gate flags (clean-path cost: one matmul for the whole batch).  `stats`
    needs .bch_failures / .bch_corrected counters
    (rx.decode.PLPDecodeStats)."""
    fec = plp.fec
    ok = bch_check_host(plp, info_bits)
    bb = np.ascontiguousarray(info_bits[:, :fec.k_bch])
    for i in np.nonzero(~ok)[0]:
        fixed, nfix = bch.decode(plp.fec_frame, info_bits[i], fec.t_bch)
        if nfix < 0:
            stats.bch_failures += 1
        else:
            stats.bch_corrected += nfix
        bb[i] = fixed[:fec.k_bch]
    return bb


def bch_check_host(plp: PLPParams, bits: np.ndarray) -> np.ndarray:
    """Batched host-side BCH parity gate: (B, n_bch) bits -> (B,) bool ok.

    float32 GEMM against the remainder matrix — one call for the whole
    batch instead of the per-codeword Python `bch.syndromes` loop."""
    rm = remainder_matrix(plp.fec_frame, plp.fec.n_bch, plp.fec.t_bch)
    synd = np.asarray(bits, np.float32) @ rm.astype(np.float32)
    return ~((synd.astype(np.int64) & 1).any(axis=1))
