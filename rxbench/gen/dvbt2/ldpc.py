"""DVB-T2 LDPC codes (ETSI EN 302 755 clause 6.1 / Annex A-B).

Code construction from the standard's parity-bit address tables
(`_etsi_tables.LDPC_TABLES`).  The codes are IRA: K systematic bits in groups
of M=360 accumulate into R parity positions (group row + m*q mod R), followed
by a parity accumulator chain.

TPU-first design (vs the reference's AVX2 32-lane layered decoder,
`reference/src/DVB_T2/LDPC/layered_decoder.hh`): decoding is expressed
over a dense (R, deg_max, B) message tensor -- gathers from the (N, B) LLR
array, two-minimum leave-one-out min-sum along the degree axis, scatter-add
back -- so XLA maps it onto the VPU with thousands of codewords per batch
instead of 32.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

from . import _etsi_tables as ET
from .params import CodeRate, FECFrame

_TABLE_KEY = {
    (FECFrame.NORMAL, CodeRate.C1_2): "NORMAL_C1_2",
    (FECFrame.NORMAL, CodeRate.C3_5): "NORMAL_C3_5",
    (FECFrame.NORMAL, CodeRate.C2_3): "NORMAL_C2_3",
    (FECFrame.NORMAL, CodeRate.C3_4): "NORMAL_C3_4",
    (FECFrame.NORMAL, CodeRate.C4_5): "NORMAL_C4_5",
    (FECFrame.NORMAL, CodeRate.C5_6): "NORMAL_C5_6",
    (FECFrame.SHORT, CodeRate.C1_4): "SHORT_C1_4",
    (FECFrame.SHORT, CodeRate.C1_2): "SHORT_C1_2",
    (FECFrame.SHORT, CodeRate.C3_5): "SHORT_C3_5",
    (FECFrame.SHORT, CodeRate.C2_3): "SHORT_C2_3",
    (FECFrame.SHORT, CodeRate.C3_4): "SHORT_C3_4",
    (FECFrame.SHORT, CodeRate.C4_5): "SHORT_C4_5",
    (FECFrame.SHORT, CodeRate.C5_6): "SHORT_C5_6",
}


@dataclass(frozen=True, eq=False)
class LDPCCode:
    name: str
    n: int
    k: int
    m: int
    q: int
    # info-bit accumulation: parity position acc_check[e] += info bit acc_bit[e]
    acc_bit: np.ndarray
    acc_check: np.ndarray
    # check-node adjacency over full codeword indices, padded with `n`
    cn_idx: np.ndarray   # (R, deg_max) int32
    cn_deg: np.ndarray   # (R,) int32

    @property
    def r(self) -> int:
        return self.n - self.k

    @property
    def deg_max(self) -> int:
        return self.cn_idx.shape[1]


@functools.lru_cache(maxsize=None)
def get_code(frame: FECFrame, rate: CodeRate) -> LDPCCode:
    key = _TABLE_KEY[(frame, rate)]
    t = ET.LDPC_TABLES[key]
    m_grp, n, k = t["M"], t["N"], t["K"]
    r = n - k
    q = r // m_grp

    # expand table rows: groups of 360 bits sharing base accumulator positions
    acc_bits = []
    acc_checks = []
    pos_iter = iter(t["POS"])
    grp = 0
    for deg, length in zip(t["DEG"], t["LEN"]):
        if deg == 0:
            break
        for _ in range(length):
            base = np.array([next(pos_iter) for _ in range(deg)], dtype=np.int64)
            mm = np.arange(m_grp, dtype=np.int64)
            checks = (base[None, :] + mm[:, None] * q) % r       # (360, deg)
            bits = grp * m_grp + mm                               # (360,)
            acc_bits.append(np.repeat(bits, deg))
            acc_checks.append(checks.reshape(-1))
            grp += 1
    assert grp * m_grp == k
    acc_bit = np.concatenate(acc_bits).astype(np.int32)
    acc_check = np.concatenate(acc_checks).astype(np.int32)

    # check-node adjacency: info bits touching each check + accumulator chain
    order = np.argsort(acc_check, kind="stable")
    sorted_checks = acc_check[order]
    sorted_bits = acc_bit[order]
    counts = np.bincount(acc_check, minlength=r)
    deg_max = int(counts.max()) + 2  # + parity bit + previous parity bit
    cn_idx = np.full((r, deg_max), n, dtype=np.int32)  # n = padding sentinel
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    col = np.arange(len(sorted_bits)) - starts[sorted_checks]
    cn_idx[sorted_checks, col] = sorted_bits
    cn_deg = counts.astype(np.int32) + 2
    # parity connections: check i includes parity i and parity i-1 (i>0)
    rows = np.arange(r)
    cn_idx[rows, counts] = (k + rows).astype(np.int32)
    cn_idx[rows[1:], counts[1:] + 1] = (k + rows[:-1]).astype(np.int32)
    cn_deg[0] -= 1
    return LDPCCode(name=key, n=n, k=k, m=m_grp, q=q,
                    acc_bit=acc_bit, acc_check=acc_check,
                    cn_idx=cn_idx, cn_deg=cn_deg)


def encode(code: LDPCCode, info: np.ndarray) -> np.ndarray:
    """Systematic LDPC encode.  info: (..., K) bits -> (..., N) codeword."""
    info = np.asarray(info, dtype=np.uint8)
    batch_shape = info.shape[:-1]
    flat = info.reshape(-1, code.k)
    r = code.r
    out = np.empty((flat.shape[0], code.n), dtype=np.uint8)
    for b in range(flat.shape[0]):
        acc = np.bincount(code.acc_check, weights=flat[b, code.acc_bit],
                          minlength=r).astype(np.int64)
        # accumulator chain: parity[i] = xor of per-position sums up to i
        parity = (np.cumsum(acc & 1) & 1).astype(np.uint8)
        out[b, :code.k] = flat[b]
        out[b, code.k:] = parity
    return out.reshape(*batch_shape, code.n)


def check_syndrome(code: LDPCCode, bits: np.ndarray) -> bool:
    """True when ``bits`` ((N,) hard bits) is a valid codeword."""
    bits = np.asarray(bits, dtype=np.uint8)
    padded = np.concatenate([bits, [0]])
    return not np.any(np.bitwise_xor.reduce(padded[code.cn_idx], axis=1))


def decode_minsum_np(code: LDPCCode, llr: np.ndarray, iters: int = 30,
                     offset: float = 0.5) -> tuple[np.ndarray, bool]:
    """Reference NumPy flooding offset-min-sum decoder (for tests).

    llr: (N,) float, positive = bit 0.  Returns (hard bits, converged).
    """
    r, dmax = code.cn_idx.shape
    idx = code.cn_idx
    valid = idx < code.n
    llr_pad = np.concatenate([llr.astype(np.float64), [np.inf]])
    total = llr_pad.copy()
    c2v = np.zeros((r, dmax))
    for _ in range(iters):
        v2c = total[idx] - c2v
        v2c = np.where(valid, v2c, np.inf)
        sign = np.where(np.signbit(v2c), -1.0, 1.0)
        sign = np.where(valid, sign, 1.0)
        prod_sign = np.prod(sign, axis=1, keepdims=True) * sign  # leave-one-out
        mag = np.abs(v2c)
        order = np.argsort(mag, axis=1)
        min1 = mag[np.arange(r)[:, None], order[:, :1]]
        min2 = mag[np.arange(r)[:, None], order[:, 1:2]]
        is_min = mag == min1
        # leave-one-out min: min2 where this edge is the (unique) min
        first_min_col = order[:, :1]
        loo = np.where(np.arange(dmax)[None, :] == first_min_col, min2, min1)
        new_c2v = prod_sign * np.maximum(loo - offset, 0.0)
        new_c2v = np.where(valid, new_c2v, 0.0)
        # scatter-add the message deltas back into totals
        total = llr_pad.copy()
        np.add.at(total, idx.reshape(-1), new_c2v.reshape(-1))
        total[-1] = np.inf
        c2v = new_c2v
        hard = (total[:code.n] < 0).astype(np.uint8)
        if check_syndrome(code, hard):
            return hard, True
    return (total[:code.n] < 0).astype(np.uint8), False
