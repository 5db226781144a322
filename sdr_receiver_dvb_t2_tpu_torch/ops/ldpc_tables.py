"""Quasi-cyclic layer tables of the DVB-T2 LDPC codes (EN 302 755 Annex A/B).

The port's own copy of `qc_tables`, `_layer_order`, `llrs_to_qc` and
`qc_to_bits` from `sdr_receiver_dvb_t2_tpu/ops/ldpc_pallas.py`, which
imports jax at the top.

With checks reindexed as c = t + q*u (t in [0, q), u in [0, 360)), a
parity-table entry (group g, base b) connects bit (g, m) to check
(t = b mod q, u = (b div q + m) mod 360): every edge is a static cyclic roll
by s = b div q of a 360-row tile.  The decoder is a list of (layer t, group
g, shift s) triples and the parity staircase.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

from ..dvbt2 import _etsi_tables as ET
from ..dvbt2.ldpc import _TABLE_KEY
from ..dvbt2.params import CodeRate, FECFrame

BIG = 1e9


@dataclass(frozen=True, eq=False)
class QCTables:
    n: int
    k: int
    q: int
    n_groups: int
    degmax: int                    # max info entries per layer
    layer_deg: np.ndarray          # (q,)
    entry_g: np.ndarray            # (q, degmax) group index (G = dummy)
    entry_s: np.ndarray            # (q, degmax) shift


@functools.lru_cache(maxsize=None)
def qc_tables(frame: FECFrame, rate: CodeRate) -> QCTables:
    t = ET.LDPC_TABLES[_TABLE_KEY[(frame, rate)]]
    m_grp, n, k = t["M"], t["N"], t["K"]
    assert m_grp == 360
    q = (n - k) // 360
    layers: list[list[tuple[int, int]]] = [[] for _ in range(q)]
    pos_iter = iter(t["POS"])
    grp = 0
    for deg, length in zip(t["DEG"], t["LEN"]):
        if deg == 0:
            break
        for _ in range(length):
            for _ in range(deg):
                b = next(pos_iter)
                layers[b % q].append((grp, b // q))
            grp += 1
    n_groups = grp
    degmax = max(len(x) for x in layers)
    layer_deg = np.array([len(x) for x in layers], dtype=np.int32)
    entry_g = np.full((q, degmax), n_groups, dtype=np.int32)
    entry_s = np.zeros((q, degmax), dtype=np.int32)
    for ti, ent in enumerate(layers):
        for j, (g, s) in enumerate(ent):
            entry_g[ti, j] = g
            entry_s[ti, j] = s
    return QCTables(n=n, k=k, q=q, n_groups=n_groups, degmax=degmax,
                    layer_deg=layer_deg, entry_g=entry_g, entry_s=entry_s)


def _layer_order(q: int, order) -> list:
    """Static layer visitation order for one sweep: None (natural),
    "reversed" (the production schedule) or an explicit permutation."""
    if order is None:
        return list(range(q))
    if order == "reversed":
        return list(range(q))[::-1]
    out = [int(t) for t in order]
    if sorted(out) != list(range(q)):
        raise ValueError(f"layer order is not a permutation of range({q})")
    return out


def llrs_to_qc(tab: QCTables, llrs: np.ndarray):
    """(B, N) natural-order LLRs -> (total_info (G+1,360,B),
    total_par (q,360,B)) arrays."""
    b = llrs.shape[0]
    info = llrs[:, :tab.k].reshape(b, tab.n_groups, 360)
    total_info = np.empty((tab.n_groups + 1, 360, b), np.float32)
    total_info[:tab.n_groups] = np.moveaxis(info, 0, -1)
    total_info[tab.n_groups] = BIG
    par = llrs[:, tab.k:].reshape(b, 360, tab.q)  # c = t + q*u -> [u, t]
    total_par = np.ascontiguousarray(
        np.moveaxis(par, 0, -1).transpose(1, 0, 2))  # (q, 360, B)
    return total_info.astype(np.float32), total_par.astype(np.float32)


def qc_to_bits(tab: QCTables, total_info: np.ndarray,
               total_par: np.ndarray) -> np.ndarray:
    """Final totals -> (B, N) hard bits."""
    b = total_info.shape[-1]
    info = np.moveaxis(total_info[:tab.n_groups], -1, 0).reshape(b, tab.k)
    par = np.moveaxis(total_par.transpose(1, 0, 2), -1, 0)  # (B, 360, q)
    out = np.concatenate([info, par.reshape(b, tab.n - tab.k)], axis=1)
    return (out < 0).astype(np.uint8)
