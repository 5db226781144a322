"""Operations, bytes and the least time of K1, the layered LDPC decoder on
the superstep's path (`csrc/ldpc_layered.cu`: kernels `stage_in`,
`sweep_chunk`, `stage_out`), against the published peaks of one H100.

The arithmetic is `chip_smoke.py`'s `ldpc_bound`, with the edges counted
from the standard's tables (`gen/dvbt2/ldpc.py`): per codeword, every info
edge of the parity-check matrix plus two parity edges per check row.
Operations: 15 f32 per edge and sweep (subtract; abs, compare, two-minimum
update and sign count; abs, compare, two selects, multiply and the bf16
rounding of the new message; the two-operation write-back) and 2 per edge
and syndrome pass, for the sweeps and passes the inputs needed.  Bytes:
the LLRs read once (bf16) and the bits written once (uint8)."""
from __future__ import annotations

from .gen.dvbt2 import ldpc

# published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W)
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
OPS_PER_EDGE_SWEEP = 15
OPS_PER_EDGE_CHECK = 2
LLR_BYTES = 2                  # bf16 LLRs in
BIT_BYTES = 1                  # uint8 bits out
# the superstep's first syndrome check: from sweep 8 below an LLR scale of
# 316 (25 dB), from sweep 1 above it; then one check after every sweep.
# Copies of FLOOR_INV_NVAR and FLOOR_SWEEPS in
# `sdr_receiver_dvb_t2_tpu_torch/rx/superstep.py` (lines 29-30, read at
# line 109): a change to that schedule has to move these too, or K1's
# operations are miscounted (`tests/test_rxbench_roofline.py` compares them)
FLOOR_INV_NVAR = 316.0
FLOOR_SWEEPS = 8
# kernel names of K1 in a profiler trace
KERNELS = ("sweep_chunk", "stage_in", "stage_out")


def edges(frame, rate) -> int:
    """Edges of one codeword's Tanner graph as the layered kernel visits
    them: the info edges and two parity edges per check row."""
    code = ldpc.get_code(frame, rate)
    return len(code.acc_bit) + 2 * code.r


def checks(sweeps: int, decodes: int, inv_nvar: float) -> int:
    """Syndrome passes of `decodes` decodes that ran `sweeps` sweeps in
    all: one per sweep from the first checked sweep on."""
    first = FLOOR_SWEEPS if inv_nvar < FLOOR_INV_NVAR else 1
    return sweeps - decodes * (first - 1)


def k1_bound_s(frame, rate, batch: int, sweeps: int, n_checks: int,
               decodes: int = 1) -> tuple[float, str]:
    """The least time of `decodes` decodes of `batch` codewords that ran
    `sweeps` sweeps and `n_checks` syndrome passes in all: the larger of
    operations over the f32 rate and bytes over the memory rate.
    -> (seconds, "operations" or "bytes")."""
    e = edges(frame, rate)
    code = ldpc.get_code(frame, rate)
    ops = e * batch * (OPS_PER_EDGE_SWEEP * sweeps
                       + OPS_PER_EDGE_CHECK * n_checks)
    byts = code.n * batch * decodes * (LLR_BYTES + BIT_BYTES)
    t_ops, t_bytes = ops / F32_FLOPS, byts / HBM_BYTES_PER_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def is_k1(kernel_name: str) -> bool:
    return any(k in kernel_name for k in KERNELS)
