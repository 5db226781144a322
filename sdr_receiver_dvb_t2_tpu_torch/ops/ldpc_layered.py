"""Layered offset-min-sum QC-LDPC decoders: the ports of the TPU kernels
K1-K5 of `sdr_receiver_dvb_t2_tpu/ops/ldpc_pallas.py` and their front doors.

| kernel | TPU kernel                             | front door here                      |
|--------|----------------------------------------|--------------------------------------|
| K1     | `make_pallas_layered_vmem_adaptive_io` | `make_adaptive_decoder_nb_fused_io`  |
| K2     | `make_pallas_layered_vmem_adaptive`    | `make_adaptive_decoder_nb_fused`     |
| K3     | `make_pallas_layered_vmem`             | `make_decoder_nb` (variant "vmem")   |
| K4     | `make_pallas_layered`                  | `make_decoder_nb` (variant "hbm")    |
| K3/K4  | the same, (B, N) in and out            | `make_decoder_natural`               |
| K5     | `make_decoder_nb_fused_io`'s own call  | `make_decoder_nb_fused_io`           |

Two implementations of each:

- `csrc/ldpc_layered.cu`, the hand-written CUDA kernel, for CUDA tensors;
- a plain PyTorch version below (ports of `_build_one_iteration` with the
  bf16 message emulation, of K4's own layer body, of `qc_syndrome_weight`
  and of the exit loops), which is the kernel's reference and the path CPU
  tensors take.

The study helpers `build_layered_stepper` and `build_layered_decoder` (the
JAX XLA mirrors of the kernels' schedule, with `offset`, `scale`,
`c2v_dtype` and `layer_order` exposed) and `qc_syndrome_ok` serve the
LDPC tools; no kernel reaches them.

Both compute exactly the same bits and sweep count: every float operation
is the same IEEE f32 operation in the same order.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from ..dvbt2.params import CodeRate, FECFrame

from .. import _build
from .._device import DeviceConst
from ..utils.metrics import TRACER, count
from .ldpc_tables import BIG, QCTables, _layer_order, qc_tables

NU = 360
OFFSET = 0.5      # offset min-sum correction


# --------------------------------------------------------------------------
# Plain PyTorch versions
# --------------------------------------------------------------------------

def _stage_nb(tab: QCTables, v: torch.Tensor):
    """(N, B) LLRs -> f32 totals: info (G+1, 360, B) with a +BIG dummy
    group, parity (q, 360, B) with par[t, u] = bit k + t + q*u."""
    b = v.shape[1]
    info = v[:tab.k].reshape(tab.n_groups, NU, b).float()
    ti = torch.cat([info, torch.full((1, NU, b), BIG, device=v.device)])
    tp = v[tab.k:].reshape(NU, tab.q, b).permute(1, 0, 2).float()
    return ti, tp.contiguous()


def qc_syndrome_weight(frame: FECFrame, rate: CodeRate, total_info,
                       total_par) -> torch.Tensor:
    """Per-codeword count of failed parity checks, (B,) int32.  Check
    (t, u) sees info group g rolled by s, its own parity par[t, u] and the
    previous parity par[t-1, u] (par[q-1, u-1] for t=0; check 0 has none)."""
    return _syndrome_weight(qc_tables(frame, rate), total_info, total_par)


def qc_syndrome_ok(frame: FECFrame, rate: CodeRate, total_info,
                   total_par) -> torch.Tensor:
    """Per-codeword parity check from QC-layout totals: (B,) bool, True
    where no check fails (`qc_syndrome_weight` == 0)."""
    return qc_syndrome_weight(frame, rate, total_info, total_par) == 0


def _syndrome_weight(tab: QCTables, total_info, total_par) -> torch.Tensor:
    hard_i = (total_info < 0).int()
    hard_p = (total_par < 0).int()
    not_u0 = torch.ones((NU, 1), dtype=torch.int32, device=hard_p.device)
    not_u0[0] = 0
    bad = torch.zeros(hard_p.shape[-1], dtype=torch.int32,
                      device=hard_p.device)
    for t in range(tab.q):
        acc = hard_p[t].clone()
        for j in range(int(tab.layer_deg[t])):
            acc += torch.roll(hard_i[int(tab.entry_g[t, j])],
                              int(tab.entry_s[t, j]), 0)
        if t > 0:
            acc += hard_p[t - 1]
        else:
            acc += torch.roll(hard_p[tab.q - 1], 1, 0) * not_u0
        bad += (acc % 2).sum(0, dtype=torch.int32)
    return bad


def _stored(x: torch.Tensor, c2v_dtype) -> torch.Tensor:
    """A new message as the kernel stores it: rounded to `c2v_dtype` (bf16)
    and widened back, or as it is (f32, or None)."""
    if c2v_dtype is None or c2v_dtype == x.dtype:
        return x
    return x.to(c2v_dtype).to(x.dtype)


def layered_sweep(tab: QCTables, order: list, ti, tp, c2v,
                  c2v_dtype=torch.bfloat16) -> None:
    """One layered sweep of K1-K3 (`_make_layer_step`, two_min="scan"), in
    place, over f32 totals ti (G+1, 360, B), tp (q, 360, B) and messages
    c2v (q, degmax+2, 360, B) (slot j < deg: info edge j; deg: parity self;
    deg+1: parity prev).  New messages are stored in `c2v_dtype` (bf16
    rounding, or f32) and the stored value feeds the totals."""
    q = tab.q
    mask0 = torch.zeros((NU, 1), device=ti.device)
    mask0[0] = BIG
    for t in order:
        deg = int(tab.layer_deg[t])
        edges = [(int(tab.entry_g[t, j]), int(tab.entry_s[t, j]))
                 for j in range(deg)]
        msgs = [torch.roll(ti[g], s, 0) - c2v[t, j]
                for j, (g, s) in enumerate(edges)]
        msgs.append(tp[t] - c2v[t, deg])
        if t > 0:
            msgs.append(tp[t - 1] - c2v[t, deg + 1])
        else:
            msgs.append(torch.roll(tp[q - 1], 1, 0) - c2v[t, deg + 1]
                        + mask0)
        mags = [m.abs() for m in msgs]
        min1 = mags[0]
        min2 = torch.full_like(min1, BIG)
        nneg = (msgs[0] < 0).int()
        for m, a in zip(msgs[1:], mags[1:]):
            is_new = a < min1
            min2 = torch.where(is_new, min1, torch.minimum(min2, a))
            min1 = torch.where(is_new, a, min1)
            nneg = nneg + (m < 0).int()
        sign_all = (1 - 2 * (nneg % 2)).float()
        mag1 = torch.clamp(min1 - OFFSET, min=0.0)
        mag2 = torch.clamp(min2 - OFFSET, min=0.0)
        new = []
        for m, a in zip(msgs, mags):
            # leave-one-out without argmin: ties make min2 == min1
            loo = torch.where(a <= min1, mag2, mag1)
            sgn = torch.where(m < 0, -sign_all, sign_all)
            new.append(_stored(sgn * loo, c2v_dtype))
        for j, (g, s) in enumerate(edges):
            ti[g] += torch.roll(new[j] - c2v[t, j], -s, 0)
        tp[t] = msgs[deg] + new[deg]
        prev_new = msgs[deg + 1] + new[deg + 1]
        if t > 0:
            tp[t - 1] = prev_new
        else:
            # aligned slot u is parity (q-1, u-1); u=0 is the masked
            # non-edge and par[q-1][359] keeps its value
            tp[q - 1, :NU - 1] = torch.roll(prev_new - mask0, -1, 0)[:NU - 1]
        c2v[t, :deg + 2] = torch.stack(new)


def layered_sweep_hbm(tab: QCTables, ti, tp, c2v) -> None:
    """One sweep of K4's layer body (`make_pallas_layered`), in place, in
    natural layer order, with f32 messages (nothing rounds to bf16):
    `stepper_sweep` at the kernels' offset.  Unlike `layered_sweep` its c2v
    slots are (q, degmax+2, 360, B) with info edge j at slot j, parity self
    at degmax and parity prev at degmax+1 (the unused info slots keep 0);
    the leave-one-out minimum goes to the argmin of the strict-< scan."""
    stepper_sweep(tab, range(tab.q), ti, tp, c2v)


def stepper_sweep(tab: QCTables, order: list, ti, tp, c2v,
                  offset: float = OFFSET, scale: float = 1.0,
                  c2v_dtype=None) -> None:
    """One sweep of JAX `_build_one_iteration`, in place, in `order`: the
    study schedule of `build_layered_stepper`.  Messages c2v
    (q, degmax+2, 360, B): info edge j at slot j, parity self at degmax,
    parity prev at degmax+1; the leave-one-out minimum goes to the argmin
    of the strict-< scan; a new message is sign * max(loo - offset, 0) *
    scale, rounded to `c2v_dtype` (when given) before it feeds the totals.
    The float operations are JAX's, in JAX's order, but for the last
    parity row at layer 0: JAX blends its kept slot 359 back in
    (rolled * (1 - keep) + old * keep), this selects it, which gives the
    same values up to the sign of a zero.  At offset 0.5, scale 1 and f32
    messages in natural order it is K4's layer body (`layered_sweep_hbm`)."""
    q, dm = tab.q, tab.degmax
    dev = ti.device
    u0 = torch.zeros((NU, 1), device=dev)
    u0[0] = BIG
    u_last = torch.zeros((NU, 1), dtype=torch.bool, device=dev)
    u_last[NU - 1] = True
    off, sc = float(np.float32(offset)), float(np.float32(scale))
    for t in order:
        deg = int(tab.layer_deg[t])
        edges = [(int(tab.entry_g[t, j]), int(tab.entry_s[t, j]))
                 for j in range(deg)]
        msgs = [torch.roll(ti[g], s, 0) - c2v[t, j]
                for j, (g, s) in enumerate(edges)]
        msgs.append(tp[t] - c2v[t, dm])
        if t > 0:
            msgs.append(tp[t - 1] - c2v[t, dm + 1])
        else:
            msgs.append(torch.roll(tp[q - 1], 1, 0) - c2v[t, dm + 1] + u0)
        mags = [m.abs() for m in msgs]
        negs = [m < 0 for m in msgs]
        min1 = mags[0]
        min2 = torch.full_like(min1, BIG)
        amin = torch.zeros(min1.shape, dtype=torch.int64, device=dev)
        nneg = negs[0].int()
        for j in range(1, len(msgs)):
            is_new = mags[j] < min1
            min2 = torch.where(is_new, min1, torch.minimum(min2, mags[j]))
            min1 = torch.where(is_new, mags[j], min1)
            amin = torch.where(is_new, j, amin)
            nneg = nneg + negs[j].int()
        sign_all = 1.0 - 2.0 * (nneg % 2).float()
        new = []
        for j in range(len(msgs)):
            loo = torch.where(amin == j, min2, min1)
            sgn = sign_all * torch.where(negs[j], -1.0, 1.0)
            new.append(_stored(sgn * (torch.clamp(loo - off, min=0.0) * sc),
                               c2v_dtype))
        for j, (g, s) in enumerate(edges):
            ti[g] = ti[g] + torch.roll(new[j] - c2v[t, j], NU - s, 0)
            c2v[t, j] = new[j]
        tp[t] = msgs[deg] + new[deg]
        prev_new = msgs[deg + 1] + new[deg + 1]
        if t == 0:
            # aligned slot u is parity (q-1, u-1); u=0 is the masked
            # non-edge and par[q-1][359] keeps its value
            tp[q - 1] = torch.where(u_last, tp[q - 1],
                                    torch.roll(prev_new, NU - 1, 0))
        else:
            tp[t - 1] = prev_new
        c2v[t, dm] = new[deg]
        c2v[t, dm + 1] = new[deg + 1]


def build_layered_stepper(frame: FECFrame, rate: CodeRate,
                          offset: float = OFFSET, scale: float = 1.0,
                          c2v_dtype=None, layer_order=None):
    """One layered sweep over explicit state:
    fn(total_info, total_par, c2v) -> (total_info', total_par', c2v'),
    its inputs left as they were (JAX `build_layered_stepper`).  `scale`
    multiplies the corrected magnitude (normalized min-sum; scale=1 with
    offset 0.5 is the kernels' rule); `c2v_dtype` (e.g. bf16) rounds each
    new message to that precision before it feeds the totals, as the
    kernels store it; `layer_order`: None, "reversed" or a permutation."""
    tab = qc_tables(frame, rate)
    order = _layer_order(tab.q, layer_order)

    def step(ti, tp, c2v):
        ti, tp, c2v = ti.clone(), tp.clone(), c2v.clone()
        stepper_sweep(tab, order, ti, tp, c2v, offset, scale, c2v_dtype)
        return ti, tp, c2v

    return step


def build_layered_decoder(frame: FECFrame, rate: CodeRate, iters: int,
                          offset: float = OFFSET):
    """fn(total_info, total_par) -> (total_info', total_par'): `iters`
    sweeps of `build_layered_stepper`'s schedule in natural order with f32
    messages from zero (JAX `build_layered_decoder`)."""
    tab = qc_tables(frame, rate)
    order = list(range(tab.q))

    def decode(ti, tp):
        ti, tp = ti.clone(), tp.clone()
        c2v = torch.zeros((tab.q, tab.degmax + 2) + tp.shape[1:],
                          dtype=ti.dtype, device=ti.device)
        for _ in range(iters):
            stepper_sweep(tab, order, ti, tp, c2v, offset)
        return ti, tp

    return decode


def _unstage_bits(tab: QCTables, ti, tp) -> torch.Tensor:
    b = ti.shape[-1]
    info = ti[:tab.n_groups].reshape(tab.k, b)
    par = tp.permute(1, 0, 2).reshape(tab.n - tab.k, b)
    return (torch.cat([info, par]) < 0).to(torch.uint8)


def decode_plain(tab: QCTables, order: list, v: torch.Tensor, min_it,
                 max_iters: int, check_every: int, min_iters: int,
                 failing: list | None = None):
    """K1's and K2's semantics in plain PyTorch: sweeps in chunks of
    check_every; the whole batch's syndrome is counted once the sweep count
    reaches max(min_it, min_iters); stop when it is 0; the count is
    max_iters if it never is.  -> (bits (N, B) uint8, iters () int32).
    `failing`, when given, gets one int per chunk's vote, as the kernel's
    ctl holds them: the codewords whose own syndrome failed there, 0 where
    no vote ran."""
    ti, tp = _stage_nb(tab, v)
    c2v = torch.zeros((tab.q, tab.degmax + 2) + tp.shape[1:],
                      device=v.device)
    floor_it = max(int(min_it), min_iters)
    iters = max_iters
    n_votes = (max_iters + check_every - 1) // check_every
    votes = [0] * n_votes
    for ci in range(n_votes):
        for _ in range(check_every):
            layered_sweep(tab, order, ti, tp, c2v)
        it_now = (ci + 1) * check_every
        if it_now >= floor_it:
            bad = _syndrome_weight(tab, ti, tp)
            votes[ci] = int((bad != 0).sum())
            if votes[ci] == 0:
                iters = it_now
                break
    if failing is not None:
        failing[:] = votes
    return (_unstage_bits(tab, ti, tp),
            torch.tensor(iters, dtype=torch.int32, device=v.device))


def lockstep_counts(failing, iters, batch: int, check_every: int):
    """The batch-lockstep exit's counters of one adaptive decode, from
    the codewords failing at each chunk's vote (`failing`, (V,) integer
    tensor, 0 where no vote ran) and the sweeps it ran (`iters`).
    -> (codeword_sweeps: batch x iters, clean_codeword_sweeps: the sweeps
    run on codewords whose syndrome was already clean at the vote before
    them).  A vote with codewords failing is followed by another chunk of
    `check_every` sweeps, but for the last; a vote with none ends the
    decode, and one that did not run reads 0.  Codewords that clear before
    the first vote are not seen, so the second count is a lower bound.
    The kernel keeps the same two counts in its ctl (CTL_LOCKSTEP)."""
    f = failing[:-1].long()
    clean = ((batch - f) * (f > 0)).sum() * check_every
    return iters.long() * batch, clean


def decode_fixed_plain(tab: QCTables, v: torch.Tensor, iters: int,
                       variant: str) -> torch.Tensor:
    """K3 and K5 ("vmem", bf16 c2v) or K4 ("hbm", f32 c2v): exactly
    `iters` sweeps in natural layer order, no syndrome check; the totals
    start from `v` widened to f32 (K5's caller has rounded it to bf16).
    -> bits (N, B) uint8."""
    ti, tp = _stage_nb(tab, v.float())
    c2v = torch.zeros((tab.q, tab.degmax + 2) + tp.shape[1:],
                      device=v.device)
    order = list(range(tab.q))
    for _ in range(iters):
        if variant == "hbm":
            layered_sweep_hbm(tab, ti, tp, c2v)
        else:
            layered_sweep(tab, order, ti, tp, c2v)
    return _unstage_bits(tab, ti, tp)


# --------------------------------------------------------------------------
# CUDA kernel wrappers: one per TPU kernel, each with its own launch count
# --------------------------------------------------------------------------

def _lib() -> ctypes.CDLL:
    lib = _build.load("ldpc_layered")
    if lib.ldpc_k1_decode.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        for name in ("ldpc_k1_decode", "ldpc_k2_decode"):
            fn = getattr(lib, name)
            fn.argtypes = [p] * 8 + [i] * 11 + [f, p]
            fn.restype = i
        for name in ("ldpc_k3_decode", "ldpc_k4_decode", "ldpc_k5_decode"):
            fn = getattr(lib, name)
            fn.argtypes = [p] * 7 + [i] * 8 + [f, p]
            fn.restype = i
        lib.ldpc_layered_smem_limit.restype = i
        for name in ("ldpc_layered_has_degree", "ldpc_layered_has_uniform"):
            getattr(lib, name).argtypes = [i]
            getattr(lib, name).restype = i
        lib.ldpc_layered_row_bytes.argtypes = [i]
        lib.ldpc_layered_row_bytes.restype = i
        lib.ldpc_layered_error_string.argtypes = [i]
        lib.ldpc_layered_error_string.restype = ctypes.c_char_p
        lib.ldpc_layered_layout.argtypes = [p]
        lib.ldpc_layered_layout.restype = None
        layout = (i * len(TABLE_LAYOUT))()
        lib.ldpc_layered_layout(layout)
        if tuple(layout) != TABLE_LAYOUT:
            raise RuntimeError(f"the kernel reads the table layout "
                               f"{tuple(layout)}, pack_tables writes "
                               f"{TABLE_LAYOUT}")
    return lib


# The kernel's table: one row of TABLE_HDR + 2 * degmax int32 words per
# layer, in visiting order.
TABLE_HDR = 4
# where a layer's parity total comes from, given the layer visited before
SRC_EARLY = 0        # loaded one layer ahead (the layer before leaves it)
SRC_CARRY_SELF = 1   # the self total the thread wrote in the layer before
SRC_CARRY_PREV = 2   # the prev total the thread wrote in the layer before
SRC_LATE = 3         # loaded behind the barrier (written across threads)
# shared memory the kernel keeps for its static variables, and what one CTA
# may use beside them on the H100
SMEM_STATIC = 128
SMEM_BYTES = 232448 - SMEM_STATIC
# threads of one CTA: one per check row, NU rounded up to whole warps
THREADS = 384
# edges (degmax + 2) whose sign bits fit a stored row beside its index
MAX_EDGES = 24
# edges whose 2-bit phase sits in word 3; the later ones go to word 1
PHASE_LO_EDGES = 16
# the kernel's control words: a header (done, sweeps, the bad-check sum
# and arrivals of a launch per chunk, then the lockstep counters: B x
# sweeps, and the clean codeword-sweeps), then per exit vote the resident
# launch's sum and arrivals and the codewords failing there
CTL_HDR = 6
CTL_VOTE = 3
CTL_LOCKSTEP = slice(4, 6)
CTL_FAILING = slice(CTL_HDR + 2, None, CTL_VOTE)
# the same constants in the kernel source, in the order of its
# `ldpc_layered_layout`; `_lib` refuses a library that disagrees
TABLE_LAYOUT = (TABLE_HDR, SRC_EARLY, SRC_CARRY_SELF, SRC_CARRY_PREV,
                SRC_LATE, MAX_EDGES, PHASE_LO_EDGES)


def _parity_sources(q: int, t: int, before: int) -> tuple[int, int]:
    """Where layer t takes its two parity totals from when layer `before`
    ran just ahead of it.  Layer `before` writes row `before` and row
    `before - 1` with thread u at column u (a register carries them), or,
    at before == 0, row q-1 one column to the left (another thread's)."""
    if t == before:                       # q == 1 only
        return SRC_LATE, SRC_LATE
    if before > 0 and t == before - 1:
        s_self = SRC_CARRY_PREV
    elif before == 0 and t == q - 1:
        s_self = SRC_LATE
    else:
        s_self = SRC_EARLY
    if t > 0:
        s_prev = SRC_CARRY_SELF if t - 1 == before else SRC_EARLY
    else:
        # row q-1 read one column to the left: another thread's value
        s_prev = SRC_LATE if before == q - 1 else SRC_EARLY
    return s_self, s_prev


def pack_tables(tab: QCTables, order) -> np.ndarray:
    """The kernel's table argument, (q, TABLE_HDR + 2 * degmax) int32
    flattened, row li for the li-th layer visited:
      word 0  t
      word 1  deg | phases << 8 | the phase bits of edges 16.. << 16
              (phases: 1 + the most earlier edges of this layer that hit
              one edge's group; a barrier separates two phases)
      word 2  source of the self parity total | source of the prev one << 4
              (`_parity_sources`, with the layer visited before, cyclically)
      word 3  the phase of edge j in bits 2j, 2j+1, for j < 16: how many
              earlier edges of the layer have the same g
      words 4+2j, 5+2j  for info edge j: the byte offset 4*(g*360 - shift),
              and shift.  Check row u reads the f32 total at that offset
              plus 4*u, plus 4*360 where u < shift."""
    order = [int(t) for t in order]
    q = tab.q
    out = np.zeros((q, TABLE_HDR + 2 * tab.degmax), dtype=np.int64)
    for li, t in enumerate(order):
        deg = int(tab.layer_deg[t])
        seen: dict[int, int] = {}
        phases, phase_bits = 1, 0
        for j in range(deg):
            g, s = int(tab.entry_g[t, j]), int(tab.entry_s[t, j])
            ph = seen.get(g, 0)
            seen[g] = ph + 1
            if ph > 3:
                raise ValueError("an info group repeats more than 4 times "
                                 "in one layer")
            phases = max(phases, ph + 1)
            phase_bits |= ph << (2 * j)
            out[li, TABLE_HDR + 2 * j] = 4 * (g * NU - s)
            out[li, TABLE_HDR + 2 * j + 1] = s
        s_self, s_prev = _parity_sources(q, t, order[li - 1])
        out[li, 0] = t
        lo_bits = 2 * PHASE_LO_EDGES
        out[li, 1] = deg | (phases << 8) | ((phase_bits >> lo_bits) << 16)
        out[li, 2] = s_self | (s_prev << 4)
        out[li, 3] = phase_bits & ((1 << lo_bits) - 1)
    return out.reshape(-1).astype(np.uint32).view(np.int32)


def uniform_degree(tab: QCTables) -> int:
    """The row degree all layers share (every NORMAL code, SHORT C2/3 and
    C3/5: they run a kernel compiled for that degree), else 0."""
    degs = set(tab.layer_deg.tolist())
    return degs.pop() if len(degs) == 1 else 0


def row_bytes(c2v_dtype) -> int:
    """Bytes of one check's stored messages.  The kernel keeps what min-sum
    makes of a row, whatever its degree: the two magnitudes its new
    messages take (in `c2v_dtype`), one sign bit per edge and the index of
    the edge that holds the second magnitude, in 8 bytes for bf16 and 16
    for f32.  Every message comes back bit for bit."""
    return 8 if c2v_dtype == torch.bfloat16 else 16


def smem_bytes(tab: QCTables) -> int:
    """Dynamic shared memory of one CTA: the tables (padded to 16 bytes)
    and the f32 info totals.  The messages never pass through it."""
    tab_words = -(-(tab.q * (TABLE_HDR + 2 * tab.degmax)) // 4) * 4
    return 4 * tab_words + 4 * tab.n_groups * NU


def check_fits(tab: QCTables, limit: int = SMEM_BYTES) -> None:
    """Raise unless one CTA's shared memory holds the code's tables and
    info totals (there is no smaller path to fall back to)."""
    if smem_bytes(tab) > limit:
        raise ValueError(f"the code's tables and info totals need "
                         f"{smem_bytes(tab)} bytes of shared memory; one CTA "
                         f"has {limit}")


def resident_ctas(tab: QCTables, device) -> int:
    """The most CTAs of one decode of `tab`'s code that the card
    `device` could hold at once: its SMs times what an SM's threads and
    shared memory allow.  The launcher's `configure` asks the CUDA
    runtime, which also counts the kernel's registers and the shared
    memory the runtime reserves per CTA, so its answer is never larger: a
    batch above this one runs one launch per chunk, never the resident
    cooperative launch."""
    pr = torch.cuda.get_device_properties(device)
    per_sm = min(pr.max_threads_per_multi_processor // THREADS,
                 pr.shared_memory_per_multiprocessor
                 // (smem_bytes(tab) + SMEM_STATIC))
    return per_sm * pr.multi_processor_count


def overlaps(batch: int, resident: int) -> bool:
    """Whether decodes of `batch` codewords gain from running beside one
    another on separate streams: one decode needs more CTAs than the card
    holds at once (`resident`, `resident_ctas`), so each of its launches
    ends in a wave that leaves SMs idle, which another decode's CTAs can
    fill.  A batch the card holds at once runs as one cooperative launch,
    which is never run beside another."""
    return batch > resident


def decodes_overlap(tab: QCTables, batch: int, device) -> bool:
    """`overlaps` for decodes of `batch` codewords on `device`: never on
    the CPU."""
    return torch.device(device).type == "cuda" and overlaps(
        batch, resident_ctas(tab, device))


def _prepare(name: str, tab: QCTables, tables: torch.Tensor,
             v: torch.Tensor, in_dtype, c2v_dtype, votes: int = 0):
    """Check the inputs of one launch and allocate its outputs and
    scratch (`votes`: exit votes of an adaptive decode, each with CTL_VOTE
    words in ctl after its CTL_HDR).  -> (lib, x (N, B) contiguous, udeg,
    bits, ti, tp, c2v, ctl)."""
    if not v.is_cuda:
        raise ValueError(f"{name} needs a CUDA tensor")
    if v.dtype != in_dtype or v.dim() != 2 or v.shape[0] != tab.n \
            or v.shape[1] < 1:
        raise ValueError(f"{name}: expected ({tab.n}, B) {in_dtype} LLRs, "
                         f"got {tuple(v.shape)} {v.dtype}")
    if tables.device != v.device:
        raise ValueError(f"{name}: tables and LLRs must share a device")
    lib = _lib()
    check_fits(tab, lib.ldpc_layered_smem_limit())
    udeg = uniform_degree(tab)
    rb = row_bytes(c2v_dtype)
    have = (lib.ldpc_layered_has_uniform(udeg) if udeg else
            all(lib.ldpc_layered_has_degree(d)
                for d in set(tab.layer_deg.tolist())))
    if lib.ldpc_layered_row_bytes(c2v_dtype.itemsize) != rb:
        raise RuntimeError(f"{name}: the kernel's stored row is not "
                           f"{rb} bytes")
    if not have or tab.degmax + 2 > MAX_EDGES or not 2 <= tab.q <= 96:
        raise ValueError(f"{name}: the kernel is not compiled for this "
                         "code's row degrees")
    b, dev = v.shape[1], v.device
    bits = torch.empty((tab.n, b), dtype=torch.uint8, device=dev)
    ti = torch.empty((b, tab.n_groups, NU), dtype=torch.float32, device=dev)
    tp = torch.empty((b, tab.q, NU), dtype=torch.float32, device=dev)
    c2v = torch.empty((b, tab.q, NU, rb // 4), dtype=torch.int32, device=dev)
    ctl = torch.empty(CTL_HDR + CTL_VOTE * votes, dtype=torch.int32,
                      device=dev)
    return lib, v.contiguous(), udeg, bits, ti, tp, c2v, ctl


def _raise_on(lib, name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: "
                           + lib.ldpc_layered_error_string(err).decode())


def _adaptive_launch(name, in_dtype, tab, tables, v, min_it, max_iters,
                     check_every, min_iters, count):
    if min_it.device != v.device or min_it.dtype != torch.int32 \
            or min_it.numel() != 1:
        raise ValueError(f"{name}: min_it must be one int32 on the LLRs' "
                         "device")
    if max_iters < 1 or check_every < 1:
        raise ValueError(f"{name}: max_iters and check_every must be >= 1")
    lib, x, udeg, bits, ti, tp, c2v, ctl = _prepare(
        name, tab, tables, v, in_dtype, torch.bfloat16,
        votes=-(-max_iters // check_every))
    mi = min_it.contiguous()
    fn = getattr(lib, "ldpc_k1_decode" if in_dtype == torch.bfloat16
                 else "ldpc_k2_decode")
    err = fn(x.data_ptr(), bits.data_ptr(), ti.data_ptr(), tp.data_ptr(),
             c2v.data_ptr(), ctl.data_ptr(), tables.data_ptr(), mi.data_ptr(),
             v.shape[1], tab.n, tab.k, tab.n_groups, tab.q, tab.degmax,
             max_iters, check_every, min_iters, udeg, int(count), OFFSET,
             torch.cuda.current_stream(v.device).cuda_stream)
    _raise_on(lib, name, err)
    return bits, ctl


def _fixed_launch(name, k_fn, tab, tables, v, iters, c2v_dtype,
                  in_dtype=torch.float32):
    lib, x, udeg, bits, ti, tp, c2v, ctl = _prepare(
        name, tab, tables, v, in_dtype, c2v_dtype)
    err = getattr(lib, k_fn)(
        x.data_ptr(), bits.data_ptr(), ti.data_ptr(), tp.data_ptr(),
        c2v.data_ptr(), ctl.data_ptr(), tables.data_ptr(), v.shape[1], tab.n,
        tab.k, tab.n_groups, tab.q, tab.degmax, iters, udeg, OFFSET,
        torch.cuda.current_stream(v.device).cuda_stream)
    _raise_on(lib, name, err)
    return bits


def ldpc_layered_cuda(tab: QCTables, tables: torch.Tensor, v: torch.Tensor,
                      min_it: torch.Tensor, max_iters: int, check_every: int,
                      min_iters: int, count: bool = False):
    """K1: (N, B) bf16 LLRs on the card -> (bits (N, B) uint8, ctl int32:
    the sweeps at ctl[1]; with `count` (the kernel's counting build) also
    the lockstep counters at CTL_LOCKSTEP and each exit vote's failing
    codewords at CTL_FAILING; on the card); nothing is read back to the
    host."""
    out = _adaptive_launch("ldpc_layered_cuda", torch.bfloat16, tab, tables,
                           v, min_it, max_iters, check_every, min_iters,
                           count)
    ldpc_layered_cuda.launches += 1
    return out


def ldpc_layered_adaptive_cuda(tab: QCTables, tables: torch.Tensor,
                               v: torch.Tensor, min_it: torch.Tensor,
                               max_iters: int, check_every: int,
                               min_iters: int, count: bool = False):
    """K2: as K1 from (N, B) f32 LLRs, which are never rounded."""
    out = _adaptive_launch("ldpc_layered_adaptive_cuda", torch.float32, tab,
                           tables, v, min_it, max_iters, check_every,
                           min_iters, count)
    ldpc_layered_adaptive_cuda.launches += 1
    return out


def ldpc_layered_vmem_cuda(tab: QCTables, tables: torch.Tensor,
                           v: torch.Tensor, iters: int):
    """K3: `iters` sweeps from (N, B) f32 LLRs, bf16 c2v -> bits (N, B)
    uint8."""
    out = _fixed_launch("ldpc_layered_vmem_cuda", "ldpc_k3_decode", tab,
                        tables, v, iters, torch.bfloat16)
    ldpc_layered_vmem_cuda.launches += 1
    return out


def ldpc_layered_hbm_cuda(tab: QCTables, tables: torch.Tensor,
                          v: torch.Tensor, iters: int):
    """K4: `iters` sweeps of K4's layer body from (N, B) f32 LLRs, f32
    c2v."""
    out = _fixed_launch("ldpc_layered_hbm_cuda", "ldpc_k4_decode", tab,
                        tables, v, iters, torch.float32)
    ldpc_layered_hbm_cuda.launches += 1
    return out


def ldpc_layered_fused_io_cuda(tab: QCTables, tables: torch.Tensor,
                               v: torch.Tensor, iters: int):
    """K5: `iters` sweeps from (N, B) bf16 LLRs, bf16 c2v -> bits (N, B)
    uint8."""
    out = _fixed_launch("ldpc_layered_fused_io_cuda", "ldpc_k5_decode", tab,
                        tables, v, iters, torch.bfloat16, torch.bfloat16)
    ldpc_layered_fused_io_cuda.launches += 1
    return out


for _fn in (ldpc_layered_cuda, ldpc_layered_adaptive_cuda,
            ldpc_layered_vmem_cuda, ldpc_layered_hbm_cuda,
            ldpc_layered_fused_io_cuda):
    _fn.launches = 0


def _min_it_on(min_it, dev) -> torch.Tensor:
    if isinstance(min_it, torch.Tensor):
        return min_it.to(device=dev, dtype=torch.int32).reshape(1)
    return torch.full((1,), int(min_it), dtype=torch.int32, device=dev)


# --------------------------------------------------------------------------
# Front doors
# --------------------------------------------------------------------------

class AdaptiveDecoderNB:
    """fn(llrs_t (N, B), min_it=0) -> (bits (N, B) uint8, iters () int32).

    The counterpart of `make_adaptive_decoder_nb_fused_io` (K1: LLRs round
    to bf16 on entry, as the TPU kernel stages them) or, with f32_in, of
    `make_adaptive_decoder_nb_fused` (K2: LLRs enter as f32 totals).  A
    CUDA tensor goes through the CUDA kernel, a CPU tensor through the
    plain version.  Any B >= 1 (`batch`, when given, is checked).
    `min_it` (int or one-element int tensor) is the traced first-check
    floor."""

    def __init__(self, frame: FECFrame, rate: CodeRate, max_iters: int = 24,
                 check_every: int = 2, batch: int | None = None,
                 min_iters: int = 0, layer_order=None, f32_in: bool = False):
        self.tab = qc_tables(frame, rate)
        self.order = _layer_order(self.tab.q, layer_order)
        self.max_iters = max_iters
        self.check_every = check_every
        self.batch = batch
        self.min_iters = min_iters
        self.in_dtype = torch.float32 if f32_in else torch.bfloat16
        self._tables = DeviceConst(pack_tables(self.tab, self.order))

    def _input(self, llrs_t: torch.Tensor) -> torch.Tensor:
        if llrs_t.dim() != 2 or llrs_t.shape[0] != self.tab.n or (
                self.batch is not None and llrs_t.shape[1] != self.batch):
            raise ValueError(f"expected ({self.tab.n}, "
                             f"{self.batch or 'B'}) LLRs, got "
                             f"{tuple(llrs_t.shape)}")
        return llrs_t.to(self.in_dtype)

    def __call__(self, llrs_t: torch.Tensor, min_it=0):
        if llrs_t.device.type == "cpu":
            return self.plain(llrs_t, min_it)
        return self.kernel(llrs_t, min_it)

    def kernel(self, llrs_t: torch.Tensor, min_it=0):
        """The CUDA kernel (CUDA tensors only); its counting build while
        the tracer is on."""
        bits, ctl = self._launch(llrs_t, min_it, TRACER.on)
        return bits, ctl[1]

    def kernel_votes(self, llrs_t: torch.Tensor, min_it=0):
        """The kernel's counting build -> (bits, iters, failing (V,)
        int32: the codewords whose syndrome failed at each exit vote, 0
        where none ran, lockstep (2,) int32: the kernel's
        `lockstep_counts`), all on the card."""
        bits, ctl = self._launch(llrs_t, min_it, True)
        return bits, ctl[1], ctl[CTL_FAILING], ctl[CTL_LOCKSTEP]

    def _launch(self, llrs_t: torch.Tensor, min_it, count: bool):
        v = self._input(llrs_t)
        launch = (ldpc_layered_cuda if self.in_dtype == torch.bfloat16
                  else ldpc_layered_adaptive_cuda)
        bits, ctl = launch(self.tab, self._tables.on(v.device), v,
                           _min_it_on(min_it, v.device), self.max_iters,
                           self.check_every, self.min_iters, count)
        if TRACER.on:
            _count(*ctl[CTL_LOCKSTEP])
        return bits, ctl

    def plain(self, llrs_t: torch.Tensor, min_it=0):
        """The plain PyTorch version on any device (the kernel's
        reference on the card)."""
        bits, iters, _, _ = self.plain_votes(llrs_t, min_it)
        return bits, iters

    def plain_votes(self, llrs_t: torch.Tensor, min_it=0):
        """The plain version -> `kernel_votes`' four results."""
        v = self._input(llrs_t)
        failing = []
        bits, iters = decode_plain(self.tab, self.order, v, min_it,
                                   self.max_iters, self.check_every,
                                   self.min_iters, failing=failing)
        failing = torch.tensor(failing, dtype=torch.int32, device=v.device)
        sweeps, clean = lockstep_counts(failing, iters, v.shape[1],
                                        self.check_every)
        if TRACER.on:
            _count(sweeps, clean)
        return bits, iters, failing, torch.stack([sweeps, clean]).int()


def _count(sweeps, clean) -> None:
    """The tracer's LDPC counters of one decode."""
    count("ldpc.codeword_sweeps", sweeps)
    count("ldpc.clean_codeword_sweeps", clean)


def make_adaptive_decoder_nb_fused_io(frame: FECFrame, rate: CodeRate,
                                      max_iters: int = 24,
                                      check_every: int = 2,
                                      batch: int | None = None,
                                      dtype=torch.bfloat16,
                                      min_iters: int = 0,
                                      layer_order=None) -> AdaptiveDecoderNB:
    """K1's front door.  Only dtype=bf16 exists: the kernel stages LLRs
    and stores c2v in bf16."""
    if dtype != torch.bfloat16:
        raise ValueError("the layered decoder runs on bf16 LLRs")
    return AdaptiveDecoderNB(frame, rate, max_iters=max_iters,
                             check_every=check_every, batch=batch,
                             min_iters=min_iters, layer_order=layer_order)


def make_adaptive_decoder_nb_fused(frame: FECFrame, rate: CodeRate,
                                   max_iters: int = 24, check_every: int = 2,
                                   batch: int | None = None,
                                   min_iters: int = 0,
                                   layer_order=None) -> AdaptiveDecoderNB:
    """K2's front door: f32 totals in (`llrs_nb_to_qc_jnp(llrs.astype(
    f32))`, no bf16 rounding of the input), bf16 c2v, K1's exit.  Not
    ported: the `dtype` override (no caller sets it) and the TPU kernel's
    rolling=True variant (Mosaic never compiled it)."""
    return AdaptiveDecoderNB(frame, rate, max_iters=max_iters,
                             check_every=check_every, batch=batch,
                             min_iters=min_iters, layer_order=layer_order,
                             f32_in=True)


_VMEM_BUDGET = 96 * 1024 * 1024


def vmem_fit_bytes(frame: FECFrame, rate: CodeRate, batch: int,
                   c2v_bytes: int = 2) -> int:
    """VMEM bytes the TPU's fully-resident kernel K3 needs for this
    code/batch (the JAX package's rule, kept byte for byte: it selects K3's
    or K4's numerics in `make_core`; on the H100 both kernels stream c2v
    from device memory)."""
    tab = qc_tables(frame, rate)
    tile = 360 * batch
    e = tab.degmax + 2
    return (tile * 4 * (tab.n_groups + 1)      # totals (info)
            + tile * 4 * tab.q                 # totals (parity)
            + tile * c2v_bytes * tab.q * e     # resident c2v
            + tile * 4 * e                     # msgs scratch
            + tile * 4 * 4)                    # slack (iota/masks/regs)


@dataclass(frozen=True)
class LayeredCore:
    """The fixed-iteration core `make_core` selects: variant "vmem" (K3)
    or "hbm" (K4) and its sweep count."""
    variant: str
    iters: int

    @property
    def c2v_dtype(self) -> torch.dtype:
        """bf16 messages for K3, f32 for K4."""
        return torch.bfloat16 if self.variant == "vmem" else torch.float32


def make_core(frame: FECFrame, rate: CodeRate, iters: int, batch: int,
              variant: str = "auto") -> LayeredCore:
    """The JAX `make_core` choice with its default dtypes: K3 ("vmem",
    bf16 c2v) when `vmem_fit_bytes` is within 96 MB, K4 ("hbm", f32 c2v)
    otherwise.  Not ported: the `dtype` override (no caller uses it) and
    the TPU's "vmem16" variant (bf16 scan; Mosaic rejected it)."""
    if variant == "auto":
        fits = vmem_fit_bytes(frame, rate, batch) <= _VMEM_BUDGET
        variant = "vmem" if fits else "hbm"
    if variant not in ("vmem", "hbm"):
        raise ValueError(f"unknown layered-decoder variant {variant!r}")
    return LayeredCore(variant, iters)


class FixedDecoderNB:
    """fn(llrs_t (N, B)) -> bits (N, B) uint8: `iters` layered sweeps in
    natural order from f32 totals (K3 or K4, by `core.variant`).  A CUDA
    tensor goes through the CUDA kernel, a CPU tensor through the plain
    version."""

    def __init__(self, frame: FECFrame, rate: CodeRate, core: LayeredCore,
                 batch: int):
        self.tab = qc_tables(frame, rate)
        self.core = core
        self.batch = batch
        self._tables = DeviceConst(pack_tables(self.tab, range(self.tab.q)))

    def _input(self, llrs_t: torch.Tensor) -> torch.Tensor:
        if llrs_t.shape != (self.tab.n, self.batch):
            raise ValueError(f"expected ({self.tab.n}, {self.batch}) LLRs, "
                             f"got {tuple(llrs_t.shape)}")
        return llrs_t.float()

    def __call__(self, llrs_t: torch.Tensor) -> torch.Tensor:
        if llrs_t.device.type == "cpu":
            return self.plain(llrs_t)
        return self.kernel(llrs_t)

    def kernel(self, llrs_t: torch.Tensor) -> torch.Tensor:
        """The CUDA kernel (CUDA tensors only)."""
        v = self._input(llrs_t)
        launch = (ldpc_layered_vmem_cuda if self.core.variant == "vmem"
                  else ldpc_layered_hbm_cuda)
        return launch(self.tab, self._tables.on(v.device), v,
                      self.core.iters)

    def plain(self, llrs_t: torch.Tensor) -> torch.Tensor:
        """The plain PyTorch version on any device."""
        return decode_fixed_plain(self.tab, self._input(llrs_t),
                                  self.core.iters, self.core.variant)


def make_decoder_nb(frame: FECFrame, rate: CodeRate, iters: int, batch: int,
                    variant: str = "auto") -> FixedDecoderNB:
    """The layered decoder over (N, B) LLRs: `make_core`'s choice of K3 or
    K4 behind the (N, B) layout."""
    return FixedDecoderNB(frame, rate, make_core(frame, rate, iters, batch,
                                                 variant=variant), batch)


def make_decoder_natural(frame: FECFrame, rate: CodeRate, iters: int,
                         batch: int):
    """The layered decoder with the natural (B, N) layout in and out
    (`make_decoder_nb` behind a transpose: K3 or K4 by `make_core`'s
    choice).  fn(llrs (B, N)) -> bits (B, N) uint8."""
    dec = make_decoder_nb(frame, rate, iters, batch)

    def decode(llrs: torch.Tensor) -> torch.Tensor:
        return dec(llrs.T).T

    return decode


class FusedIODecoderNB:
    """fn(llrs_t (N, B)) -> bits (N, B) uint8: K5.  The LLRs are rounded
    to bf16 BEFORE they become f32 totals (the TPU kernel stages them
    through its bf16 c2v scratch), then `iters` layered sweeps run in
    natural order with bf16 c2v and no syndrome check: K3's sweeps on
    bf16-rounded input.  A CUDA tensor goes through the CUDA kernel, a CPU
    tensor through the plain version."""

    def __init__(self, frame: FECFrame, rate: CodeRate, iters: int,
                 batch: int):
        self.tab = qc_tables(frame, rate)
        e = self.tab.degmax + 2
        # the TPU kernel stages info and parity LLRs in rows of its
        # (q, E, 360, B) c2v scratch; a code whose staging does not fit has
        # no K5 there, and none here
        if -(-self.tab.n_groups // e) + -(-self.tab.q // e) > self.tab.q:
            raise ValueError("staging exceeds the c2v scratch for this code")
        self.iters = iters
        self.batch = batch
        self._tables = DeviceConst(pack_tables(self.tab, range(self.tab.q)))

    def _input(self, llrs_t: torch.Tensor) -> torch.Tensor:
        if llrs_t.shape != (self.tab.n, self.batch):
            raise ValueError(f"expected ({self.tab.n}, {self.batch}) LLRs, "
                             f"got {tuple(llrs_t.shape)}")
        return llrs_t.to(torch.bfloat16)

    def __call__(self, llrs_t: torch.Tensor) -> torch.Tensor:
        if llrs_t.device.type == "cpu":
            return self.plain(llrs_t)
        return self.kernel(llrs_t)

    def kernel(self, llrs_t: torch.Tensor) -> torch.Tensor:
        """The CUDA kernel (CUDA tensors only)."""
        v = self._input(llrs_t)
        return ldpc_layered_fused_io_cuda(
            self.tab, self._tables.on(v.device), v, self.iters)

    def plain(self, llrs_t: torch.Tensor) -> torch.Tensor:
        """The plain PyTorch version on any device."""
        return decode_fixed_plain(self.tab, self._input(llrs_t), self.iters,
                                  "vmem")


def make_decoder_nb_fused_io(frame: FECFrame, rate: CodeRate, iters: int,
                             batch: int) -> FusedIODecoderNB:
    """K5's front door.  Raises ValueError for a code whose LLR staging
    does not fit the TPU kernel's c2v scratch, as the JAX function does.
    Only bf16 exists (the JAX `dtype` override is not ported)."""
    return FusedIODecoderNB(frame, rate, iters, batch)
