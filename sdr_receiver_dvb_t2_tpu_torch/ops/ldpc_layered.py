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
    """A new message as the kernel stores it (bf16 rounding or f32)."""
    return x.to(torch.bfloat16).float() if c2v_dtype == torch.bfloat16 else x


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
    natural layer order, with f32 messages (nothing rounds to bf16).
    Unlike `layered_sweep` its c2v slots are
    (q, degmax+2, 360, B) with info edge j at slot j, parity self at degmax
    and parity prev at degmax+1; the unused info slots j >= deg enter the
    two-minimum scan as +BIG messages (and store 0); the leave-one-out
    minimum goes to the argmin of the strict-< scan."""
    q, dm = tab.q, tab.degmax
    e = dm + 2
    u_last = torch.zeros((NU, 1), dtype=torch.bool, device=ti.device)
    u_last[NU - 1] = True
    zeros = torch.zeros((NU, 1), device=ti.device)
    for t in range(q):
        deg = int(tab.layer_deg[t])
        edges = [(int(tab.entry_g[t, j]), int(tab.entry_s[t, j]))
                 for j in range(deg)]
        msgs = [torch.roll(ti[g], s, 0) - c2v[t, j]
                for j, (g, s) in enumerate(edges)]
        msgs += [torch.full_like(tp[t], BIG) for _ in range(deg, dm)]
        msgs.append(tp[t] - c2v[t, dm])
        mask0 = zeros.clone()
        if t == 0:
            mask0[0] = BIG
            prev_al = torch.roll(tp[q - 1], 1, 0)
        else:
            prev_al = tp[t - 1]
        msgs.append(prev_al - c2v[t, e - 1] + mask0)
        min1 = msgs[0].abs()
        min2 = torch.full_like(min1, BIG)
        amin = torch.zeros(min1.shape, dtype=torch.int64, device=ti.device)
        nneg = (msgs[0] < 0).int()
        for j in range(1, e):
            aj = msgs[j].abs()
            is_new = aj < min1
            min2 = torch.where(is_new, min1, torch.minimum(min2, aj))
            min1 = torch.where(is_new, aj, min1)
            amin = torch.where(is_new, j, amin)
            nneg = nneg + (msgs[j] < 0).int()
        sign_all = 1.0 - 2.0 * (nneg % 2).float()
        newc = []
        for j in range(e):
            loo = torch.where(amin == j, min2, min1)
            sgn = sign_all * torch.where(msgs[j] < 0, -1.0, 1.0)
            newc.append(sgn * torch.clamp(loo - OFFSET, min=0.0))
        for j in range(dm):
            if j < deg:
                g, s = edges[j]
                ti[g] = ti[g] + torch.roll(newc[j] - c2v[t, j], -s, 0)
                c2v[t, j] = newc[j]
            else:
                c2v[t, j] = 0.0
        tp[t] = msgs[dm] + newc[dm]
        c2v[t, dm] = newc[dm]
        prev_new = msgs[e - 1] + newc[e - 1] - mask0
        if t == 0:
            # aligned slot u maps to par[q-1][u-1]; par[q-1][359] keeps
            # its value
            tp[q - 1] = torch.where(u_last, tp[q - 1],
                                    torch.roll(prev_new, -1, 0))
        else:
            tp[t - 1] = prev_new
        c2v[t, e - 1] = newc[e - 1]


def _unstage_bits(tab: QCTables, ti, tp) -> torch.Tensor:
    b = ti.shape[-1]
    info = ti[:tab.n_groups].reshape(tab.k, b)
    par = tp.permute(1, 0, 2).reshape(tab.n - tab.k, b)
    return (torch.cat([info, par]) < 0).to(torch.uint8)


def decode_plain(tab: QCTables, order: list, v: torch.Tensor, min_it,
                 max_iters: int, check_every: int, min_iters: int):
    """K1's and K2's semantics in plain PyTorch: sweeps in chunks of
    check_every; the whole batch's syndrome is counted once the sweep count
    reaches max(min_it, min_iters); stop when it is 0; the count is
    max_iters if it never is.  -> (bits (N, B) uint8, iters () int32)."""
    ti, tp = _stage_nb(tab, v)
    c2v = torch.zeros((tab.q, tab.degmax + 2) + tp.shape[1:],
                      device=v.device)
    floor_it = max(int(min_it), min_iters)
    iters = max_iters
    for ci in range((max_iters + check_every - 1) // check_every):
        for _ in range(check_every):
            layered_sweep(tab, order, ti, tp, c2v)
        it_now = (ci + 1) * check_every
        if it_now >= floor_it and int(
                _syndrome_weight(tab, ti, tp).sum()) == 0:
            iters = it_now
            break
    return (_unstage_bits(tab, ti, tp),
            torch.tensor(iters, dtype=torch.int32, device=v.device))


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
            fn.argtypes = [p] * 8 + [i] * 10 + [f, p]
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
# shared memory one CTA may use on the H100, less what the kernel keeps for
# its static variables
SMEM_BYTES = 232448 - 128
# edges (degmax + 2) whose sign bits fit a stored row beside its index
MAX_EDGES = 24
# edges whose 2-bit phase sits in word 3; the later ones go to word 1
PHASE_LO_EDGES = 16
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


def _prepare(name: str, tab: QCTables, tables: torch.Tensor,
             v: torch.Tensor, in_dtype, c2v_dtype, votes: int = 0):
    """Check the inputs of one launch and allocate its outputs and
    scratch (`votes`: exit votes of an adaptive decode, each with a
    counter pair in ctl).  -> (lib, x (N, B) contiguous, udeg, bits, ti, tp,
    c2v, ctl)."""
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
    ctl = torch.empty(4 + 2 * votes, dtype=torch.int32, device=dev)
    return lib, v.contiguous(), udeg, bits, ti, tp, c2v, ctl


def _raise_on(lib, name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: "
                           + lib.ldpc_layered_error_string(err).decode())


def _adaptive_launch(name, in_dtype, tab, tables, v, min_it, max_iters,
                     check_every, min_iters):
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
             max_iters, check_every, min_iters, udeg, OFFSET,
             torch.cuda.current_stream(v.device).cuda_stream)
    _raise_on(lib, name, err)
    return bits, ctl[1]


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
                      min_iters: int):
    """K1: (N, B) bf16 LLRs on the card -> (bits (N, B) uint8, iters ()
    int32 on the card); nothing is read back to the host."""
    out = _adaptive_launch("ldpc_layered_cuda", torch.bfloat16, tab, tables,
                           v, min_it, max_iters, check_every, min_iters)
    ldpc_layered_cuda.launches += 1
    return out


def ldpc_layered_adaptive_cuda(tab: QCTables, tables: torch.Tensor,
                               v: torch.Tensor, min_it: torch.Tensor,
                               max_iters: int, check_every: int,
                               min_iters: int):
    """K2: as K1 from (N, B) f32 LLRs, which are never rounded."""
    out = _adaptive_launch("ldpc_layered_adaptive_cuda", torch.float32, tab,
                           tables, v, min_it, max_iters, check_every,
                           min_iters)
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
        """The CUDA kernel (CUDA tensors only)."""
        v = self._input(llrs_t)
        launch = (ldpc_layered_cuda if self.in_dtype == torch.bfloat16
                  else ldpc_layered_adaptive_cuda)
        return launch(self.tab, self._tables.on(v.device), v,
                      _min_it_on(min_it, v.device), self.max_iters,
                      self.check_every, self.min_iters)

    def plain(self, llrs_t: torch.Tensor, min_it=0):
        """The plain PyTorch version on any device (the kernel's
        reference on the card)."""
        return decode_plain(self.tab, self.order, self._input(llrs_t),
                            min_it, self.max_iters, self.check_every,
                            self.min_iters)


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
