"""Decode chain: frame cell stream -> TS bytes.

Reverse-BICM per PLP (reference: time_deinterleaver.cpp / llr_demapper.cpp /
ldpc_decoder.cpp / bch_decoder.cpp / bb_de_header.cpp), all interleaver
inverses expressed as precomputed gathers over the whole frame batch:

  slice by L1-dynamic (start, num_blocks) -> time+cell deinterleave +
  cyclic-Q-delay removal -> derotate -> soft LLR demap (exact max-log over
  the constellation) -> bit deinterleave (inverse twist+demux) + parity
  deinterleave -> LDPC (numpy or JAX batched min-sum) -> BCH correct
  (a real decoder; the reference stubs this, bch_decoder.cpp:136) ->
  BB descramble -> TS reassembly (bbframe.TSAssembler).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np

from ..dvbt2 import bbframe, bch, interleavers, l1 as l1mod, ldpc, tables
from ..dvbt2.params import (Bandwidth, CodeRate, Constellation, FECFrame,
                            FFTMode, GuardInterval, PAPR, PilotPattern,
                            PLPParams, Preamble, T2Params)


def params_from_l1(p1_fft: FFTMode, pre: l1mod.L1Pre,
                   post: l1mod.L1Post,
                   bandwidth=None) -> tuple[T2Params, list[PLPParams]]:
    """Rebuild the transmission parameters a receiver needs from L1
    (the reference flow: p1 -> fft mode, l1-pre -> GI/PP/PAPR/bwt_ext,
    l1-post -> per-PLP mod/cod/fec/TI).  Bandwidth is never signalled
    on-air; callers pass the receiver's declared one."""
    p = T2Params(
        bandwidth=bandwidth or Bandwidth.BW_8,
        fft_mode=p1_fft,
        guard=GuardInterval(pre.guard_interval),
        pilot_pattern=PilotPattern(pre.pilot_pattern),
        extended_carrier=bool(pre.bwt_ext),
        papr=PAPR(pre.papr) if pre.papr in (0, 1, 2, 3) else PAPR.OFF,
        miso=pre.s1 in (1, 4),
        preamble=(Preamble(pre.s1) if 0 <= pre.s1 <= 4
                  else Preamble.T2_SISO),
        n_data=pre.num_data_symbols,
        fef=(tuple(post.fef) if (pre.s2_field2 and post.fef) else None),
    )
    plps = []
    for cfg in post.plp:
        plps.append(PLPParams(
            plp_id=cfg.id,
            constellation=Constellation(cfg.plp_mod),
            rate=CodeRate(cfg.plp_cod),
            fec_frame=FECFrame(cfg.plp_fec_type),
            rotated=bool(cfg.plp_rotation),
            num_blocks_max=cfg.plp_num_blocks_max,
            time_il_length=cfg.time_il_length,
            time_il_type=cfg.time_il_type,
            frame_interval=cfg.frame_interval,
            first_frame_idx=cfg.first_frame_idx,
            plp_type=cfg.plp_type,
            sub_slices=(post.sub_slices_per_frame
                        if cfg.plp_type == 2 else 1),
            in_band_a=bool(cfg.in_band_a_flag)))
    return p, plps


# --------------------------------------------------------------------------
# Time + cell deinterleave
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ti_inverse_perm(cells_per_fec: int, nb: int) -> np.ndarray:
    """Gather map undoing cell+time interleaving of one TI block:
    plain[i] = received[perm[i]]."""
    ci = interleavers.cell_interleaver_perm(cells_per_fec, nb)  # (nb, cpf)
    order = interleavers.time_interleaver_perm(cells_per_fec, nb)
    inv_order = np.empty_like(order)
    inv_order[order] = np.arange(len(order), dtype=np.int32)
    # plain (block r, cell w) sits at interleaved stream pos
    # inv_order[r*cpf + ci[r, w]]
    base = (np.arange(nb)[:, None] * cells_per_fec + ci).reshape(-1)
    return inv_order[base]


def deinterleave_plp_frame(plp: PLPParams, slice_cells: np.ndarray,
                           num_blocks: int) -> np.ndarray:
    """Undo the TX frame interleaving: returns (num_blocks, cells_per_fec)
    cells with the cyclic Q-delay removed."""
    cpf = plp.cells_per_fec_block
    n_ti = max(1, plp.time_il_length if plp.time_il_type == 0 else 1)
    from ..tx.frame import ti_blocks_split
    out = []
    pos = 0
    for nb in ti_blocks_split(num_blocks, n_ti):
        if nb == 0:
            continue
        blk = slice_cells[pos:pos + nb * cpf]
        pos += nb * cpf
        plain = blk[_ti_inverse_perm(cpf, nb)].reshape(nb, cpf)
        out.append(plain)
    assert pos == len(slice_cells)
    cells = np.concatenate(out, axis=0)
    if plp.rotated:
        # undo cyclic Q-delay: Q of cell i came from cell (i+1) mod cpf
        q = np.roll(cells.imag, -1, axis=-1)
        cells = (cells.real + 1j * q).astype(np.complex64)
    return cells


# --------------------------------------------------------------------------
# Soft demapping
# --------------------------------------------------------------------------

def estimate_noise_var(plp: PLPParams, cells: np.ndarray) -> float:
    """Blind noise-variance estimate from the hard-decision error vector
    (the reference's approach, llr_demapper.cpp:184-196): mean squared
    distance to the nearest constellation point.

    Requires properly PAIRED I/Q (post time/cell deinterleave for rotated
    constellations — the cyclic Q-delay must be removed first).  The device
    path, whose probe cells are pre-deinterleave, estimates from the L1
    cells instead (`estimate_noise_var_l1`: unrotated, no Q-delay)."""
    pts = tables.constellation_points(plp.constellation)
    if plp.rotated:
        phi = tables.ROTATION_ANGLE[plp.constellation]
        cells = cells * np.exp(-1j * phi).astype(np.complex64)
    flat = cells.reshape(-1)
    if len(flat) > 4096:  # subsample: variance estimate doesn't need all
        flat = flat[:: len(flat) // 4096]
    d2 = np.abs(flat[:, None] - pts[None, :]) ** 2
    return float(np.mean(d2.min(axis=1)))


def estimate_noise_var_l1(cells: np.ndarray, l1pre=None,
                          l1pre_bpsk: bool = False) -> float:
    """Blind EVM noise estimate over L1 cells (unrotated constellations,
    no cyclic Q-delay) — the noise reference the device path uses, since
    its PLP probe cells are pre-deinterleave.  `l1pre_bpsk=True` measures
    L1-pre cells (always BPSK); otherwise `cells` are L1-post cells with
    the modulation from `l1pre.l1_post_mod`."""
    from ..dvbt2 import l1 as l1mod
    eta = 1 if l1pre_bpsk else l1mod.L1_MOD_BITS[l1pre.l1_post_mod]
    if eta == 1:  # BPSK
        pts = np.array([1.0 + 0j, -1.0 + 0j], np.complex64)
    else:
        pts = tables.constellation_points(l1mod.L1_MOD_CONSTELLATION[eta])
    flat = np.asarray(cells).reshape(-1)
    if len(flat) > 4096:
        flat = flat[:: len(flat) // 4096]
    d2 = np.abs(flat[:, None] - pts[None, :]) ** 2
    return float(max(np.mean(d2.min(axis=1)), 1e-9))


def llr_demap(plp: PLPParams, cells: np.ndarray,
              noise_var: float) -> np.ndarray:
    """Exact max-log LLRs per bit, (n, cells_per_fec * m) float32.

    Positive LLR = bit 0 (the convention of the int8 chain and the
    reference demapper).  Rotated constellations are derotated first
    (the reference's approach, llr_demapper.cpp:34-41)."""
    m = plp.bits_per_cell
    pts = tables.constellation_points(plp.constellation)
    if plp.rotated:
        phi = tables.ROTATION_ANGLE[plp.constellation]
        cells = cells * np.exp(-1j * phi).astype(np.complex64)
    flat = cells.reshape(-1)
    d2 = np.abs(flat[:, None] - pts[None, :]) ** 2  # (n_cells, n_points)
    words = np.arange(len(pts))
    llrs = np.empty((len(flat), m), dtype=np.float32)
    for b in range(m):
        bit = (words >> (m - 1 - b)) & 1
        d0 = d2[:, bit == 0].min(axis=1)
        d1 = d2[:, bit == 1].min(axis=1)
        llrs[:, b] = (d1 - d0) / max(noise_var, 1e-9)
    return llrs.reshape(cells.shape[0], -1)


def bits_from_llrs(plp: PLPParams, llrs: np.ndarray) -> np.ndarray:
    """v-stream LLRs -> parity-deinterleaved codeword LLRs, i.e. undo the
    bit interleaver (twist+demux) and the parity interleaver.

    llrs: (n, n_ldpc) in v-stream order.  Returns (n, n_ldpc) in natural
    codeword order (info..parity) for the LDPC decoder."""
    fec = plp.fec
    addr = interleavers.bit_interleaver_perm(plp.constellation,
                                            plp.fec_frame, plp.rate)
    u = np.empty_like(llrs)
    u[:, addr] = llrs  # scatter: u[addr[w]] = v[w]
    pperm = interleavers.parity_interleaver_perm(fec.n_ldpc, fec.k_ldpc,
                                                fec.q_ldpc)
    cw = np.empty_like(u)
    cw[:, pperm] = u
    return cw


# --------------------------------------------------------------------------
# FEC decode + BB layer
# --------------------------------------------------------------------------

@dataclass
class PLPDecodeStats:
    ldpc_iters: list = field(default_factory=list)
    ldpc_failures: int = 0
    bch_corrected: int = 0
    bch_failures: int = 0
    inband: list = field(default_factory=list)   # parsed inband.InBandA
    inband_mismatches: int = 0   # signalled next-frame dyn vs decoded L1


def decode_fec_frames(plp: PLPParams, cw_llrs: np.ndarray,
                      stats: PLPDecodeStats | None = None,
                      max_iters: int = 25,
                      ldpc_decode_fn=None) -> np.ndarray:
    """Codeword LLRs -> (n, kbch) descrambled BB-frame bits.

    ldpc_decode_fn: optional batched decoder (llrs (n, N) -> hard (n, N));
    defaults to the NumPy flooding min-sum per frame."""
    fec = plp.fec
    code = ldpc.get_code(plp.fec_frame, plp.rate)
    stats = stats if stats is not None else PLPDecodeStats()
    if ldpc_decode_fn is not None:
        hard = np.asarray(ldpc_decode_fn(cw_llrs))
    else:
        outs = []
        for row in cw_llrs:
            h, conv = ldpc.decode_minsum_np(code, row, iters=max_iters)
            if not conv:
                stats.ldpc_failures += 1
            outs.append(h)
        hard = np.stack(outs)
    # batched BCH parity gate (one GEMM over the whole batch); full
    # BM/Chien decode only on flagged codewords (VERDICT r1 item 8)
    from ..ops import fec_device
    bb = fec_device.bch_correct_batch(plp, hard[:, :fec.n_bch], stats)
    return bbframe.scramble(bb)


def plp_slice_to_ts(plp: PLPParams, slice_cells: np.ndarray, num_blocks: int,
                    assembler: bbframe.TSAssembler,
                    stats: PLPDecodeStats | None = None,
                    ldpc_decode_fn=None, bb_sink=None):
    """Full per-frame decode of one PLP slice into a TS assembler.
    Returns the frame's parsed in-band type-A payload (clause 5.2.3) when
    the PLP carries one, else None.  `bb_sink(bb)`, when given, observes
    the frame's decoded (descrambled, mode-adapted) BB-frame bit stack —
    the tap the T2-MI regenerator uses (tx/t2mi.py)."""
    cells = deinterleave_plp_frame(plp, slice_cells, num_blocks)
    nvar = max(estimate_noise_var(plp, cells), 10.0 ** (-40 / 10.0))
    llrs = llr_demap(plp, cells, nvar)
    cw = bits_from_llrs(plp, llrs)
    bb = decode_fec_frames(plp, cw, stats=stats, ldpc_decode_fn=ldpc_decode_fn)
    if bb_sink is not None:
        bb_sink(bb)
    for frame_bits in bb:
        assembler.push(frame_bits)
    ib = None
    if plp.in_band_a and len(bb):
        from ..dvbt2 import inband
        ib = inband.extract_from_bb_bytes(np.packbits(bb[0]))
        if ib is not None and stats is not None:
            stats.inband.append(ib)
    return ib
