"""One PLP's max-log LLR tail (sdr_receiver_dvb_t2_tpu_torch/ops/
llr_tail.py): the plain version and the hand-written kernel K7
(csrc/llr_tail.cu).

On the CPU:
- the kernel's (plane, cell) -> output row table inverts the bit
  deinterleave's row gather exactly;
- the plain version, moved out of `rx/fusedpath.py`, gives the tail's
  earlier output bit for bit (`_TailBefore` below is that code as it was);
- an emulation of the kernel's arithmetic and indexing, written beside
  `csrc/llr_tail.cu` (the Q-delay partner ((c + 1) % cpf, b), the rotation
  rounded where the kernel rounds, the tree of minima, the row table, the
  frame-major output), equals the plain version bit for bit, on inputs that
  hold +-inf, NaN, +-0 and values on the decision boundaries;
- `MultiFramePath.syms` returns (N, B, F) LLRs whose `[:, :, f]` is frame
  f's.
The `cuda`-marked tests hold K7 to the plain version on the card, NaN equal
to NaN, and check that the superstep's frame-major LLRs are K7's storage.
"""
import numpy as np
import pytest
import torch

from sdr_receiver_dvb_t2_tpu_torch._device import DeviceConst
from sdr_receiver_dvb_t2_tpu_torch.dvbt2 import tables
from sdr_receiver_dvb_t2_tpu_torch.dvbt2.params import (
    CodeRate, Constellation, FECFrame, FFTMode, GuardInterval, PilotPattern,
    PLPParams, T2Params)
from sdr_receiver_dvb_t2_tpu_torch.ops import llr_tail
from sdr_receiver_dvb_t2_tpu_torch.rx import fusedpath
from sdr_receiver_dvb_t2_tpu_torch.tools.timing import differing
from sdr_receiver_dvb_t2_tpu_torch.utils import benchgen

torch.set_num_threads(1)

NB = 3
CONSTELLATIONS = (Constellation.QPSK, Constellation.QAM16,
                  Constellation.QAM64, Constellation.QAM256)
DTYPES = (torch.bfloat16, torch.float32)


def _mode(const, rotated=True, nb=NB):
    p = T2Params(fft_mode=FFTMode.FFT_8K, guard=GuardInterval.GI_1_32,
                 pilot_pattern=PilotPattern.PP1, extended_carrier=False,
                 n_data=9)
    plp = PLPParams(constellation=const, rate=CodeRate.C1_2,
                    fec_frame=FECFrame.SHORT, num_blocks_max=nb,
                    time_il_length=1, rotated=rotated)
    return p, plp


def _path(const, rotated=True, nb=NB):
    p, plp = _mode(const, rotated, nb)
    return p, fusedpath.get_fused_plp_path(p, plp, nb)


def _cells(p, f, dtype, seed, levels=(), specials=True, device="cpu"):
    """(total, 2F) paired cells: unit-power noise, and where `specials`,
    +-inf, NaN, +-0, the constellation's levels and the midpoints between
    them (the decision boundaries) at random places."""
    total = fusedpath.get_fused_demod(p).total_cells
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((total, 2 * f), generator=gen) * 0.8
    if specials:
        lv = torch.tensor(sorted(levels), dtype=torch.float32)
        mids = (lv[1:] + lv[:-1]) / 2
        vals = torch.cat([torch.tensor([float("inf"), -float("inf"),
                                        float("nan"), 0.0, -0.0]), lv, mids,
                          -mids])
        idx = torch.randint(0, x.numel(), (max(64, x.numel() // 50),),
                            generator=gen)
        pick = torch.randint(0, len(vals), idx.shape, generator=gen)
        x.view(-1)[idx] = vals[pick]
    return x.to(dtype).to(device)


class _TailBefore:
    """The LLR tail as `rx/fusedpath._Tail` computed it before it moved to
    `ops/llr_tail.py` (its table builds and its call, unchanged)."""

    def __init__(self, path, n_frames, llr_dtype):
        plp = path.plp
        self.plp, self.f, self.llr_dtype = plp, n_frames, llr_dtype
        self.nb, self.cpf = path.num_blocks, plp.cells_per_fec_block
        m = plp.bits_per_cell
        half = m // 2
        self._comp_cm = DeviceConst(
            path.comp.reshape(self.nb, self.cpf).T.reshape(-1).astype(
                np.int64))
        bi = path.bit_inv.astype(np.int64)
        cell_ix, bitpos = bi // m, bi % m
        plane = (bitpos % 2) * half + bitpos // 2
        self._bit_inv_pm = DeviceConst(plane * self.cpf + cell_ix)
        self._levels = [float(v) for v in (tables._gray_levels(m)
                        * tables.NORM_FACTOR[plp.constellation])]
        words = np.arange(len(self._levels))
        self._axis_masks = np.stack(
            [(words >> (half - 1 - b)) & 1 for b in range(half)]
        ).astype(bool)
        self._rot = (float(np.real(path.rot)), float(np.imag(path.rot)))

    def _axis_llrs(self, xax, inv_t):
        half = self._axis_masks.shape[0]
        acc0 = [None] * half
        acc1 = [None] * half
        for lvl_i, lvl in enumerate(self._levels):
            d = ((xax - lvl) ** 2).to(self.llr_dtype)
            for b in range(half):
                acc = acc1 if self._axis_masks[b][lvl_i] else acc0
                acc[b] = d if acc[b] is None else torch.minimum(acc[b], d)
        llrs = torch.stack([(acc1[b] - acc0[b]) * inv_t
                            for b in range(half)])
        return llrs, torch.minimum(acc0[0], acc1[0])

    def __call__(self, both, inv_nvar):
        nb, cpf, f = self.nb, self.cpf, self.f
        dev = both.device
        g = both[self._comp_cm.on(dev)].reshape(cpf, nb, 2, f)
        re, im = g[:, :, 0, :], g[:, :, 1, :]
        if self.plp.rotated:
            rot_re, rot_im = self._rot
            im = torch.roll(im, -1, 0)
            re, im = (re * rot_re - im * rot_im, re * rot_im + im * rot_re)
        inv_t = torch.as_tensor(inv_nvar, dtype=torch.float32,
                                device=dev).to(self.llr_dtype)
        li, mi_ = self._axis_llrs(re, inv_t)
        lq, mq_ = self._axis_llrs(im, inv_t)
        v = torch.cat([li, lq]).reshape(self.plp.bits_per_cell * cpf, nb, f)
        out = v[self._bit_inv_pm.on(dev)]
        evm = (mi_.float().mean((0, 1)) + mq_.float().mean((0, 1)))
        return out, evm


def _emulate_k7(tail, both, inv_nvar, level_dtype=torch.float32):
    """K7's arithmetic and indexing in PyTorch on the CPU: cell (c, b) at
    i = c*nb + b, its im from the row of cell ((c + 1) % cpf, b) = i + nb
    (mod cpf*nb) on a rotated PLP, every step computed in f32 and rounded
    to the LLR dtype where the kernel rounds, the per-bit minima by the kernel's
    tree, each LLR put at out[rows[plane*cpf + c], b, f] of frame-major
    storage.  The levels are f32, as CUDA's eager `x - level` reads a
    Python number; `level_dtype` rounds them further (the CPU's eager
    kernel first casts the number to a bf16 tensor's dtype, its `*` does
    not).  -> ((n_ldpc, nb, F) view, the two axes' least distances
    (n_points, F) each)."""
    dt, f, nb, cpf = tail.llr_dtype, tail.f, tail.nb, tail.cpf
    half = tail.plp.bits_per_cell // 2
    n = nb * cpf

    def rd(x):
        return x.to(dt).float()

    i = torch.arange(n)
    comp = tail._comp_cm.host
    partner = (i + nb) % n if tail.plp.rotated else i
    bf = both.float()
    x, y = bf[comp[i], :f], bf[comp[partner], f:]
    if tail.plp.rotated:
        rr, ri = (torch.tensor(np.float32(v)) for v in tail._rot)
        x, y = (rd(rd(x * rr) - rd(y * ri)), rd(rd(x * ri) + rd(y * rr)))
    inv = rd(torch.as_tensor(inv_nvar, dtype=torch.float32))
    levels = torch.tensor(np.float32(tail._levels)).to(level_dtype).float()

    def axis(v):
        cur = []
        for lv in levels:
            d = rd(v - lv)
            cur.append(rd(d * d))
        llr = [None] * half
        for b in range(half - 1, -1, -1):
            a0, a1 = cur[0], cur[1]
            for j in range(1, len(cur) // 2):
                a0 = torch.minimum(a0, cur[2 * j])
                a1 = torch.minimum(a1, cur[2 * j + 1])
            llr[b] = rd(rd(a1 - a0) * inv)
            if b == 0:
                least = torch.minimum(a0, a1)
            else:
                cur = [torch.minimum(cur[2 * j], cur[2 * j + 1])
                       for j in range(len(cur) // 2)]
        return llr, least

    li, least_i = axis(x)
    lq, least_q = axis(y)
    out = torch.full((f, 2 * half * cpf, nb), float("-1e30"), dtype=dt)
    c, b = i // nb, i % nb
    rows = torch.from_numpy(tail.rows.astype(np.int64))
    for plane, v in enumerate(li + lq):
        out[:, rows[plane * cpf + c], b] = v.T.to(dt)
    return out.permute(1, 2, 0), least_i.to(dt), least_q.to(dt)


def _same(a, b):
    return a.shape == b.shape and differing(a, b) == 0


@pytest.mark.parametrize("const", CONSTELLATIONS)
def test_rows_invert_the_bit_deinterleave(const):
    _, path = _path(const)
    tail = llr_tail.LLRTail(path, 2, torch.bfloat16)
    n_ldpc = path.plp.fec.n_ldpc
    assert tail.rows.dtype == np.int32 and len(tail.rows) == n_ldpc
    np.testing.assert_array_equal(np.sort(tail.rows), np.arange(n_ldpc))
    np.testing.assert_array_equal(tail.rows[tail.bit_inv_pm],
                                  np.arange(n_ldpc))
    np.testing.assert_array_equal(tail.bit_inv_pm[tail.rows],
                                  np.arange(n_ldpc))


@pytest.mark.parametrize("const", CONSTELLATIONS)
@pytest.mark.parametrize("rotated", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_is_the_tail_before(const, rotated, dtype):
    p, path = _path(const, rotated)
    f = 3
    both = _cells(p, f, dtype, seed=len(const.name), levels=path._levels.host
                  .tolist())
    want, want_evm = _TailBefore(path, f, dtype)(both, 40.0)
    tail = llr_tail.LLRTail(path, f, dtype)
    got, got_evm = tail(both, 40.0)
    assert got.dtype == dtype and got.is_contiguous()
    assert _same(got, want) and _same(got_evm, want_evm)
    got2, none = tail(both, 40.0, evm=False)
    assert none is None and _same(got2, want)


@pytest.mark.parametrize("const", CONSTELLATIONS)
@pytest.mark.parametrize("rotated", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_emulated_kernel_equals_plain(const, rotated, dtype):
    p, path = _path(const, rotated)
    f = 4
    tail = llr_tail.LLRTail(path, f, dtype)
    both = _cells(p, f, dtype, seed=7 + len(const.name),
                  levels=path._levels.host.tolist())
    assert int(both.isnan().sum()) > 0 and int(both.isinf().sum()) > 0
    want, want_evm = tail.plain(both, 25.0)
    # the plain version's levels as the CPU's eager `x - level` takes them
    got, least_i, least_q = _emulate_k7(tail, both, 25.0, level_dtype=dtype)
    assert got.stride() == (tail.nb, 1, got.shape[0] * tail.nb)
    assert _same(got, want)
    evm = (least_i.reshape(tail.cpf, tail.nb, f).float().mean((0, 1))
           + least_q.reshape(tail.cpf, tail.nb, f).float().mean((0, 1)))
    assert _same(evm, want_evm)


def test_kernel_refuses_cpu_tensors_and_the_cpu_takes_plain():
    p, path = _path(Constellation.QAM16)
    tail = llr_tail.LLRTail(path, 2, torch.bfloat16)
    both = _cells(p, 2, torch.bfloat16, seed=3, specials=False)
    with pytest.raises(ValueError):
        tail.kernel(both, 10.0)
    before = llr_tail.llr_tail_cuda.launches
    out, _ = tail(both, 10.0)
    assert llr_tail.llr_tail_cuda.launches == before
    assert _same(out, tail.plain(both, 10.0)[0])


def test_syms_returns_n_b_f_read_per_frame():
    """(N, B, F) LLRs; `[:, :, f]` (what the benchmark's capture reads) is
    frame f's, the LLRs of that frame's symbols alone."""
    p, plp = _mode(Constellation.QAM16)
    f = 3
    gen = torch.Generator().manual_seed(4)
    shape = (f, p.len_frame, p.fft_size)
    sr, si = torch.randn(shape, generator=gen), torch.randn(shape,
                                                            generator=gen)
    out = fusedpath.MultiFramePath(p, plp, NB, f).syms(sr, si, 30.0)
    assert out.shape == (plp.fec.n_ldpc, NB, f)
    one = fusedpath.MultiFramePath(p, plp, NB, 1)
    for fi in range(f):
        ref = one.syms(sr[fi:fi + 1], si[fi:fi + 1], 30.0)[:, :, 0]
        torch.testing.assert_close(out[:, :, fi], ref, rtol=1e-5,
                                   atol=1e-4)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K7 has no CPU mode)")


def _check_on_card(path, f, dtype, seed, inv=37.5, specials=True, p=None):
    tail = llr_tail.LLRTail(path, f, dtype)
    both = _cells(p, f, dtype, seed, levels=tail._levels,
                  specials=specials, device="cuda")
    for evm in (True, False):
        before = llr_tail.llr_tail_cuda.launches
        got, got_evm = tail(both, inv, evm=evm)
        assert llr_tail.llr_tail_cuda.launches == before + 1
        want, want_evm = tail.plain(both, inv)
        torch.cuda.synchronize()
        assert got.shape == want.shape and got.dtype == dtype
        # frame-major storage seen as (n_ldpc, nb, F)
        assert got.permute(2, 0, 1).is_contiguous()
        assert differing(got, want) == 0
        if evm:
            assert differing(got_evm, want_evm) == 0
        else:
            assert got_evm is None


@pytest.mark.cuda
@pytest.mark.parametrize("specials", [False, True])
def test_k7_equals_plain_at_the_uk_hd_shape(specials):
    """The cells' mode (32K PP7, 256QAM rotated C2/3 NORMAL, 202 blocks),
    F=4, bf16."""
    _card()
    p, plp = benchgen.headline_mode(202)
    path = fusedpath.get_fused_plp_path(p, plp, 202)
    _check_on_card(path, 4, torch.bfloat16, seed=11, specials=specials, p=p)


@pytest.mark.cuda
@pytest.mark.parametrize("const", CONSTELLATIONS)
@pytest.mark.parametrize("rotated", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_k7_equals_plain(const, rotated, dtype):
    """Every constellation, rotated and not, bf16 and f32, with +-inf,
    NaN, +-0 and decision boundaries in the cells; several frame counts
    (a partial octet, 16-byte rows, two CTA frame chunks)."""
    _card()
    p, path = _path(const, rotated)
    for f in (3, 8, 72):
        _check_on_card(path, f, dtype, seed=f + len(const.name), p=p)


@pytest.mark.cuda
def test_superstep_llrs_are_k7_storage():
    """On the card the superstep's frame-major LLRs are K7's own storage
    (`.permute(2, 0, 1).contiguous()` copies nothing), and K7 runs once per
    PLP and step, its frames counted."""
    _card()
    from sdr_receiver_dvb_t2_tpu_torch.rx import superstep as tss
    from sdr_receiver_dvb_t2_tpu_torch.utils.metrics import TRACER
    p, plp = _mode(Constellation.QAM16)
    f = 2
    step = tss.Superstep(p, plp, NB, f, benchgen.FS,
                         tss.hash_weights(plp.fec.k_bch // 8, NB))
    gen = torch.Generator().manual_seed(6)
    shape = (f, p.len_frame, p.fft_size)
    sr = torch.randn(shape, generator=gen).to("cuda", torch.bfloat16)
    si = torch.randn(shape, generator=gen).to("cuda", torch.bfloat16)
    inv = torch.tensor(30.0, device="cuda")
    before = llr_tail.llr_tail_cuda.launches
    TRACER.clear()
    TRACER.enable()
    try:
        out = step.mf.syms(sr, si, inv)
    finally:
        TRACER.disable()
    assert llr_tail.llr_tail_cuda.launches == before + 1
    assert TRACER.counters()["demod.llr_kernel_frames"] == f
    TRACER.clear()
    assert out.shape == (plp.fec.n_ldpc, NB, f)
    assert out.permute(2, 0, 1).contiguous().data_ptr() == out.data_ptr()
