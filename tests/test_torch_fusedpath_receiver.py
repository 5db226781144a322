"""The port's per-frame and batched receive paths (sdr_receiver_dvb_t2_tpu_
torch/rx/fusedpath.py) against the JAX package on 8K modes: the frame entry
of `FusedFrameDemod`, `FusedPLPPath`, `MultiFramePath`'s bodies entry with
the L1 cells, the EVM and three PLPs (two of them type-2 sub-sliced), and
MISO on both entries.

Tables must be equal.  Values are f32 on both sides, but the FFTs differ
(XLA's or the JAX matmul FFT against torch.fft), so cells and LLRs agree
to f32 rounding of the spectrum: within 1e-4 of the largest magnitude
(measured ~1e-6), with equal LLR signs wherever |LLR| exceeds that."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdr_receiver_dvb_t2_tpu.dvbt2 import l1 as l1mod
from sdr_receiver_dvb_t2_tpu.dvbt2.params import (
    CodeRate, Constellation, FECFrame, FFTMode, GuardInterval, PilotPattern,
    PLPParams, Preamble, T2Params)
from sdr_receiver_dvb_t2_tpu.rx import fusedpath as jfp
from sdr_receiver_dvb_t2_tpu.rx import p1_detect as rxp1
from sdr_receiver_dvb_t2_tpu.tx.modulator import T2Modulator, awgn
from sdr_receiver_dvb_t2_tpu_torch.rx import fusedpath as tfp
from sdr_receiver_dvb_t2_tpu_torch.utils.reference import from_reference as R

from tests.test_e2e import make_ts

torch.set_num_threads(1)

F = 2
RTOL = 1e-4          # of the largest magnitude; see the module docstring
INV_NVAR = 50.0


def _mode(miso=False):
    return T2Params(fft_mode=FFTMode.FFT_8K, guard=GuardInterval.GI_1_32,
                    pilot_pattern=PilotPattern.PP1, extended_carrier=False,
                    n_data=9, miso=miso,
                    **({"preamble": Preamble.T2_MISO} if miso else {}))


def _three_plps():
    """The type-2 sub-sliced mode of tests/test_device_e2e.py."""
    return [PLPParams(plp_id=0, constellation=Constellation.QAM16,
                      rate=CodeRate.C1_2, fec_frame=FECFrame.SHORT,
                      num_blocks_max=1, time_il_length=1),
            PLPParams(plp_id=1, constellation=Constellation.QPSK,
                      rate=CodeRate.C1_2, fec_frame=FECFrame.SHORT,
                      rotated=False, num_blocks_max=1, time_il_length=1,
                      plp_type=2, sub_slices=3),
            PLPParams(plp_id=2, constellation=Constellation.QPSK,
                      rate=CodeRate.C1_2, fec_frame=FECFrame.SHORT,
                      rotated=False, num_blocks_max=2, time_il_length=1,
                      plp_type=2, sub_slices=3)]


def _miso_plp():
    return PLPParams(constellation=Constellation.QAM16, rate=CodeRate.C1_2,
                     fec_frame=FECFrame.SHORT, rotated=True,
                     num_blocks_max=3, time_il_length=1)


def _capture(p, plps, seed):
    """F frames at 18 dB (MISO: the two-channel waveform of
    tests/test_device_e2e.py) -> (samples, modulator output)."""
    mod = T2Modulator(p, plps)
    ts = make_ts(mod.packets_needed(F) + 6, seed=seed)
    out = mod.modulate(ts.reshape(-1), F)
    y = out.samples
    if p.miso:
        def ch(x, taps):
            return np.convolve(x, taps)[:len(x)].astype(np.complex64)
        y = ch(out.samples, [1.0, 0.1j]) + ch(out.samples2,
                                              [0, 0.5, -0.04j])
    return awgn(y, 18, seed=seed), out


def _bodies(p, y):
    """(F, len_frame*symbol_size, 2) f32 frame bodies (P1 stripped)."""
    blen = p.len_frame * p.symbol_size
    out = np.empty((F, blen, 2), np.float32)
    for i in range(F):
        b = y[i * p.frame_samples + rxp1.P1_LEN:][:blen]
        out[i, :, 0], out[i, :, 1] = b.real, b.imag
    return out


def _specs(plps, out):
    """(plp, num_blocks, start_cell, sub_slices, slice_interval) of each
    PLP under frame 0's L1 dynamic, and the L1 size in cells."""
    post = out.l1post_frames[0]
    specs = []
    for plp, dyn in zip(plps, post.dyn.plp):
        ss = plp.sub_slices if plp.plp_type == 2 else 1
        iv = post.dyn.sub_slice_interval if ss > 1 else 0
        specs.append((plp, dyn.num_blocks, dyn.start, ss, iv))
    return specs, l1mod.L1_PRE_CELLS + out.l1pre.l1_post_size


def _port_specs(specs):
    """The specs with the port's own PLPParams."""
    return [R(tuple(spec)) for spec in specs]


def _close(got, ref, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    atol = RTOL * np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol, err_msg=what)
    return atol


def _llrs_close(got, ref, what):
    atol = _close(got, ref, what)
    sure = np.abs(ref) > atol
    np.testing.assert_array_equal(np.sign(got)[sure], np.sign(ref)[sure],
                                  err_msg=what)


@pytest.mark.parametrize("miso", [False, True], ids=["siso", "miso"])
def test_demod_tables_equal_jax(miso):
    p = _mode(miso)
    ref, mine = jfp.FusedFrameDemod(p), tfp.FusedFrameDemod(R(p))
    np.testing.assert_array_equal(mine.layout, ref.layout)
    assert len(mine.classes) == len(ref.classes)
    for a, b in zip(mine.classes, ref.classes):
        assert (a.miso is None) == (b.miso is None)
        if a.miso is None:
            continue
        assert a.miso["self_idx"] == b.miso["self_idx"]
        np.testing.assert_array_equal(a.miso["data_rows"],
                                      b.miso["data_rows"])
        for side in ("sum", "dif"):
            sa, sb = a.miso[side], b.miso[side]
            assert sa["src_idx"] == sb["src_idx"]
            assert sa["nc_src"] == sb["nc_src"]
            np.testing.assert_array_equal(sa["sel"], sb["sel"])
            if sb["lane_map"] is None:
                assert sa["lane_map"] is None
            else:
                np.testing.assert_array_equal(sa["lane_map"], sb["lane_map"])
            for x, y in zip(sa["stencil"], sb["stencil"]):
                np.testing.assert_array_equal(x, y)
    if miso:
        # some class takes a subset's channel from a partner class
        assert any(c.miso[s]["src_idx"] is not None
                   for c in mine.classes for s in ("sum", "dif"))


@pytest.mark.parametrize("miso", [False, True], ids=["siso", "miso"])
def test_frame_entry_equals_jax(miso):
    p = _mode(miso)
    plps = [_miso_plp()] if miso else _three_plps()
    y, _ = _capture(p, plps, seed=8)
    body2 = _bodies(p, y)[1]
    ref = np.asarray(jfp.FusedFrameDemod(p)._fn(jnp.asarray(body2)))
    got = tfp.FusedFrameDemod(R(p))(torch.from_numpy(body2))
    assert got.dtype == torch.float32
    assert got.shape == ref.shape == (
        tfp.get_fused_demod(R(p)).total_cells, 2)
    _close(got.numpy(), ref, "equalized cells")


def test_plp_paths_equal_jax():
    """FusedPLPPath of each of the three PLPs, type-2 sub-slices included,
    on the same class-layout cells."""
    p, plps = _mode(), _three_plps()
    y, out = _capture(p, plps, seed=23)
    flat2 = np.array(jfp.get_fused_demod(p)._fn(
        jnp.asarray(_bodies(p, y)[0])))
    specs, l1_size = _specs(plps, out)
    assert [s[3] for s in specs] == [1, 3, 3]
    for plp, nb, sc, ss, iv in specs:
        ref = jfp.FusedPLPPath(p, plp, nb, jfp.get_fused_demod(p),
                               plp_start_cell=sc, l1_cells=l1_size,
                               sub_slices=ss, slice_interval=iv)
        mine = tfp.FusedPLPPath(R(p), R(plp), nb, tfp.get_fused_demod(R(p)),
                                plp_start_cell=sc, l1_cells=l1_size,
                                sub_slices=ss, slice_interval=iv)
        np.testing.assert_array_equal(mine.comp, ref.comp)
        np.testing.assert_array_equal(mine.bit_inv, ref.bit_inv)
        llr_j = np.asarray(ref._fn(jnp.asarray(flat2),
                                   jnp.float32(INV_NVAR)))
        llr_t = mine(torch.from_numpy(flat2), INV_NVAR)
        assert llr_t.dtype == torch.float32
        assert llr_t.shape == (plp.fec.n_ldpc, nb)
        _llrs_close(llr_t.numpy(), llr_j, f"PLP {plp.plp_id}")


def test_plp_path_rotated_equals_jax():
    """The rotated constellation's cyclic Q-delay (one PLP, 3 blocks)."""
    p, plp = _mode(), _miso_plp()
    assert plp.rotated
    y, _ = _capture(p, [plp], seed=4)
    flat2 = np.array(jfp.get_fused_demod(p)._fn(
        jnp.asarray(_bodies(p, y)[0])))
    ref = jfp.get_fused_plp_path(p, plp, 3)
    mine = tfp.get_fused_plp_path(R(p), R(plp), 3)
    _llrs_close(mine(torch.from_numpy(flat2), INV_NVAR).numpy(),
                np.asarray(ref._fn(jnp.asarray(flat2),
                                   jnp.float32(INV_NVAR))), "rotated")


def test_multiframe_bodies_three_plps_l1_evm_equal_jax():
    p, plps = _mode(), _three_plps()
    y, out = _capture(p, plps, seed=23)
    bodies = _bodies(p, y)
    specs, l1_size = _specs(plps, out)
    kw = dict(n_frames=F, emit_l1=True, emit_evm=True, l1_cells=l1_size,
              plp_specs=specs)
    llr_j, l1_j, evm_j = jfp.MultiFramePath(p, **kw)._fn(
        jnp.asarray(bodies), jnp.float32(INV_NVAR))
    mine = tfp.MultiFramePath(
        R(p), **{**kw, "plp_specs": _port_specs(specs)})
    llr_t, l1_t, evm_t = mine(torch.from_numpy(bodies), INV_NVAR)
    assert isinstance(llr_t, tuple) and len(llr_t) == 3
    for (plp, nb, *_), a, b in zip(specs, llr_t, llr_j):
        assert a.shape == (plp.fec.n_ldpc, nb, F)
        _llrs_close(a.numpy(), np.asarray(b), f"PLP {plp.plp_id}")
    assert l1_t.shape == (l1_size, F, 2)
    _close(l1_t.numpy(), np.asarray(l1_j), "L1 cells")
    assert evm_t.shape == (F,)
    np.testing.assert_allclose(evm_t.numpy(), np.asarray(evm_j),
                               rtol=1e-4)
    # the planes entry is the same computation
    llr_p, _, evm_p = mine.planes(torch.from_numpy(bodies[..., 0]),
                                  torch.from_numpy(bodies[..., 1]), INV_NVAR)
    assert all(torch.equal(a, b) for a, b in zip(llr_p, llr_t))
    assert torch.equal(evm_p, evm_t)


def test_multiframe_miso_equals_jax():
    p, plp = _mode(miso=True), _miso_plp()
    y, _ = _capture(p, [plp], seed=8)
    bodies = _bodies(p, y)
    llr_j, evm_j = jfp.MultiFramePath(p, plp, 3, n_frames=F,
                                      emit_evm=True)._fn(
        jnp.asarray(bodies), jnp.float32(INV_NVAR))
    llr_t, evm_t = tfp.MultiFramePath(R(p), R(plp), 3, n_frames=F,
                                      emit_evm=True)(
        torch.from_numpy(bodies), INV_NVAR)
    _llrs_close(llr_t.numpy(), np.asarray(llr_j), "MISO LLRs")
    np.testing.assert_allclose(evm_t.numpy(), np.asarray(evm_j), rtol=1e-4)


def test_multiframe_bf16_hard_decisions_agree_with_jax():
    """The receiver's batched configuration: bf16 demod and LLRs.  The JAX
    path's bf16 matmul FFT and the port's f32 cuFFT-then-cast round
    differently, so the check is on hard decisions."""
    p, plps = _mode(), _three_plps()
    y, out = _capture(p, plps, seed=23)
    bodies = _bodies(p, y)
    specs, l1_size = _specs(plps, out)
    llr_j, _ = jfp.MultiFramePath(
        p, n_frames=F, llr_dtype=jnp.bfloat16, emit_evm=True,
        l1_cells=l1_size, plp_specs=specs)._fn(jnp.asarray(bodies),
                                                jnp.float32(INV_NVAR))
    llr_t, _ = tfp.MultiFramePath(
        R(p), n_frames=F, llr_dtype=torch.bfloat16, emit_evm=True,
        l1_cells=l1_size, plp_specs=_port_specs(specs))(
            torch.from_numpy(bodies), INV_NVAR)
    for a, b in zip(llr_t, llr_j):
        assert a.dtype == torch.bfloat16
        ref = np.asarray(b.astype(jnp.float32))
        agree = (np.sign(a.float().numpy()) == np.sign(ref)).mean()
        assert agree > 0.99
