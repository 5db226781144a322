"""The port's fused receive path (sdr_receiver_dvb_t2_tpu_torch/rx/
fusedpath.py) against the JAX package's `MultiFramePath._fn_syms` at the
8K/16QAM SHORT setup of tests/test_fusedpath.py.

Tables must be equal.  At f32 the JAX FFT is a matmul Cooley-Tukey and the
port's is a radix FFT, so LLRs agree to f32 rounding of the spectrum
(relative 1e-4 of the LLR scale, measured ~1e-6) with equal signs.  At
bf16 the two FFTs round differently, so the check is on decoded bits."""
import jax.numpy as jnp
import numpy as np
import torch

from sdr_receiver_dvb_t2_tpu.dvbt2.params import (
    CodeRate, Constellation, FECFrame, FFTMode, GuardInterval, PilotPattern,
    PLPParams, T2Params)
from sdr_receiver_dvb_t2_tpu.rx import fusedpath as jfp
from sdr_receiver_dvb_t2_tpu.rx import jaxdemod
from sdr_receiver_dvb_t2_tpu.tx.modulator import T2Modulator
from sdr_receiver_dvb_t2_tpu_torch.ops.ldpc_layered import \
    make_adaptive_decoder_nb_fused_io
from sdr_receiver_dvb_t2_tpu_torch.rx import fusedpath as tfp
from sdr_receiver_dvb_t2_tpu_torch.utils.reference import from_reference as R

torch.set_num_threads(1)

F = 2
NB = 3
SNR_DB = 12.0
INV_NVAR = 10 ** (SNR_DB / 10)


def _setup():
    p = T2Params(fft_mode=FFTMode.FFT_8K, guard=GuardInterval.GI_1_32,
                 pilot_pattern=PilotPattern.PP1, extended_carrier=False,
                 n_data=9)
    plp = PLPParams(constellation=Constellation.QAM16, rate=CodeRate.C1_2,
                    fec_frame=FECFrame.SHORT, num_blocks_max=NB,
                    time_il_length=1)
    return p, plp


def _symbols(p, plp, sym_order):
    """(F, len_frame, fft) f32 planes of F modulated frames at SNR_DB,
    GI-stripped, in class order."""
    rng = np.random.default_rng(11)
    mod = T2Modulator(p, [plp])
    ts = rng.integers(0, 256, (mod.packets_needed(F) + 4, 188)
                      ).astype(np.uint8)
    ts[:, 0] = 0x47
    frames = np.stack(mod.modulate(ts.reshape(-1), F).frames)
    sigma = np.sqrt(np.mean(np.abs(frames) ** 2) / INV_NVAR / 2)
    frames = frames + sigma * (rng.normal(size=frames.shape)
                               + 1j * rng.normal(size=frames.shape))
    body = frames[:, 2048:].reshape(F, p.len_frame, p.symbol_size)
    sym = body[:, sym_order, p.guard_size:]
    return (np.ascontiguousarray(sym.real, np.float32),
            np.ascontiguousarray(sym.imag, np.float32))


def test_interp_stencil_equals_jax():
    pos = np.array([0, 3, 7, 12, 30, 31])
    for a, b in zip(tfp._interp_stencil(pos, 40),
                    jaxdemod._interp_stencil(pos, 40)):
        np.testing.assert_array_equal(a, b)


def test_class_tables_equal_jax():
    p, plp = _setup()
    ref, mine = jfp.FusedFrameDemod(p), tfp.FusedFrameDemod(R(p))
    np.testing.assert_array_equal(mine.layout, ref.layout)
    np.testing.assert_array_equal(mine.sym_order, ref.sym_order)
    assert mine.total_cells == ref.total_cells
    assert len(mine.classes) == len(ref.classes)
    for a, b in zip(mine.classes, ref.classes):
        for f in ("sym_cols", "pilot_rows", "inv_ref", "comp_rows",
                  "pilot_rows_wrapped", "comp_rows_wrapped"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        for x, y in zip(a.stencil + a.comp_stencil,
                        b.stencil + b.comp_stencil):
            np.testing.assert_array_equal(x, y)
    rp = jfp.FusedPLPPath(p, plp, NB, ref)
    mp = tfp.FusedPLPPath(R(p), R(plp), NB, mine)
    np.testing.assert_array_equal(mp.comp, rp.comp)
    np.testing.assert_array_equal(mp.bit_inv, rp.bit_inv)
    assert mp.rot == rp.rot


def test_llrs_f32_equal_jax():
    p, plp = _setup()
    ref = jfp.MultiFramePath(p, plp, NB, F, emit_evm=True)
    mine = tfp.MultiFramePath(R(p), R(plp), NB, F, emit_evm=True)
    sr, si = _symbols(p, plp, mine.demod.sym_order)
    llr_j, evm_j = ref._fn_syms(jnp.asarray(sr), jnp.asarray(si),
                                jnp.float32(INV_NVAR))
    llr_t, evm_t = mine.syms(torch.from_numpy(sr), torch.from_numpy(si),
                             INV_NVAR)
    llr_j = np.asarray(llr_j)
    assert llr_t.shape == llr_j.shape == (plp.fec.n_ldpc, NB, F)
    assert llr_t.dtype == torch.float32
    atol = 1e-4 * np.abs(llr_j).max()
    np.testing.assert_allclose(llr_t.numpy(), llr_j, atol=atol)
    sure = np.abs(llr_j) > atol
    np.testing.assert_array_equal(np.sign(llr_t.numpy())[sure],
                                  np.sign(llr_j)[sure])
    # EVM: mean min squared distance, unit-power constellation
    np.testing.assert_allclose(evm_t.numpy(), np.asarray(evm_j), atol=1e-6)


def test_llrs_bf16_decode_equal_jax():
    p, plp = _setup()
    ref = jfp.MultiFramePath(p, plp, NB, F, llr_dtype=jnp.bfloat16)
    mine = tfp.MultiFramePath(R(p), R(plp), NB, F, llr_dtype=torch.bfloat16)
    sr, si = _symbols(p, plp, mine.demod.sym_order)
    llr_j = ref._fn_syms(jnp.asarray(sr, jnp.bfloat16),
                         jnp.asarray(si, jnp.bfloat16),
                         jnp.float32(INV_NVAR))
    llr_t = mine.syms(torch.from_numpy(sr).bfloat16(),
                      torch.from_numpy(si).bfloat16(), INV_NVAR)
    assert llr_t.dtype == torch.bfloat16
    llr_j = torch.from_numpy(np.array(llr_j.astype(jnp.float32)))
    # hard decisions differ only where bf16 rounding moves an LLR near 0
    # across it (~0.2% at 12 dB); the decoder removes the difference
    agree = (torch.sign(llr_t.float()) == torch.sign(llr_j)).float().mean()
    assert agree > 0.99
    dec = make_adaptive_decoder_nb_fused_io(R(plp.fec_frame), R(plp.rate),
                                            max_iters=12, check_every=1,
                                            layer_order="reversed")
    for f in range(F):
        bits_t, it_t = dec(llr_t[:, :, f])
        bits_j, it_j = dec(llr_j[:, :, f])
        assert torch.equal(bits_t, bits_j) and int(it_t) < 12
