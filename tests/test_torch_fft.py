"""The port's FFT stage 1 (K6, sdr_receiver_dvb_t2_tpu_torch/ops/
fft_stage1.py) and its matmul FFT (ops/mxu_fft.py) against the JAX side.

- K6's plain version against the TPU kernel `s1_kernel` of
  tools/fft_microbench.py.  That kernel sits inside the tool's `main()`
  and cannot be imported, so its body is restated here line for line and
  run through `pl.pallas_call(interpret=True)` at n = 1024 (32 x 32).
  Tolerance: `fft_stage1.compare` (one bf16 ulp where the f32 row sums are
  taken in another order, fewer than 1% of elements differing at all).
- `mxu_fft` against the JAX `ops/mxu_fft.py`: tables exact; f32 outputs
  within 1e-4 of the spectrum's RMS (both are f32 products of the same
  tables; JAX runs them at Precision.HIGHEST here); the bf16 pipe within
  the pipe's own error, 2e-2 of the RMS (its input and every intermediate
  round to bf16, 2^-9 relative each, through two 32-term stages), of the
  JAX f32 spectrum and of the true f64 spectrum.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from sdr_receiver_dvb_t2_tpu.ops import mxu_fft as jfft
from sdr_receiver_dvb_t2_tpu_torch.ops import fft_stage1, mxu_fft
from sdr_receiver_dvb_t2_tpu_torch.tools import fft_microbench

torch.set_num_threads(1)

N = 1024
F, S = 2, 3


def _planes(seed, n=N):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(F, S, n)).astype(np.float32),
            rng.normal(size=(F, S, n)).astype(np.float32))


def _rms(x):
    return float(np.sqrt(np.mean(np.abs(x) ** 2)))


def _jax_s1(xr, xi, n):
    """Stage 1 + twiddle through the tool's kernel body in interpret
    mode: (F, S, n) f32 planes -> bf16-valued f32 (b_r, b_i)."""
    n1, n2 = jfft._FACTORS[n]
    w1, _, tw = jfft._tables(n)
    dt = jnp.bfloat16
    w1rT = jnp.asarray(np.ascontiguousarray(w1.real.T), dtype=dt)
    w1iT = jnp.asarray(np.ascontiguousarray(w1.imag.T), dtype=dt)
    twr = jnp.asarray(np.ascontiguousarray(tw.real), dtype=dt)
    twi = jnp.asarray(np.ascontiguousarray(tw.imag), dtype=dt)

    def s1_kernel(yr_ref, yi_ref, w1r_ref, w1i_ref, twr_ref, twi_ref,
                  br_ref, bi_ref):
        yr = yr_ref[0, 0]
        yi = yi_ref[0, 0]
        wr = w1r_ref[...]
        wi = w1i_ref[...]
        ar = (jnp.dot(wr, yr, preferred_element_type=jnp.float32)
              - jnp.dot(wi, yi, preferred_element_type=jnp.float32))
        ai = (jnp.dot(wr, yi, preferred_element_type=jnp.float32)
              + jnp.dot(wi, yr, preferred_element_type=jnp.float32))
        twr_ = twr_ref[...].astype(jnp.float32)
        twi_ = twi_ref[...].astype(jnp.float32)
        br_ref[0, 0] = (ar * twr_ - ai * twi_).astype(br_ref.dtype)
        bi_ref[0, 0] = (ar * twi_ + ai * twr_).astype(bi_ref.dtype)

    f, s = xr.shape[:2]
    yr = jnp.asarray(xr).astype(dt).reshape(f, s, n1, n2)
    yi = jnp.asarray(xi).astype(dt).reshape(f, s, n1, n2)
    yspec = pl.BlockSpec((1, 1, n1, n2), lambda i, j: (i, j, 0, 0))
    wspec = pl.BlockSpec((n1, n1), lambda i, j: (0, 0))
    tspec = pl.BlockSpec((n1, n2), lambda i, j: (0, 0))
    br, bi = pl.pallas_call(
        s1_kernel, grid=(f, s),
        in_specs=[yspec, yspec, wspec, wspec, tspec, tspec],
        out_specs=[yspec, yspec],
        out_shape=(jax.ShapeDtypeStruct((f, s, n1, n2), dt),
                   jax.ShapeDtypeStruct((f, s, n1, n2), dt)),
        interpret=True)(yr, yi, w1rT, w1iT, twr, twi)
    return (np.asarray(br.astype(jnp.float32)),
            np.asarray(bi.astype(jnp.float32)))


def test_k6_plain_equals_pallas_kernel():
    xr, xi = _planes(1)
    ref_r, ref_i = _jax_s1(xr, xi, N)
    stage = fft_stage1.Stage1(N)
    br, bi = stage(torch.from_numpy(xr), torch.from_numpy(xi))
    assert br.dtype == bi.dtype == torch.bfloat16
    assert br.shape == bi.shape == (F, S, 32, 32)
    for got, ref in ((br, ref_r), (bi, ref_i)):
        res = fft_stage1.compare(got, torch.from_numpy(ref.copy()))
        assert res["ok"], res


def test_k6_tables_are_the_jax_tool_s():
    """W1^T and the twiddle in bf16, as the tool casts them."""
    w1, _, tw = jfft._tables(N)
    w1r_t, w1i_t, twr, twi = fft_stage1.Stage1(N).tables("cpu")
    for mine, ref in ((w1r_t, w1.real.T), (w1i_t, w1.imag.T),
                      (twr, tw.real), (twi, tw.imag)):
        want = np.asarray(jnp.asarray(np.ascontiguousarray(ref),
                                      dtype=jnp.bfloat16
                                      ).astype(jnp.float32))
        np.testing.assert_array_equal(mine.float().numpy(), want)


def test_k6_does_not_round_a_before_the_twiddle():
    """`fft_carrier_major_planar` rounds a_r, a_i to bf16 before the
    twiddle; K6 rounds once, after it.  On the same input the two stage-1
    results differ, and K6's is the closer to the f64 value."""
    xr, xi = _planes(2)
    stage = fft_stage1.Stage1(N)
    yr, yi = stage._input(torch.from_numpy(xr), torch.from_numpy(xi))
    w1r_t, w1i_t, twr, twi = stage.tables("cpu")
    br, bi = fft_stage1.stage1_plain(yr, yi, w1r_t, w1i_t, twr, twi)
    wr, wi, tr, ti = (t.float() for t in (w1r_t, w1i_t, twr, twi))
    ar = (wr @ yr.float() - wi @ yi.float()).bfloat16().float()
    ai = (wr @ yi.float() + wi @ yr.float()).bfloat16().float()
    rounded = (ar * tr - ai * ti).bfloat16()
    assert not torch.equal(rounded, br)
    a64 = (wr.double() + 1j * wi.double()) @ (yr.double() + 1j * yi.double())
    b64 = (a64 * (tr.double() + 1j * ti.double())).real
    assert (br.double() - b64).abs().mean() \
        < (rounded.double() - b64).abs().mean()


def test_k6_stage1_plus_stage2_is_the_fft():
    xr, xi = _planes(3)
    stage = fft_stage1.Stage1(N)
    out_r, out_i = mxu_fft.stage2_carrier_major(
        *stage(torch.from_numpy(xr), torch.from_numpy(xi)), N)
    assert out_r.shape == (N, S, F) and out_r.dtype == torch.bfloat16
    ref = np.fft.fft(xr.astype(np.float64) + 1j * xi, axis=-1
                     ).transpose(2, 1, 0)
    got = out_r.double().numpy() + 1j * out_i.double().numpy()
    assert _rms(got - ref) < 2e-2 * _rms(ref)


def test_k6_wrapper_checks_its_input():
    stage = fft_stage1.Stage1(N)
    x = torch.zeros((F, S, N))
    with pytest.raises(ValueError):                 # CPU tensors: no kernel
        stage.kernel(x, x)
    with pytest.raises(ValueError):
        stage(torch.zeros((F, S, N // 2)), torch.zeros((F, S, N // 2)))
    assert fft_stage1.fft_stage1_cuda.launches == 0


@pytest.mark.parametrize("n", sorted(jfft._FACTORS))
def test_tables_equal_jax(n):
    assert mxu_fft._FACTORS[n] == jfft._FACTORS[n]
    if n > 4096:
        return                       # the same code; keep the arrays small
    for mine, ref in zip(mxu_fft._tables(n), jfft._tables(n)):
        assert mine.dtype == ref.dtype == np.complex64
        np.testing.assert_array_equal(mine, ref)


def test_fft_f32_equals_jax():
    xr, xi = _planes(4)
    hi = jax.lax.Precision.HIGHEST
    ref_r, ref_i = jfft.fft_stages_planar(jnp.asarray(xr), jnp.asarray(xi),
                                          N, precision=hi)
    got_r, got_i = mxu_fft.fft_stages_planar(torch.from_numpy(xr),
                                             torch.from_numpy(xi), N)
    assert got_r.shape == (F, S, 32, 32) and got_r.dtype == torch.float32
    scale = _rms(np.asarray(ref_r))
    assert np.abs(got_r.numpy() - np.asarray(ref_r)).max() < 1e-4 * scale
    assert np.abs(got_i.numpy() - np.asarray(ref_i)).max() < 1e-4 * scale
    # carrier-major and the complex drop-in
    cm_r, cm_i = jfft.fft_carrier_major_planar(
        jnp.asarray(xr), jnp.asarray(xi), N, precision=hi)
    tm_r, tm_i = mxu_fft.fft_carrier_major_planar(
        torch.from_numpy(xr), torch.from_numpy(xi), N)
    assert tm_r.shape == (N, S, F)
    assert np.abs(tm_r.numpy() - np.asarray(cm_r)).max() < 1e-4 * scale
    assert np.abs(tm_i.numpy() - np.asarray(cm_i)).max() < 1e-4 * scale
    z = torch.from_numpy(xr + 1j * xi)
    zf = mxu_fft.fft(z)
    np.testing.assert_allclose(zf.numpy(), np.asarray(jfft.fft(
        jnp.asarray(xr + 1j * xi), precision=hi)), atol=1e-4 * scale)
    np.testing.assert_allclose(zf.numpy(), np.fft.fft(xr + 1j * xi),
                               atol=1e-4 * scale)
    # an unsupported length takes the library FFT
    np.testing.assert_allclose(mxu_fft.fft(z[..., :100]).numpy(),
                               np.fft.fft((xr + 1j * xi)[..., :100]),
                               atol=1e-4 * scale)


def test_fft_bf16_pipe_within_its_error():
    """The JAX bf16 pipe itself cannot run here (XLA's CPU backend has no
    bf16 x bf16 -> f32 dot), so the port's bf16 pipe is held to the JAX
    f32 spectrum and to the f64 truth."""
    xr, xi = _planes(5)
    ref_r, ref_i = jfft.fft_carrier_major_planar(
        jnp.asarray(xr), jnp.asarray(xi), N,
        precision=jax.lax.Precision.HIGHEST)
    got_r, got_i = mxu_fft.fft_carrier_major_planar(
        torch.from_numpy(xr), torch.from_numpy(xi), N, dtype=torch.bfloat16)
    assert got_r.dtype == torch.bfloat16 and got_r.shape == (N, S, F)
    ref = np.asarray(ref_r) + 1j * np.asarray(ref_i)
    got = got_r.float().numpy() + 1j * got_i.float().numpy()
    truth = np.fft.fft(xr.astype(np.float64) + 1j * xi, axis=-1
                       ).transpose(2, 1, 0)
    assert _rms(got - ref) < 2e-2 * _rms(truth)
    assert _rms(got - truth) < 2e-2 * _rms(truth)
    assert _rms(got - truth) > 1e-4 * _rms(truth)     # it is the bf16 pipe


def test_fft_microbench_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert fft_microbench.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().out


def test_fft_microbench_library_route_is_stage1():
    """The tool's library yardstick (bf16 torch.matmul, a rounded before
    the twiddle) computes K6's function up to that extra rounding."""
    xr, xi = _planes(7)
    stage = fft_stage1.Stage1(N)
    yr, yi = stage._input(torch.from_numpy(xr), torch.from_numpy(xi))
    tabs = stage.tables("cpu")
    lib_r, lib_i = fft_microbench.stage1_matmul_bf16(yr, yi, *tabs)
    ref_r, ref_i = fft_stage1.stage1_plain(yr, yi, *tabs)
    assert lib_r.dtype == torch.bfloat16
    scale = float(ref_r.float().abs().max())
    assert float((lib_r.float() - ref_r.float()).abs().max()) < 2e-2 * scale
    assert float((lib_i.float() - ref_i.float()).abs().max()) < 2e-2 * scale


@pytest.mark.cuda
def test_k6_kernel_within_tolerance_of_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    for n in (1024, 8192, 32768):
        xr, xi = _planes(6, n)
        stage = fft_stage1.Stage1(n)
        a, b = torch.from_numpy(xr).cuda(), torch.from_numpy(xi).cuda()
        for got, ref in zip(stage.kernel(a, b), stage.plain(a, b)):
            res = fft_stage1.compare(got, ref)
            assert res["ok"], (n, res)
