"""The port's sample-domain front end (sdr_receiver_dvb_t2_tpu_torch/ops/
frontend_device.py) against the JAX package's, at f32 and nvar=0.

Tolerances: the two run the same f32 operations in the same order, but
XLA may contract a multiply-add and its cos/sin differ from PyTorch's by
an ulp, so outputs agree to a few f32 ulps of the signal scale (1e-5
relative, measured ~1.5e-6); the frame phase holds the ~1e-4 rad bound of
the compensated reduction; the int16-quantized impairer output may differ
by one quantization step where a value sits on a rounding edge."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdr_receiver_dvb_t2_tpu.ops import frontend_device as jf
from sdr_receiver_dvb_t2_tpu_torch.ops import frontend_device as tf

torch.set_num_threads(1)

FS = 9.142857e6
HALF = 8
RTOL = 1e-5


def _bandlimited(n, seed, edge=0.425):
    rng = np.random.default_rng(seed)
    nf = int(n * edge)
    spec = np.zeros(n, np.complex128)
    spec[1:nf] = rng.normal(size=nf - 1) + 1j * rng.normal(size=nf - 1)
    spec[-nf + 1:] = rng.normal(size=nf - 1) + 1j * rng.normal(size=nf - 1)
    return (np.fft.ifft(spec) * np.sqrt(n)).astype(np.complex64)


def _clean(n, f, seed=7):
    x = np.stack([_bandlimited(n + 64, seed + i)[:n] for i in range(f)])
    xp = np.pad(x, ((0, 0), (2 * HALF, 0)))
    return np.stack([xp.real, xp.imag], -1).astype(np.float32)


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(a).std()


def test_farrow_bank_equals_jax():
    for half, deg in ((8, 7), (8, 9), (4, 5)):
        mine, ref = tf.farrow_bank(half, deg), jf.farrow_bank(half, deg)
        np.testing.assert_array_equal(mine[0], ref[0])
        np.testing.assert_array_equal(mine[1], ref[1])
        assert mine[2] == ref[2]


@pytest.mark.parametrize("w", [1e-3, 8.2e-4, -5e-4])
def test_mod2pi_prod_equals_jax(w):
    for n in (12345, 2_400_000, 16_000_000):
        ref = float(jf._mod2pi_prod(jnp.float32(w), n))
        got = float(tf._mod2pi_prod(torch.tensor(w), n))
        assert got == ref
        w32 = float(np.float32(w))
        err = np.remainder(got - w32 * n + np.pi, 2 * np.pi) - np.pi
        assert abs(err) < 1e-6


def test_frame_phase_bound():
    """Per-frame NCO phase offsets at a 32K-frame raw length and F=128
    stay within 1e-4 rad of the float64 truth, and equal JAX's."""
    n_in, f = 2_450_000, 128
    args = (np.float32(1200.0), np.float32(1 + 22e-6), np.float32(0.0))
    ref = jf._nco_terms(*(jnp.float32(a) for a in args), FS, 64, f, n_in)
    got = tf._nco_terms(*(torch.tensor(a) for a in args), FS, 64, f, n_in)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]),
                               atol=1e-6)
    truth = np.remainder(float(got[0]) * n_in * np.arange(f), 2 * np.pi)
    err = np.remainder(got[3].numpy() - truth + np.pi, 2 * np.pi) - np.pi
    assert np.abs(err).max() < 1e-4


def _impaired(n, f, ratio):
    n_raw = int(np.ceil((n + 2 * HALF) * ratio)) + 4 * HALF
    clean = _clean(n, f)
    imp = jf.make_impairer(n_raw, FS, half=HALF)
    raw = imp(jnp.asarray(clean), jnp.float32(900.0), jnp.float32(ratio),
              jnp.float32(0.1), jnp.asarray([0.004, -0.003], jnp.float32),
              jnp.asarray([1.015, 0.01], jnp.float32),
              jax.random.PRNGKey(2), jnp.float32(0.0))
    return clean, np.asarray(raw), n_raw


def test_impairer_and_resampler_equal_jax():
    ratio = np.float32(1 + 2e-5)
    clean, ref, n_raw = _impaired(3500, 2, ratio)
    imp = tf.make_impairer(n_raw, FS, half=HALF)
    got = imp(torch.from_numpy(clean), 900.0, torch.tensor(ratio), 0.1,
              torch.tensor([0.004, -0.003]), torch.tensor([1.015, 0.01]),
              None, 0.0).numpy()
    lsb = np.abs(clean).max() / 32000.0
    assert np.abs(got - ref).max() <= 1.001 * lsb
    assert np.mean(got != ref) < 0.01
    # three resampler chunks of 16384 outputs
    long = _clean(40000, 1, seed=3)
    res_j = jf.make_resampler(39000, half=HALF)
    res_t = tf.make_resampler(39000, half=HALF)
    a = np.asarray(res_j(jnp.asarray(long), jnp.float32(1 / ratio), 8.0))
    b = res_t(torch.from_numpy(long), torch.tensor(1 / ratio), 8.0).numpy()
    assert b.shape == a.shape and _rel(a, b) < RTOL


def test_impairer_noise_power():
    clean = np.full((1, 20000, 2), 0.2, np.float32)
    clean[0, 0, 0] = 1.0
    imp = tf.make_impairer(20040, FS)
    gen = torch.Generator().manual_seed(1)
    args = (torch.from_numpy(clean), 0.0, 1.0, 0.0, torch.zeros(2),
            torch.tensor([1.0, 0.0]))
    r0 = imp(*args, gen, 0.0)
    r1 = imp(*args, gen, 0.01)
    d = (r1 - r0)[0, 100:-100]
    assert 0.008 < float((d ** 2).sum(-1).mean()) < 0.012


def test_frontend_raw_len_equals_jax():
    for n_samp in (94976, 2048 + 60 * 33024, 1, 12345):
        for sco in (0.0, 2e-5, 2.2e-5, -3e-5, 6.25e-3):
            for half in (4, 8):
                assert tf.frontend_raw_len(n_samp, sco, half) == \
                    jf.frontend_raw_len(n_samp, sco, half)


# (n_sym, sym_size, guard, p1_len, pos0): the left-edge case starts the
# first symbol's stencil left of sample 0; the JAX slice then counts the
# start from the buffer end and clamps it, and the port must do the same
FE_CASES = {"grid": (3, 3000, 200, 500, None),
            "left-edge-clamp": (3, 1000, 4, 0, 0.0)}


@pytest.mark.parametrize("case", sorted(FE_CASES))
def test_frontend_symbols_equal_jax(case):
    n_sym, sym_size, guard, p1_len, pos0 = FE_CASES[case]
    ratio = np.float32(1 + 2e-5)
    _, raw, _ = _impaired(p1_len + n_sym * sym_size, 2, ratio)
    pos0 = np.float32(HALF * ratio if pos0 is None else pos0)
    order = np.array([2, 0, 1])
    track = (np.float32(900.0), ratio, pos0, np.float32(0.1))
    if case == "left-edge-clamp":
        assert guard + np.floor(pos0) - (HALF - 1) < 0
    fe_j = jf.make_frontend_symbols(n_sym, sym_size, guard, FS,
                                    p1_len=p1_len, half=HALF,
                                    sym_order=order)
    fe_t = tf.make_frontend_symbols(n_sym, sym_size, guard, FS,
                                    p1_len=p1_len, half=HALF,
                                    sym_order=order)
    (ar, ai), adc, agiq = fe_j(jnp.asarray(raw[..., 0]),
                               jnp.asarray(raw[..., 1]),
                               *(jnp.float32(v) for v in track))
    (br, bi), bdc, bgiq = fe_t(torch.from_numpy(raw[..., 0].copy()),
                               torch.from_numpy(raw[..., 1].copy()),
                               *(torch.tensor(v) for v in track))
    assert br.shape == (2, n_sym, sym_size - guard)
    a = np.asarray(ar) + 1j * np.asarray(ai)
    b = br.numpy() + 1j * bi.numpy()
    assert _rel(a, b) < RTOL
    np.testing.assert_allclose(bdc.numpy(), np.asarray(adc), atol=1e-7)
    np.testing.assert_allclose(bgiq.numpy(), np.asarray(agiq), atol=1e-6)
    # bf16 emission is the f32 result rounded
    (cr, _), _, _ = tf.make_frontend_symbols(
        n_sym, sym_size, guard, FS, p1_len=p1_len, half=HALF,
        sym_order=order, out_dtype=torch.bfloat16)(
        torch.from_numpy(raw[..., 0].copy()),
        torch.from_numpy(raw[..., 1].copy()),
        *(torch.tensor(v) for v in track))
    assert cr.dtype == torch.bfloat16
    torch.testing.assert_close(cr, br.to(torch.bfloat16), atol=0, rtol=0)
