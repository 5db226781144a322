"""The LDPC study helpers of the port against the JAX package's.

`ops/ldpc_tables.llrs_to_qc` / `qc_to_bits` (NumPy copies: exact),
`ops/ldpc_layered.qc_syndrome_ok`, `build_layered_stepper` and
`build_layered_decoder` (the XLA mirrors of the layered schedule that the
tools `twophase_study`, `minsum_variant_study` and `hbm_vmem_equivalence`
run), `ops/ldpc.syndrome_ok` and `utils/loops.PILoopFilter.scan_fn`.

Tolerances: tables, bits, syndrome counts and hard decisions exact; the
stepper's f32 totals within 1e-5 relative (the same f32 operations in the
same order: measured equal, the margin covers XLA's CPU vectorisation).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdr_receiver_dvb_t2_tpu.dvbt2 import ldpc as jldpcmod
from sdr_receiver_dvb_t2_tpu.dvbt2.params import CodeRate, FECFrame
from sdr_receiver_dvb_t2_tpu.ops import ldpc as jflood
from sdr_receiver_dvb_t2_tpu.ops import ldpc_pallas as qc
from sdr_receiver_dvb_t2_tpu.utils import loops as jloops
from sdr_receiver_dvb_t2_tpu_torch.dvbt2 import ldpc as tldpcmod
from sdr_receiver_dvb_t2_tpu_torch.ops import ldpc as tflood
from sdr_receiver_dvb_t2_tpu_torch.ops import ldpc_layered as tl
from sdr_receiver_dvb_t2_tpu_torch.ops import ldpc_tables as tt
from sdr_receiver_dvb_t2_tpu_torch.utils import loops as tloops
from sdr_receiver_dvb_t2_tpu_torch.utils.reference import from_reference

torch.set_num_threads(1)

S, N = FECFrame.SHORT, FECFrame.NORMAL
RTOL = 1e-5


def P(*values):
    return from_reference(values)


def _noisy(frame, rate, b, amp, seed):
    rng = np.random.default_rng(seed)
    code = jldpcmod.get_code(frame, rate)
    cw = jldpcmod.encode(code, rng.integers(0, 2, (b, code.k)
                                            ).astype(np.uint8))
    llr = (amp * (1 - 2.0 * cw) + rng.normal(0, 1.0, cw.shape)
           ).astype(np.float32)
    return cw, llr


def _jax_syndrome(frame, rate):
    """JAX's qc_syndrome_weight and qc_syndrome_ok, one compile."""
    return jax.jit(lambda ti, tp: (
        qc.qc_syndrome_weight(frame, rate, ti, tp),
        qc.qc_syndrome_ok(frame, rate, ti, tp)))


@pytest.mark.parametrize("frame,rate", [(S, CodeRate.C1_2),
                                        (N, CodeRate.C2_3)])
def test_qc_layout_helpers_equal_jax(frame, rate):
    """llrs_to_qc, qc_to_bits and qc_syndrome_ok (and the weight behind
    it) equal JAX's exactly, on noisy words where some checks fail."""
    cw, llr = _noisy(frame, rate, 4, 1.2, 1)
    jtab = qc.qc_tables(frame, rate)
    ttab = tt.qc_tables(*P(frame, rate))
    ji, jp = qc.llrs_to_qc(jtab, llr)
    ti, tp = tt.llrs_to_qc(ttab, llr)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tt.qc_to_bits(ttab, ti, tp),
                                  qc.qc_to_bits(jtab, ji, jp))
    np.testing.assert_array_equal(tt.qc_to_bits(ttab, ti, tp),
                                  (llr < 0).astype(np.uint8))
    # a clean word too: its syndrome holds
    ci, cp = tt.llrs_to_qc(ttab, (1.0 - 2.0 * cw[:1]).astype(np.float32))
    ti[:, :, :1], tp[:, :, :1] = ci, cp
    ji, jp = ti.copy(), tp.copy()
    jw, jok = (np.asarray(a) for a in _jax_syndrome(frame, rate)(
        jnp.asarray(ji), jnp.asarray(jp)))
    tw = tl.qc_syndrome_weight(*P(frame, rate), torch.from_numpy(ti),
                               torch.from_numpy(tp))
    np.testing.assert_array_equal(tw.numpy(), jw)
    ok = tl.qc_syndrome_ok(*P(frame, rate), torch.from_numpy(ti),
                           torch.from_numpy(tp))
    np.testing.assert_array_equal(ok.numpy(), jok)
    assert ok[0] and not ok[1:].any()


@functools.lru_cache(maxsize=None)
def _jax_stepper(frame, rate, offset, scale, c2v_bf16, order):
    return qc.build_layered_stepper(
        frame, rate, offset=offset, scale=scale,
        c2v_dtype=jnp.bfloat16 if c2v_bf16 else None,
        layer_order=None if order is None else list(order))


def _permuted(q):
    return tuple(int(t) for t in np.random.default_rng(13).permutation(q))


@pytest.mark.parametrize("variant", [
    "offset 0.5", "normalized 0.75", "bf16 c2v", "permuted order"])
def test_stepper_equals_jax(variant):
    """Three sweeps of the stepper from the same state as JAX's: hard
    decisions and messages' signs exact, totals within RTOL.  bf16 c2v
    makes equal magnitudes (ties of the two-minimum scan) common, where
    the argmin leave-one-out rule decides."""
    frame, rate = S, CodeRate.C1_2
    q = qc.qc_tables(frame, rate).q
    offset, scale, bf16, order = {
        "offset 0.5": (0.5, 1.0, False, None),
        "normalized 0.75": (0.0, 0.75, False, None),
        "bf16 c2v": (0.5, 1.0, True, None),
        "permuted order": (0.5, 1.0, False, _permuted(q)),
    }[variant]
    _, llr = _noisy(frame, rate, 8, 1.1, 2)
    if bf16:
        llr = llr.astype(jnp.bfloat16).astype(np.float32)
    jtab = qc.qc_tables(frame, rate)
    ti, tp = qc.llrs_to_qc(jtab, llr)
    c2v = np.zeros((jtab.q, jtab.degmax + 2, 360, 8), np.float32)
    jstep = _jax_stepper(frame, rate, offset, scale, bf16, order)
    tstep = tl.build_layered_stepper(
        *P(frame, rate), offset=offset, scale=scale,
        c2v_dtype=torch.bfloat16 if bf16 else None,
        layer_order=None if order is None else list(order))
    js = (jnp.asarray(ti), jnp.asarray(tp), jnp.asarray(c2v))
    ts = tuple(torch.from_numpy(a.copy()) for a in (ti, tp, c2v))
    before = [a.clone() for a in ts]
    for sweep in range(3):
        js = jstep(*js)
        ts = tstep(*ts)
        for j, t in zip(js, ts):
            j = np.asarray(j)
            np.testing.assert_allclose(t.numpy(), j, rtol=RTOL, atol=1e-6)
            np.testing.assert_array_equal(t.numpy() < 0, j < 0)
    # the stepper leaves its inputs as they were
    assert all(torch.equal(a, b) for a, b in zip(before, (
        torch.from_numpy(ti), torch.from_numpy(tp), torch.from_numpy(c2v))))


def test_layered_decoder_equals_jax_and_corrects():
    """build_layered_decoder (f32, 8 sweeps): bits equal to JAX's and to
    the transmitted codewords; totals within RTOL."""
    frame, rate = S, CodeRate.C1_2
    cw, llr = _noisy(frame, rate, 8, 2.2, 3)
    assert ((llr < 0) != cw).any()
    jtab = qc.qc_tables(frame, rate)
    ti, tp = qc.llrs_to_qc(jtab, llr)
    ja, jb = (np.asarray(a) for a in qc.build_layered_decoder(
        frame, rate, iters=8)(jnp.asarray(ti), jnp.asarray(tp)))
    ta, tb = tl.build_layered_decoder(*P(frame, rate), iters=8)(
        torch.from_numpy(ti), torch.from_numpy(tp))
    np.testing.assert_allclose(ta.numpy(), ja, rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(tb.numpy(), jb, rtol=RTOL, atol=1e-6)
    ttab = tt.qc_tables(*P(frame, rate))
    bits = tt.qc_to_bits(ttab, ta.numpy(), tb.numpy())
    np.testing.assert_array_equal(bits, qc.qc_to_bits(jtab, ja, jb))
    np.testing.assert_array_equal(bits, cw)


def test_syndrome_ok_equals_jax():
    """ops/ldpc.syndrome_ok (NumPy) equals JAX's on clean and corrupted
    words."""
    frame, rate = S, CodeRate.C2_3
    cw, _ = _noisy(frame, rate, 6, 1.0, 4)
    bad = cw.copy()
    bad[1::2, 17] ^= 1
    jcode = jldpcmod.get_code(frame, rate)
    tcode = tldpcmod.get_code(*P(frame, rate))
    got = tflood.syndrome_ok(tcode, bad)
    np.testing.assert_array_equal(got, jflood.syndrome_ok(jcode, bad))
    np.testing.assert_array_equal(got, np.arange(6) % 2 == 0)


@pytest.mark.parametrize("clamp", [np.inf, 0.05])
def test_pi_scan_fn_equals_jax(clamp):
    """PILoopFilter.scan_fn on f32 tensors equals JAX's under lax.scan
    (f32) and the host step."""
    errs = np.random.default_rng(5).normal(0, 0.1, 64).astype(np.float32)
    jf = jloops.PILoopFilter(bandwidth=0.1, clamp=clamp)
    tf = tloops.PILoopFilter(bandwidth=0.1, clamp=clamp)
    _, jout = jax.lax.scan(jf.scan_fn(), jnp.float32(0.0), jnp.asarray(errs))
    f = tf.scan_fn()
    integ = torch.zeros((), dtype=torch.float32)
    outs = []
    for e in torch.from_numpy(errs):
        integ, o = f(integ, e)
        outs.append(o)
    tout = torch.stack(outs).numpy()
    np.testing.assert_allclose(tout, np.asarray(jout), rtol=1e-6, atol=1e-7)
    st, host = tloops.PIState(), []
    for e in errs:
        st, o = tf.step(st, float(e))
        host.append(o)
    np.testing.assert_allclose(tout, host, rtol=1e-5, atol=1e-6)
