"""The port's layered LDPC decoder (sdr_receiver_dvb_t2_tpu_torch/ops/
ldpc_layered.py) against the JAX reference on SHORT codes.

The reference is K1's semantics built from the JAX package's XLA pieces:
`build_layered_stepper(c2v_dtype=bf16)` sweeps in the kernel's layer order,
`qc_syndrome_weight` gates the exit after every `check_every` sweeps once
the floor max(min_it, min_iters) is reached.  Bits and sweep counts must be
equal (integers: tolerance 0).  The CUDA kernel itself runs only on the
card; its test is marked `cuda` and the on-card check is chip_smoke.py."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdr_receiver_dvb_t2_tpu.dvbt2 import ldpc as ldpcmod
from sdr_receiver_dvb_t2_tpu.dvbt2.ldpc import _TABLE_KEY
from sdr_receiver_dvb_t2_tpu.dvbt2.params import CodeRate, FECFrame
from sdr_receiver_dvb_t2_tpu.ops import ldpc_pallas as qc
from sdr_receiver_dvb_t2_tpu_torch.ops import ldpc_layered as tl
from sdr_receiver_dvb_t2_tpu_torch.ops import ldpc_tables
from sdr_receiver_dvb_t2_tpu_torch.utils.reference import from_reference as P_

torch.set_num_threads(1)


def P(*values):
    """The JAX package's enums -> the port's own (by name)."""
    return P_(values)


S, N = FECFrame.SHORT, FECFrame.NORMAL


def _noisy(frame, rate, b, amp, seed):
    rng = np.random.default_rng(seed)
    code = ldpcmod.get_code(frame, rate)
    cw = ldpcmod.encode(code, rng.integers(0, 2, (b, code.k)
                                           ).astype(np.uint8))
    llr = (amp * (1 - 2.0 * cw) + rng.normal(0, 1.0, cw.shape)
           ).astype(np.float32)
    return cw, np.ascontiguousarray(llr.T)


@functools.lru_cache(maxsize=None)
def _stepper(frame, rate, order):
    return qc.build_layered_stepper(frame, rate, c2v_dtype=jnp.bfloat16,
                                    layer_order=order)


@functools.lru_cache(maxsize=None)
def _syndrome(frame, rate):
    return jax.jit(functools.partial(qc.qc_syndrome_weight, frame, rate))


def _jax_k1(frame, rate, llr_t, max_iters, check_every, min_iters, min_it,
            order):
    tab = qc.qc_tables(frame, rate)
    step = _stepper(frame, rate, order)
    v = jnp.asarray(llr_t).astype(jnp.bfloat16).astype(jnp.float32)
    ti, tp = qc.llrs_nb_to_qc_jnp(tab, v)
    c2v = jnp.zeros((tab.q, tab.degmax + 2, 360, llr_t.shape[1]),
                    jnp.float32)
    iters = max_iters
    for ci in range(-(-max_iters // check_every)):
        for _ in range(check_every):
            ti, tp, c2v = step(ti, tp, c2v)
        it_now = (ci + 1) * check_every
        if it_now >= max(min_it, min_iters) and \
                int(_syndrome(frame, rate)(ti, tp).sum()) == 0:
            iters = it_now
            break
    return np.asarray(qc.qc_to_bits_nb_jnp(tab, ti, tp)), iters


@pytest.mark.parametrize("frame,rate", sorted(_TABLE_KEY, key=str))
def test_qc_tables_equal_jax(frame, rate):
    mine = ldpc_tables.qc_tables(*P(frame, rate))
    ref = qc.qc_tables(frame, rate)
    for f in ("n", "k", "q", "n_groups", "degmax"):
        assert getattr(mine, f) == getattr(ref, f)
    for f in ("layer_deg", "entry_g", "entry_s"):
        np.testing.assert_array_equal(getattr(mine, f), getattr(ref, f))


@pytest.mark.parametrize("order", [None, "reversed", [3, 1, 0, 2, 4]])
def test_layer_order_equal_jax(order):
    q = 5
    assert ldpc_tables._layer_order(q, order) == qc._layer_order(q, order)


# (frame, rate, B, LLR amplitude, layer order, check_every, min_iters,
#  traced floor min_it, max_iters); one batch size per (code, order) keeps
#  the JAX reference at two compilations
CASES = {
    "c12-reversed": (S, CodeRate.C1_2, 3, 2.0, "reversed", 1, 0, 0, 12),
    "c12-traced-floor": (S, CodeRate.C1_2, 3, 2.5, "reversed", 1, 0, 5, 12),
    "c12-no-convergence": (S, CodeRate.C1_2, 3, 0.3, "reversed", 1, 0, 0, 6),
    "c34-natural-min_iters": (S, CodeRate.C3_4, 8, 2.0, None, 2, 3, 0, 12),
    # 3 chunks of 2 sweeps run; the count reports max_iters = 5
    "c34-no-convergence-ragged": (S, CodeRate.C3_4, 8, 0.3, None, 2, 0, 0,
                                  5),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_decoder_equals_jax(case):
    frame, rate, b, amp, order, ce, min_iters, min_it, max_iters = \
        CASES[case]
    cw, llr_t = _noisy(frame, rate, b, amp, seed=len(case))
    ref_bits, ref_it = _jax_k1(frame, rate, llr_t, max_iters, ce,
                               min_iters, min_it, order)
    dec = tl.make_adaptive_decoder_nb_fused_io(*P(frame, rate),
        max_iters=max_iters, check_every=ce,
        min_iters=min_iters, layer_order=order)
    bits, it = dec(torch.from_numpy(llr_t), torch.tensor(min_it))
    assert it.dtype == torch.int32 and int(it) == ref_it
    assert bits.dtype == torch.uint8 and bits.shape == llr_t.shape
    np.testing.assert_array_equal(bits.numpy(), ref_bits)
    if "no-convergence" in case:
        assert ref_it == max_iters
    else:
        assert max(min_it, min_iters) <= ref_it < max_iters
        np.testing.assert_array_equal(bits.numpy().T, cw)


def test_syndrome_weight_equals_jax():
    frame, rate = S, CodeRate.C1_2
    tab = qc.qc_tables(frame, rate)
    rng = np.random.default_rng(2)
    ti = rng.normal(size=(tab.n_groups + 1, 360, 4)).astype(np.float32)
    tp = rng.normal(size=(tab.q, 360, 4)).astype(np.float32)
    ref = np.asarray(_syndrome(frame, rate)(jnp.asarray(ti),
                                            jnp.asarray(tp)))
    got = tl.qc_syndrome_weight(*P(frame, rate), torch.from_numpy(ti),
                                torch.from_numpy(tp))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_kernel_wrapper_refuses_cpu_tensor():
    dec = tl.make_adaptive_decoder_nb_fused_io(*P(S, CodeRate.C1_2))
    v = torch.zeros((16200, 2), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        dec.kernel(v)


@pytest.mark.cuda
def test_kernel_equals_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    for frame, rate, b in ((S, CodeRate.C1_2, 5), (N, CodeRate.C2_3, 128)):
        _, llr_t = _noisy(frame, rate, b, 1.6, seed=b)
        dec = tl.make_adaptive_decoder_nb_fused_io(*P(frame, rate),
            max_iters=24, check_every=1,
            layer_order="reversed")
        v = torch.from_numpy(llr_t).to("cuda", torch.bfloat16)
        kb, kit = dec.kernel(v, 0)
        pb, pit = dec.plain(v, 0)
        assert int(kit) == int(pit)
        assert torch.equal(kb, pb)
