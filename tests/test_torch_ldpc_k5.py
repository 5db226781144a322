"""The port's decoder K5 (sdr_receiver_dvb_t2_tpu_torch/ops/
ldpc_layered.py: `make_decoder_nb_fused_io`) against the JAX package on
SHORT codes at B=8.

- K5 plain vs `make_decoder_nb_fused_io(interpret=True)` (the TPU kernel
  in interpret mode, at its default bf16 and, as tests/test_ldpc_pallas.py
  runs it, at f32 on LLRs that bf16 holds exactly);
- K5 plain vs `build_layered_stepper(c2v_dtype=bf16)` over several sweeps
  from bf16-rounded LLRs;
- where K5 and K3 differ: an LLR that bf16 rounds changes K5's input and
  not K3's;
- the ValueError of a code whose staging does not fit the c2v scratch.

Bits must be equal (integers: tolerance 0).  The CUDA kernel runs only on
the card: its test is marked `cuda`, and chip_smoke.py holds it against
this plain version there."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdr_receiver_dvb_t2_tpu.dvbt2 import ldpc as ldpcmod
from sdr_receiver_dvb_t2_tpu.dvbt2.ldpc import _TABLE_KEY
from sdr_receiver_dvb_t2_tpu.dvbt2.params import CodeRate, FECFrame
from sdr_receiver_dvb_t2_tpu.ops import ldpc_pallas as qc
from sdr_receiver_dvb_t2_tpu_torch.ops import ldpc_layered as tl
from sdr_receiver_dvb_t2_tpu_torch.utils.reference import from_reference as P_

torch.set_num_threads(1)

S, N = FECFrame.SHORT, FECFrame.NORMAL
B = 8


def P(*values):
    """The JAX package's enums -> the port's own (by name)."""
    return P_(values)


def _noisy(frame, rate, b, amp, seed):
    rng = np.random.default_rng(seed)
    code = ldpcmod.get_code(frame, rate)
    cw = ldpcmod.encode(code, rng.integers(0, 2, (b, code.k)
                                           ).astype(np.uint8))
    llr = (amp * (1 - 2.0 * cw) + rng.normal(0, 1.0, cw.shape)
           ).astype(np.float32)
    return cw, np.ascontiguousarray(llr.T)


@functools.lru_cache(maxsize=None)
def _stepper(rate):
    return qc.build_layered_stepper(S, rate, c2v_dtype=jnp.bfloat16)


def _bf16_exact(x):
    return torch.from_numpy(x).bfloat16().float().numpy()


def test_k5_plain_equals_jax_kernel():
    # a noise level where some codewords are still wrong after 6 sweeps
    rate = CodeRate.C1_2
    cw, llr_t = _noisy(S, rate, B, 1.4, seed=21)
    ref = qc.make_decoder_nb_fused_io(S, rate, iters=6, batch=B,
                                      interpret=True)(jnp.asarray(llr_t))
    dec = tl.make_decoder_nb_fused_io(*P(S, rate), iters=6, batch=B)
    bits = dec(torch.from_numpy(llr_t))
    assert bits.dtype == torch.uint8 and bits.shape == llr_t.shape
    np.testing.assert_array_equal(bits.numpy(), np.asarray(ref))
    assert (bits.numpy().T != cw).any()      # a discriminating input


def test_k5_plain_equals_jax_kernel_at_f32_on_bf16_valued_llrs():
    """The JAX package's own test runs its kernel with dtype=f32; on LLRs
    that bf16 holds exactly the input rounding is the identity, and the
    f32 kernel differs from K5 only in its f32 c2v.  After 8 sweeps at
    this noise both have converged on the transmitted words."""
    cw, llr_t = _noisy(S, CodeRate.C1_2, B, 3.0, seed=0)
    llr_t = _bf16_exact(llr_t)
    ref = qc.make_decoder_nb_fused_io(S, CodeRate.C1_2, iters=8, batch=B,
                                      interpret=True, dtype=jnp.float32)(
        jnp.asarray(llr_t))
    bits = tl.make_decoder_nb_fused_io(*P(S, CodeRate.C1_2), iters=8,
                                       batch=B)(torch.from_numpy(llr_t))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(bits.numpy().T, cw)


@pytest.mark.parametrize("sweeps", [1, 3, 5])
def test_k5_plain_equals_jax_stepper(sweeps):
    rate = CodeRate.C3_5
    _, llr_t = _noisy(S, rate, B, 1.3, seed=22)
    tab = qc.qc_tables(S, rate)
    step = _stepper(rate)
    v = jnp.asarray(llr_t).astype(jnp.bfloat16).astype(jnp.float32)
    ti, tp = qc.llrs_nb_to_qc_jnp(tab, v)
    c2v = jnp.zeros((tab.q, tab.degmax + 2, 360, B), jnp.float32)
    for _ in range(sweeps):
        ti, tp, c2v = step(ti, tp, c2v)
    ref = np.asarray(qc.qc_to_bits_nb_jnp(tab, ti, tp))
    bits = tl.make_decoder_nb_fused_io(*P(S, rate), iters=sweeps, batch=B)(
        torch.from_numpy(llr_t))
    np.testing.assert_array_equal(bits.numpy(), ref)


def test_k5_rounds_llrs_before_the_totals_and_k3_does_not():
    """LLRs of magnitude 2^-140 are f32 subnormals that bf16 rounds to 0.
    With 0 sweeps the bits are the input's signs: K3 (f32 totals) keeps
    them, K5 (bf16 staging) sees +0 everywhere.  On bf16-exact LLRs the
    two decoders agree bit for bit."""
    frame, rate = P(S, CodeRate.C1_2)
    n = tl.qc_tables(frame, rate).n
    rng = np.random.default_rng(23)
    tiny = torch.from_numpy(
        np.where(rng.integers(0, 2, (n, B)) == 1, -1.0, 1.0)
        .astype(np.float32)) * 2.0 ** -140
    assert (tiny != 0).all() and (tiny.bfloat16() == 0).all()
    k3 = tl.make_decoder_nb(frame, rate, iters=0, batch=B, variant="vmem")
    k5 = tl.make_decoder_nb_fused_io(frame, rate, iters=0, batch=B)
    assert torch.equal(k3(tiny), (tiny < 0).to(torch.uint8))
    assert int(k5(tiny).sum()) == 0
    # and through the sweeps: an LLR that bf16 moves changes K5's result
    _, llr_t = _noisy(S, CodeRate.C1_2, B, 1.2, seed=24)
    x = torch.from_numpy(llr_t)
    k3 = tl.make_decoder_nb(frame, rate, iters=3, batch=B, variant="vmem")
    k5 = tl.make_decoder_nb_fused_io(frame, rate, iters=3, batch=B)
    assert torch.equal(k5(x), k3(x.bfloat16().float()))
    assert not torch.equal(k5(x), k3(x))


@pytest.mark.parametrize("frame,rate", sorted(_TABLE_KEY, key=str))
def test_k5_staging_rule_equals_jax(frame, rate):
    """`gi_rows + pi_rows > q` raises ValueError in both packages, for the
    same codes."""
    try:
        qc.make_decoder_nb_fused_io(frame, rate, iters=1, batch=B,
                                    interpret=True)
        fits = True
    except ValueError as e:
        assert "staging exceeds" in str(e)
        fits = False
    if fits:
        tl.make_decoder_nb_fused_io(*P(frame, rate), iters=1, batch=B)
    else:
        with pytest.raises(ValueError, match="staging exceeds"):
            tl.make_decoder_nb_fused_io(*P(frame, rate), iters=1, batch=B)


def test_k5_front_door_checks_its_input():
    dec = tl.make_decoder_nb_fused_io(*P(S, CodeRate.C1_2), iters=2, batch=B)
    with pytest.raises(ValueError):
        dec(torch.zeros((16200, B + 1)))
    with pytest.raises(ValueError):          # the kernel takes CUDA tensors
        dec.kernel(torch.zeros((16200, B)))
    assert tl.ldpc_layered_fused_io_cuda.launches == 0


@pytest.mark.cuda
def test_k5_kernel_equals_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    for frame, rate, b in ((S, CodeRate.C1_2, 5), (N, CodeRate.C2_3, 128)):
        _, llr_t = _noisy(frame, rate, b, 1.6, seed=b)
        v = torch.from_numpy(llr_t).to("cuda")
        dec = tl.make_decoder_nb_fused_io(*P(frame, rate), iters=6, batch=b)
        assert torch.equal(dec.kernel(v), dec.plain(v))
