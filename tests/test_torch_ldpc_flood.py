"""The port's flooding decoder (sdr_receiver_dvb_t2_tpu_torch/ops/ldpc.py)
against the JAX package's `ops/ldpc.make_decoder` on SHORT codes.

The receivers run it (in bf16, as the JAX receivers ask of the JAX
decoder) for every batch that is not a multiple of 128 codewords; `t2rx
--flood-ldpc`, the sharded step and `entry()` run it in f32 (the JAX
default).  In both dtypes the hard bits must be equal (tolerance 0).  Inputs sit at a
noise level where some codewords are still wrong after the last
iteration, so the comparison covers undecoded words too."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdr_receiver_dvb_t2_tpu.dvbt2 import ldpc as ldpcmod
from sdr_receiver_dvb_t2_tpu.dvbt2.params import CodeRate, FECFrame
from sdr_receiver_dvb_t2_tpu.ops import ldpc as jldpc
from sdr_receiver_dvb_t2_tpu_torch.ops import ldpc as tldpc
from sdr_receiver_dvb_t2_tpu_torch.utils.reference import from_reference as P_

torch.set_num_threads(1)


def P(*values):
    """The JAX package's enums -> the port's own (by name)."""
    return P_(values)


S = FECFrame.SHORT
B = 5


def _noisy(rate, amp, seed):
    rng = np.random.default_rng(seed)
    code = ldpcmod.get_code(S, rate)
    cw = ldpcmod.encode(code, rng.integers(0, 2, (B, code.k)
                                           ).astype(np.uint8))
    llr = (amp * (1 - 2.0 * cw) + rng.normal(0, 1.0, cw.shape)
           ).astype(np.float32)
    return code, cw, llr


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("rate,amp,iters", [
    (CodeRate.C1_2, 1.3, 24),
    (CodeRate.C3_4, 1.8, 24),
    (CodeRate.C1_2, 1.6, 8),
], ids=str)
def test_flood_bits_equal_jax(rate, amp, iters, dtype):
    code, cw, llr = _noisy(rate, amp, seed=iters)
    ref = np.asarray(jldpc.make_decoder(code, iters=iters, dtype=dtype)(
        jnp.asarray(llr)))
    dec = tldpc.make_decoder(*P(S, rate), iters=iters,
                             dtype=getattr(torch, dtype))
    bits = dec(torch.from_numpy(llr))
    assert bits.dtype == torch.uint8 and bits.shape == (B, code.n)
    np.testing.assert_array_equal(bits.numpy(), ref)
    # a discriminating input: some words decode, and not all of them do
    ok = (bits.numpy() == cw).all(axis=1)
    assert ok.any() and not ok.all()


def test_flood_bf16_input_cast_once():
    """f32 LLRs enter in the message dtype: the same bits whether the
    caller casts to bf16 first or not (what the batched receiver path
    passes)."""
    _, _, llr = _noisy(CodeRate.C1_2, 1.6, seed=3)
    dec = tldpc.make_decoder(*P(S, CodeRate.C1_2), iters=6)
    x = torch.from_numpy(llr)
    assert torch.equal(dec(x), dec(x.bfloat16()))


def test_vn_adjacency_equals_jax():
    for rate in (CodeRate.C1_2, CodeRate.C3_4):
        np.testing.assert_array_equal(tldpc._vn_adjacency(*P(S, rate)),
                                      jldpc._vn_adjacency((S, rate)))


def test_make_decoder_is_cached_per_code():
    assert tldpc.make_decoder(*P(S, CodeRate.C1_2), iters=4) is \
        tldpc.make_decoder(*P(S, CodeRate.C1_2), iters=4)
    f32 = tldpc.make_decoder(*P(S, CodeRate.C1_2), iters=4,
                             dtype=torch.float32)
    assert f32 is not tldpc.make_decoder(*P(S, CodeRate.C1_2), iters=4)
    assert f32.dtype == torch.float32
    with pytest.raises(ValueError):
        tldpc.make_decoder(*P(S, CodeRate.C1_2), iters=4,
                           dtype=torch.float16)
