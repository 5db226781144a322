"""The port's device FEC tail (sdr_receiver_dvb_t2_tpu_torch/ops/
fec_device.py) against the JAX package's: BCH gate and BB bytes are
integers and must be equal exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdr_receiver_dvb_t2_tpu.dvbt2 import bch
from sdr_receiver_dvb_t2_tpu.dvbt2.params import CodeRate, FECFrame, fec_params
from sdr_receiver_dvb_t2_tpu.ops import fec_device as jfec
from sdr_receiver_dvb_t2_tpu_torch.ops import fec_device as tfec
from sdr_receiver_dvb_t2_tpu_torch.utils.reference import from_reference as P_

torch.set_num_threads(1)


def P(*values):
    """The JAX package's enums -> the port's own (by name)."""
    return P_(values)


CODES = [(FECFrame.SHORT, CodeRate.C1_2), (FECFrame.NORMAL, CodeRate.C2_3)]


def _codewords(frame, rate, b, seed):
    """(n_bch, B) BCH codewords; odd columns carry 1..3 bit errors."""
    rng = np.random.default_rng(seed)
    fec = fec_params(frame, rate)
    cw = bch.encode(frame, rng.integers(0, 2, (b, fec.k_bch)
                                        ).astype(np.uint8), fec.t_bch)
    for j in range(1, b, 2):
        cw[j, rng.choice(fec.n_bch, 1 + j % 3, replace=False)] ^= 1
    return np.ascontiguousarray(cw.T)


@pytest.mark.parametrize("frame,rate", CODES)
def test_bch_check_equals_jax(frame, rate):
    bits = _codewords(frame, rate, 6, seed=1)
    ref = np.asarray(jfec.make_bch_check_nb(frame, rate)(jnp.asarray(bits)))
    got = tfec.make_bch_check_nb(*P(frame, rate))(torch.from_numpy(bits))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(ref, np.arange(6) % 2 == 0)


@pytest.mark.parametrize("frame,rate", CODES)
def test_bb_bytes_equal_jax(frame, rate):
    rng = np.random.default_rng(2)
    n = fec_params(frame, rate).n_ldpc
    bits = rng.integers(0, 2, (n, 5)).astype(np.uint8)
    ref = np.asarray(jfec.make_bb_bytes_nb(frame, rate)(jnp.asarray(bits)))
    got = tfec.make_bb_bytes_nb(*P(frame, rate))(torch.from_numpy(bits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
