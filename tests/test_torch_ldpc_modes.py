"""The port's decoders K2, K3 and K4 (sdr_receiver_dvb_t2_tpu_torch/ops/
ldpc_layered.py) against the JAX package on SHORT codes at B=8.

- K2 plain vs `make_adaptive_decoder_nb_fused(interpret=True)` (the TPU
  kernel in interpret mode): reversed and natural order, the `min_iters`
  floor, the traced floor and a ragged no-convergence case;
- K3 plain vs `make_decoder_nb(variant="vmem", interpret=True)`;
- K4 plain vs `build_layered_decoder` (f32 c2v, several sweeps) and vs
  `make_pallas_layered(interpret=True)` for one sweep (its interpret mode
  ignores the c2v aliasing, so only the first sweep is the kernel's);
- K4's argmin leave-one-out against the no-argmin form on inputs with
  ties;
- `vmem_fit_bytes` and `make_core`'s K3/K4 choice against JAX's rule for
  every code.

Bits and sweep counts must be equal (integers: tolerance 0).  The CUDA
kernels run only on the card: their test is marked `cuda`, and
chip_smoke.py holds them against these plain versions there."""
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
from sdr_receiver_dvb_t2_tpu_torch.tools import ldpc_layer_bench
from sdr_receiver_dvb_t2_tpu_torch.utils.reference import from_reference as P_

torch.set_num_threads(1)


def P(*values):
    """The JAX package's enums -> the port's own (by name)."""
    return P_(values)


S, N = FECFrame.SHORT, FECFrame.NORMAL
B = 8


def _noisy(frame, rate, b, amp, seed):
    rng = np.random.default_rng(seed)
    code = ldpcmod.get_code(frame, rate)
    cw = ldpcmod.encode(code, rng.integers(0, 2, (b, code.k)
                                           ).astype(np.uint8))
    llr = (amp * (1 - 2.0 * cw) + rng.normal(0, 1.0, cw.shape)
           ).astype(np.float32)
    return cw, np.ascontiguousarray(llr.T)


@functools.lru_cache(maxsize=None)
def _jax_k2(rate, max_iters, check_every, min_iters, order):
    return qc.make_adaptive_decoder_nb_fused(
        S, rate, max_iters=max_iters, check_every=check_every, batch=B,
        interpret=True, min_iters=min_iters, layer_order=order)


# (rate, LLR amplitude, layer order, check_every, min_iters, traced floor
#  min_it, max_iters); cases that share the last five share one compile
K2_CASES = {
    "reversed": (CodeRate.C1_2, 2.0, "reversed", 2, 0, 0, 12),
    "reversed-traced-floor": (CodeRate.C1_2, 2.5, "reversed", 2, 0, 5, 12),
    "natural": (CodeRate.C1_2, 2.0, None, 2, 0, 0, 12),
    "min_iters-floor": (CodeRate.C1_2, 2.5, "reversed", 2, 6, 0, 12),
    # 3 chunks of 2 sweeps run; the count reports max_iters = 5
    "no-convergence-ragged": (CodeRate.C1_2, 0.3, "reversed", 2, 0, 0, 5),
}


@pytest.mark.parametrize("case", sorted(K2_CASES))
def test_k2_plain_equals_jax_kernel(case):
    rate, amp, order, ce, min_iters, min_it, max_iters = K2_CASES[case]
    cw, llr_t = _noisy(S, rate, B, amp, seed=len(case))
    ref_bits, ref_it = _jax_k2(rate, max_iters, ce, min_iters, order)(
        jnp.asarray(llr_t), min_it)
    dec = tl.make_adaptive_decoder_nb_fused(*P(S, rate),
        max_iters=max_iters, check_every=ce, batch=B,
        min_iters=min_iters, layer_order=order)
    bits, it = dec(torch.from_numpy(llr_t), min_it)
    assert it.dtype == torch.int32 and int(it) == int(ref_it)
    assert bits.dtype == torch.uint8
    np.testing.assert_array_equal(bits.numpy(), np.asarray(ref_bits))
    if "no-convergence" in case:
        assert int(ref_it) == max_iters
    else:
        assert max(min_it, min_iters) <= int(ref_it) < max_iters
        np.testing.assert_array_equal(bits.numpy().T, cw)


def test_k2_takes_f32_llrs_unrounded():
    """K2 stages f32 totals: an LLR that bf16 would round changes K2's
    input and not K1's."""
    dec2 = tl.make_adaptive_decoder_nb_fused(*P(S, CodeRate.C1_2))
    dec1 = tl.make_adaptive_decoder_nb_fused_io(*P(S, CodeRate.C1_2))
    x = torch.full((16200, 2), 1.001)
    assert dec2._input(x).dtype == torch.float32
    assert torch.equal(dec2._input(x), x)
    assert not torch.equal(dec1._input(x).float(), x)


@pytest.mark.parametrize("rate,amp", [(CodeRate.C1_2, 1.4),
                                      (CodeRate.C3_4, 1.9)], ids=str)
def test_k3_plain_equals_jax_kernel(rate, amp):
    # a noise level where some codewords are still wrong after 6 sweeps
    cw, llr_t = _noisy(S, rate, B, amp, seed=11)
    ref = qc.make_decoder_nb(S, rate, iters=6, batch=B, interpret=True,
                             variant="vmem")(jnp.asarray(llr_t))
    dec = tl.make_decoder_nb(*P(S, rate), iters=6, batch=B, variant="vmem")
    assert dec.core == tl.LayeredCore("vmem", 6)
    assert dec.core.c2v_dtype == torch.bfloat16
    bits = dec(torch.from_numpy(llr_t))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(ref))
    assert (bits.numpy().T != cw).any()      # a discriminating input


def _jax_totals_bits(rate, ti, tp):
    tab = qc.qc_tables(S, rate)
    return np.asarray(qc.qc_to_bits_nb_jnp(tab, ti, tp))


@pytest.mark.parametrize("rate,iters", [(CodeRate.C1_2, 5),
                                        (CodeRate.C3_5, 4)], ids=str)
def test_k4_plain_equals_xla_layered_decoder(rate, iters):
    _, llr_t = _noisy(S, rate, B, 1.3, seed=iters)
    tab = qc.qc_tables(S, rate)
    ti, tp = qc.llrs_nb_to_qc_jnp(tab, jnp.asarray(llr_t))
    ti2, tp2 = qc.build_layered_decoder(S, rate, iters=iters)(ti, tp)
    dec = tl.make_decoder_nb(*P(S, rate), iters=iters, batch=B, variant="hbm")
    assert dec.core == tl.LayeredCore("hbm", iters)
    assert dec.core.c2v_dtype == torch.float32
    bits = dec(torch.from_numpy(llr_t))
    np.testing.assert_array_equal(bits.numpy(),
                                  _jax_totals_bits(rate, ti2, tp2))
    # the totals themselves, not only their signs
    pti, ptp = tl._stage_nb(tab, torch.from_numpy(llr_t))
    c2v = torch.zeros((tab.q, tab.degmax + 2, 360, B))
    for _ in range(iters):
        tl.layered_sweep_hbm(tab, pti, ptp, c2v)
    np.testing.assert_array_equal(pti.numpy(), np.asarray(ti2))
    np.testing.assert_array_equal(ptp.numpy(), np.asarray(tp2))


def test_k4_plain_first_sweep_equals_jax_kernel():
    rate = CodeRate.C1_2
    _, llr_t = _noisy(S, rate, B, 1.3, seed=3)
    tab = qc.qc_tables(S, rate)
    ti, tp = qc.llrs_nb_to_qc_jnp(tab, jnp.asarray(llr_t))
    ti2, tp2 = qc.make_pallas_layered(S, rate, iters=1, batch=B,
                                      interpret=True)(ti, tp)
    bits = tl.make_decoder_nb(*P(S, rate), iters=1, batch=B, variant="hbm")(
        torch.from_numpy(llr_t))
    np.testing.assert_array_equal(bits.numpy(),
                                  _jax_totals_bits(rate, ti2, tp2))


def test_k4_argmin_equals_no_argmin_form_with_ties():
    """K4 gives the leave-one-out min2 to the argmin of the strict-< scan;
    K1-K3 give it to every edge with |m| == min1.  With ties min2 == min1,
    so both forms must give the same totals: checked on LLRs on a 0.5 grid
    (with offset 0.5 every message stays on it, so ties are common)."""
    rate = CodeRate.C1_2
    tab = tl.qc_tables(*P(S, rate))
    rng = np.random.default_rng(4)
    llr = torch.from_numpy((np.round(rng.normal(1.0, 1.5, (tab.n, B)) * 2)
                            / 2).astype(np.float32))
    ti_a, tp_a = tl._stage_nb(tab, llr)
    ti_b, tp_b = ti_a.clone(), tp_a.clone()
    # ties among the first layer's messages exist
    deg = int(tab.layer_deg[0])
    mags = torch.stack([torch.roll(ti_a[int(tab.entry_g[0, j])],
                                   int(tab.entry_s[0, j]), 0).abs()
                        for j in range(deg)])
    assert int(((mags == mags.min(0).values).sum(0) > 1).sum()) > 100
    c2v_a = torch.zeros((tab.q, tab.degmax + 2, 360, B))
    c2v_b = torch.zeros_like(c2v_a)
    for _ in range(4):
        tl.layered_sweep_hbm(tab, ti_a, tp_a, c2v_a)
        tl.layered_sweep(tab, list(range(tab.q)), ti_b, tp_b, c2v_b,
                         c2v_dtype=torch.float32)
    assert torch.equal(ti_a, ti_b) and torch.equal(tp_a, tp_b)


@pytest.mark.parametrize("frame,rate", sorted(_TABLE_KEY, key=str))
def test_vmem_fit_and_core_choice_equal_jax(frame, rate):
    for batch in (8, 128):
        fit = tl.vmem_fit_bytes(*P(frame, rate), batch)
        assert fit == qc.vmem_fit_bytes(frame, rate, batch)
        want = "vmem" if fit <= qc._VMEM_BUDGET else "hbm"
        core = tl.make_core(*P(frame, rate), 10, batch)
        assert core.variant == want
        assert core.c2v_dtype == (torch.bfloat16 if want == "vmem"
                                  else torch.float32)
    assert tl._VMEM_BUDGET == qc._VMEM_BUDGET
    # NORMAL C3/5 at B=128 is the one code that takes K4
    assert (tl.make_core(*P(frame, rate), 10, 128).variant == "hbm") == (
        (frame, rate) == (N, CodeRate.C3_5))


def test_kernel_wrappers_refuse_cpu_tensors():
    v = torch.zeros((16200, 2))
    with pytest.raises(ValueError):
        tl.make_adaptive_decoder_nb_fused(*P(S, CodeRate.C1_2)).kernel(v)
    for variant in ("vmem", "hbm"):
        with pytest.raises(ValueError):
            tl.make_decoder_nb(*P(S, CodeRate.C1_2), 4, 2,
                               variant=variant).kernel(v)


@pytest.mark.cuda
def test_k2_k3_k4_kernels_equal_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    for frame, rate, b in ((S, CodeRate.C1_2, 5), (N, CodeRate.C2_3, 128)):
        _, llr_t = _noisy(frame, rate, b, 1.6, seed=b)
        v = torch.from_numpy(llr_t).to("cuda")
        k2 = tl.make_adaptive_decoder_nb_fused(
            *P(frame, rate), max_iters=24, check_every=2,
            layer_order="reversed")
        kb, kit = k2.kernel(v, 0)
        pb, pit = k2.plain(v, 0)
        assert int(kit) == int(pit) and torch.equal(kb, pb)
        for variant in ("vmem", "hbm"):
            dec = tl.make_decoder_nb(*P(frame, rate), 6, b, variant=variant)
            assert torch.equal(dec.kernel(v), dec.plain(v))


@pytest.mark.cuda
def test_all_codes_kernels_equal_plain_on_card():
    """Every code at B=8: both exits, K4's body, the permuted orders."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    records = ldpc_layer_bench.check_all_codes(log=lambda _: None)
    assert len({r["code"] for r in records}) == 13
    assert all(r["max_abs_err"] == 0 for r in records)
