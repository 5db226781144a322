"""The adaptive LDPC decoder's exit votes as the tracer counts them
(sdr_receiver_dvb_t2_tpu_torch/ops/ldpc_layered.py): the codewords whose
own syndrome failed at each vote, and the two counters made from them,
"ldpc.codeword_sweeps" and "ldpc.clean_codeword_sweeps"
(`lockstep_counts`).  The plain version holds the definition on the CPU;
the kernel's counts (K1, both the resident launch and the launch per
chunk) are held to it on the card by the `cuda`-marked test."""
import numpy as np
import pytest
import torch

from sdr_receiver_dvb_t2_tpu_torch.dvbt2.params import CodeRate, FECFrame
from sdr_receiver_dvb_t2_tpu_torch.ops import ldpc_layered as tl
from sdr_receiver_dvb_t2_tpu_torch.utils import benchgen
from sdr_receiver_dvb_t2_tpu_torch.utils.metrics import TRACER

torch.set_num_threads(1)


def _llrs(frame, rate, b, amp, seed, noise=1.0):
    """(n, b) f32 LLRs of random codewords: amp * (1 - 2 bit) + noise."""
    cw = benchgen.codewords(frame, rate, b, seed)
    rng = np.random.default_rng(seed + 1)
    llr = amp * (1 - 2.0 * cw) + rng.normal(0, noise, cw.shape)
    return torch.from_numpy(np.ascontiguousarray(llr.T.astype(np.float32)))


def _held_batch():
    """SHORT C1/2, B=4: three codewords clean at any vote (LLR 8 of the
    right sign) and one of pure noise, below threshold at every vote."""
    v = _llrs(FECFrame.SHORT, CodeRate.C1_2, 4, 8.0, seed=3, noise=0.0)
    v[:, 2] = torch.from_numpy(np.random.default_rng(9).normal(
        0, 0.5, v.shape[0]).astype(np.float32))
    return v


@pytest.mark.parametrize("check_every,min_it,max_iters,failing,clean", [
    # votes after sweeps 1..5; none before the floor of 3; the held
    # codeword fails at 3, 4, 5; three clean codewords run sweeps 4 and 5
    (1, 3, 5, [0, 0, 1, 1, 1], 3 * 2),
    # votes after sweeps 2, 4, 6, each with the held one failing: three
    # clean codewords run two chunks of 2 sweeps after the first two votes
    (2, 0, 6, [1, 1, 1], 3 * 2 * 2),
])
def test_plain_lockstep_counts_exact(check_every, min_it, max_iters, failing,
                                     clean):
    dec = tl.make_adaptive_decoder_nb_fused_io(
        FECFrame.SHORT, CodeRate.C1_2, max_iters=max_iters,
        check_every=check_every, layer_order="reversed")
    bits, iters, votes, lockstep = dec.plain_votes(_held_batch(), min_it)
    assert int(iters) == max_iters
    assert votes.tolist() == failing
    assert lockstep.tolist() == [4 * max_iters, clean]
    # the three clean codewords decode to their codewords; the counters
    # go to the tracer only while it is on
    cw = benchgen.codewords(FECFrame.SHORT, CodeRate.C1_2, 4, 3)
    np.testing.assert_array_equal(bits.numpy().T[[0, 1, 3]], cw[[0, 1, 3]])
    assert TRACER.counters() == {}
    TRACER.enable()
    try:
        dec.plain(_held_batch(), min_it)
        assert TRACER.counters() == {
            "ldpc.codeword_sweeps": 4 * max_iters,
            "ldpc.clean_codeword_sweeps": clean}
    finally:
        TRACER.disable()
        TRACER.clear()


def test_converged_batch_wastes_nothing():
    """Every codeword clean at the first vote: one vote, no sweep after."""
    dec = tl.make_adaptive_decoder_nb_fused_io(
        FECFrame.SHORT, CodeRate.C1_2, max_iters=24, check_every=1)
    v = _llrs(FECFrame.SHORT, CodeRate.C1_2, 3, 8.0, seed=4, noise=0.0)
    _, iters, votes, lockstep = dec.plain_votes(v, 0)
    assert int(iters) == 1 and votes.tolist() == [0] * 24
    assert lockstep.tolist() == [3, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("b", [128, 202])
def test_kernel_votes_equal_plain_on_card(b):
    """K1 at NORMAL C2/3 with the superstep's schedule (check after every
    sweep from sweep 8, reversed layers) on noisy codewords that take
    about as many sweeps as the 19 dB cell: B=128 runs the resident
    launch, B=202 the launch per chunk.  Bits, sweeps, every vote's
    failing codewords and the kernel's lockstep counters equal the plain
    version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    dec = tl.make_adaptive_decoder_nb_fused_io(
        FECFrame.NORMAL, CodeRate.C2_3, max_iters=24, check_every=1,
        batch=b, layer_order="reversed")
    v = _llrs(FECFrame.NORMAL, CodeRate.C2_3, b, 1.7, seed=b).to(
        "cuda", torch.bfloat16)
    kb, kit, kf, kl = dec.kernel_votes(v, 8)
    pb, pit, pf, pl = dec.plain_votes(v, 8)
    print(f"B={b}: {int(kit)} sweeps, failing per vote {kf.tolist()}, "
          f"lockstep {kl.tolist()}")
    assert int(kit) == int(pit) > 8
    assert kf.tolist() == pf.tolist()
    assert int(kf[7]) > 0
    assert kl.tolist() == pl.tolist()
    assert kl[1] > 0
    assert torch.equal(kb, pb)
    # while tracing, the decoder adds the kernel's counters
    TRACER.enable()
    try:
        dec.kernel(v, 8)
        assert TRACER.counters() == {
            "ldpc.codeword_sweeps": int(kl[0]),
            "ldpc.clean_codeword_sweeps": int(kl[1])}
    finally:
        TRACER.disable()
        TRACER.clear()
