"""The port's tools against the JAX package, on the CPU.

- `tools/ber_validation`: `ber_table`'s data is the JAX tool's
  (`default_rng(0)`: codewords, then AWGN per sigma), and each of its four
  decoders gives the JAX decoder's bits on the same LLRs (tolerance 0) on
  SHORT C2/3 at B=8 and two sigmas, one where every word decodes and one
  past the threshold.  The JAX layered decoders run their Pallas kernels
  in interpret mode (SHORT codes only), the flooding decoder under XLA.
  JAX's `make_decoder_natural` and `make_decoder_nb(dtype=bf16)` build
  the same core here (K3, bf16 c2v: `make_core`'s choice, checked), so one
  interpret compile of it is the reference of both layered10_f32 and
  layered10_bf16 (each compile takes ~30 s on this host).
- `tools/distributed_bench`: two gloo ranks through `--_child` (the port
  of tests/test_distributed.py::test_two_process_fused_pipeline_bit_
  identical): each rank's bits equal the JAX single-device run on its own
  frames (MultiFramePath and the f32 flooding decoder at 8 iterations),
  and the all-reduced stats count both ranks' codewords.
- Both tools refuse `--device cuda` without a card.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdr_receiver_dvb_t2_tpu.dvbt2 import ldpc as ldpcmod
from sdr_receiver_dvb_t2_tpu.dvbt2.params import CodeRate, FECFrame
from sdr_receiver_dvb_t2_tpu.ops import ldpc as jldpc
from sdr_receiver_dvb_t2_tpu.ops import ldpc_pallas as qc
from sdr_receiver_dvb_t2_tpu.rx import fusedpath as jfp
from sdr_receiver_dvb_t2_tpu_torch.tools import ber_validation as ber
from sdr_receiver_dvb_t2_tpu_torch.tools import distributed_bench as dbench
from sdr_receiver_dvb_t2_tpu_torch.utils.reference import from_reference

torch.set_num_threads(1)

S, RATE, B = FECFrame.SHORT, CodeRate.C2_3, 8
SIGMAS = (0.6, 0.88)


@functools.lru_cache(maxsize=None)
def _jax_decoders():
    """The JAX tool's four decoders at SHORT C2/3, B=8 (fn(llr (B, N))
    -> bits (B, N))."""
    code = ldpcmod.get_code(S, RATE)
    assert qc.vmem_fit_bytes(S, RATE, B) <= qc._VMEM_BUDGET   # K3 for both
    natural = qc.make_decoder_natural(S, RATE, 10, B, interpret=True)
    flood = jldpc.make_decoder(code, iters=25, dtype="bfloat16")
    rev = qc.make_adaptive_decoder_nb_fused_io(
        S, RATE, max_iters=10, check_every=10, batch=B, dtype=jnp.bfloat16,
        layer_order="reversed", interpret=True)
    return {
        "layered10_f32": lambda x: np.asarray(natural(x)),
        "flood25_bf16": lambda x: np.asarray(flood(x)),
        "layered10_bf16": lambda x: np.asarray(natural(x)),
        "layered10_bf16_rev": lambda x: np.asarray(rev(x.T)[0]).T,
    }


def test_ber_inputs_are_the_jax_tool_s():
    code = ldpcmod.get_code(S, RATE)
    rng = np.random.default_rng(0)
    info = rng.integers(0, 2, (B, code.k)).astype(np.uint8)
    cw = ldpcmod.encode(code, info)
    tx = (1.0 - 2.0 * cw).astype(np.float32)
    cw_t, llrs = ber.ber_inputs(from_reference(S), from_reference(RATE), B,
                                SIGMAS)
    np.testing.assert_array_equal(cw_t, cw)
    for sigma, llr in zip(SIGMAS, llrs):
        ref = (2.0 / sigma**2) * (tx + sigma * rng.normal(
            0, 1.0, (B, code.n))).astype(np.float32)
        assert llr.dtype == np.float32
        np.testing.assert_array_equal(llr, ref)


def test_ber_table_decoders_equal_jax():
    frame, rate = from_reference(S), from_reference(RATE)
    cw, llrs = ber.ber_inputs(frame, rate, B, SIGMAS)
    mine = ber.decoders(frame, rate, B)
    ref = _jax_decoders()
    assert mine.keys() == ref.keys()
    rows = ber.ber_table(frame, rate, B, SIGMAS, "cpu")
    decoded = []
    for sigma, llr, row in zip(SIGMAS, llrs, rows):
        assert row["sigma"] == sigma and row.keys() - {"sigma"} == ref.keys()
        for name, dec in mine.items():
            bits = dec(torch.from_numpy(llr))
            assert bits.dtype == torch.uint8 and bits.shape == cw.shape
            np.testing.assert_array_equal(bits.numpy(),
                                          ref[name](jnp.asarray(llr)),
                                          err_msg=f"{name} at {sigma}")
            assert row[name] == (bits.numpy() != cw).mean()
        decoded.append((bits.numpy() == cw).all(axis=1).mean())
    # one point where every word decodes, one past the threshold
    assert decoded[0] == 1.0 and decoded[1] < 1.0


def _jax_mode():
    from sdr_receiver_dvb_t2_tpu.dvbt2.params import (
        Constellation, FFTMode, GuardInterval, PilotPattern, PLPParams,
        T2Params)
    p = T2Params(fft_mode=FFTMode.FFT_8K, guard=GuardInterval.GI_1_32,
                 pilot_pattern=PilotPattern.PP1, extended_carrier=False,
                 n_data=9)
    plp = PLPParams(constellation=Constellation.QAM16, rate=CodeRate.C1_2,
                    fec_frame=S, num_blocks_max=dbench.NUM_BLOCKS,
                    time_il_length=1)
    return p, plp


def test_distributed_bench_two_ranks_equal_jax(tmp_path):
    from sdr_receiver_dvb_t2_tpu_torch.utils.reference import \
        params_from_reference
    fpd, nb = 2, dbench.NUM_BLOCKS
    recs = dbench.run_cluster(2, fpd, reps=1, device="cpu",
                              out_dir=str(tmp_path), timeout=300)
    p, plp = _jax_mode()
    assert (params_from_reference(p), params_from_reference(plp)) \
        == dbench.mode()
    bodies = dbench.frame_bodies(*dbench.mode(), 2 * fpd)
    mf = jfp.MultiFramePath(p, plp, nb, fpd)
    dec = jldpc._build_decoder(ldpcmod.get_code(plp.fec_frame, plp.rate),
                               dbench.LDPC_ITERS, 0.5, jnp.float32)
    for rank, rec in enumerate(recs):
        assert rec["rank"] == rank and rec["step_ms"] > 0
        # the all-reduce crossed the process boundary: both ranks' words
        assert rec["stats"][1] == rec["expected_codewords"] == 2 * fpd * nb
        got = np.load(tmp_path / f"n2_rank{rank}.npz")
        local = bodies[rank * fpd:(rank + 1) * fpd]
        llrs = jnp.transpose(mf._fn(jnp.asarray(local),
                                    jnp.float32(dbench.INV_NVAR)), (2, 1, 0))
        ref = np.asarray(dec(llrs.reshape(fpd * nb, -1))).reshape(
            fpd, nb, -1)
        np.testing.assert_array_equal(got["bits"], ref)
        assert got["stats"][1] == 2 * fpd * nb
    total = sum(np.load(tmp_path / f"n2_rank{r}.npz")["bits"].sum(
        dtype=np.int64) for r in range(2))
    assert recs[0]["stats"][0] == recs[1]["stats"][0] == total


@pytest.mark.parametrize("main", [ber.main, dbench.main],
                         ids=["ber_validation", "distributed_bench"])
def test_tools_refuse_cuda_without_a_card(main, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        main(["--device", "cuda"])
