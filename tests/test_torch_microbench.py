"""The port's microbenches and LDPC studies (sdr_receiver_dvb_t2_tpu_torch/
tools/) run on the CPU at tiny sizes, and their gates hold there.  Their
times mean nothing on the CPU (host clock, plain versions of the kernels);
what is tested is that each runs its whole path and checks what it says:

- demod_split_microbench (both FFT heads) and path_microbench: every
  prefix of the path runs, and the last equals `MultiFramePath`'s output
  bit for bit;
- demod_microbench: the complex division and the planar conjugate form of
  the equalizer agree (1e-5 of the peak);
- fec_tail_microbench: every codeword BCH-clean per frame and grouped,
  the two hashes equal;
- ldpc_microbench: K3's and K4's doors decode every codeword;
- hbm_vmem_equivalence: K4 (its plain version here) equals the f32
  layered reference bit for bit after correcting raw errors; `main`
  refuses to run without a card (exit 2);
- ldpc_iters_sweep, twophase_study, minsum_variant_study: run, and
  converge at a high SNR.
The same tools on the card are `cuda`-marked and skip here.
"""
import numpy as np
import pytest
import torch

from sdr_receiver_dvb_t2_tpu_torch.dvbt2.params import CodeRate, FECFrame
from sdr_receiver_dvb_t2_tpu_torch.tools import (
    demod_microbench, demod_split_microbench, fec_tail_microbench,
    hbm_vmem_equivalence, ldpc_iters_sweep, ldpc_microbench,
    minsum_variant_study, path_microbench, twophase_study)
from sdr_receiver_dvb_t2_tpu_torch.utils.reference import (
    params_from_reference as R)

from tests.test_sharding import tiny_mode

torch.set_num_threads(1)

S = FECFrame.SHORT
QUIET = dict(log=lambda *a: None)


@pytest.fixture(scope="module")
def tiny():
    p, plp = tiny_mode()
    return R(p), R(plp)


def test_demod_split_prefixes_end_at_the_path(tiny):
    p, plp = tiny
    out = demod_split_microbench.run(p, plp, 2, 2, reps=1, device="cpu",
                                     **QUIET)
    assert out["llr_equals_path"]
    for head in demod_split_microbench.HEADS:
        assert set(out[head]) == set(demod_split_microbench.STAGES)
        assert all(v > 0 for v in out[head].values())
    d = demod_split_microbench.deltas(out["cufft"])
    assert sum(d.values()) == pytest.approx(out["cufft"]["llr"])


def test_demod_split_takes_the_comp_first_route(tiny):
    """On a SISO mode the bench's class-ordered route indexes the raw FFT
    output: the carr prefix is the fft prefix itself (no carrier copy),
    and eq equalizes those full-width rows."""
    p, plp = tiny
    assert not p.miso
    mf = demod_split_microbench.fusedpath.MultiFramePath(p, plp, 2, 2)
    head = demod_split_microbench.head_fn("cufft", p.fft_size, mf.llr_dtype)
    gen = torch.Generator().manual_seed(1)
    sr, si = (torch.randn((2, p.len_frame, p.fft_size), generator=gen)
              for _ in range(2))
    fft = demod_split_microbench.prefix(mf, head, "fft")(sr, si, 1.0)
    carr = demod_split_microbench.prefix(mf, head, "carr")(sr, si, 1.0)
    assert carr[0].shape[0] == p.fft_size
    assert all(torch.equal(a, b) for a, b in zip(fft, carr))


def test_path_prefixes_end_at_the_path(tiny):
    p, plp = tiny
    out = path_microbench.run(p, plp, 2, 2, reps=1, device="cpu", **QUIET)
    assert out["llrs_equal_path"]
    assert all(out[s] > 0 for s in path_microbench.STAGES)


def test_demod_microbench_division_forms_agree(tiny):
    p, _ = tiny
    out = demod_microbench.run(p, 2, reps=1, device="cpu", **QUIET)
    assert all(out[m] > 0 for m in demod_microbench.MODES)
    assert out["div_rdiv_max_rel"] < 1e-5


def test_fec_tail_gates_hold():
    out = fec_tail_microbench.run(S, CodeRate.C1_2, frames=3, group=2,
                                  batch=4, reps=1, device="cpu", **QUIET)
    assert out["hash_equal"]
    assert out["bch_clean"] == {"tail_perframe": 12, "tail_batched": 12}
    assert out["decode"]["sweeps_per_frame"] >= 1


def test_ldpc_microbench_decodes_exactly():
    out = ldpc_microbench.run(frame=S, rate=CodeRate.C1_2, iters=3,
                              batch=4, reps=1, device="cpu", **QUIET)
    assert set(out) == {"vmem", "hbm"}
    assert all(v["decode_exact"] and v["ms"] > 0 for v in out.values())


def test_hbm_vmem_equivalence_gate_holds():
    recs = hbm_vmem_equivalence.run(
        cases=((S, CodeRate.C1_2, 8, 8), (S, CodeRate.C2_3, 4, 6)),
        device="cpu", **QUIET)
    for r in recs:
        assert r["raw_errors"] > 0 and r["corrected"]
        assert r["k4_equal"] and r["ok"]


def test_hbm_vmem_equivalence_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert hbm_vmem_equivalence.main([]) == 2


def test_ldpc_iters_sweep_converges_at_high_snr():
    rows = ldpc_iters_sweep.run(S, CodeRate.C2_3, batch=4,
                                snrs=(15.0, 26.0), iters=(1, 8),
                                device="cpu", **QUIET)
    assert [r["snr"] for r in rows] == [15.0, 26.0]
    assert rows[0]["it1"]["bit_errors"] > 0
    assert rows[1]["it8"] == {"bit_errors": 0, "failed_codewords": 0}


@pytest.mark.parametrize("study", ["schemes", "variants", "schedules"])
def test_twophase_study_runs(study):
    res = twophase_study.run(snr=24.0, blocks=4, max_iters=8, k1=(1,),
                             study=study, device="cpu", bsz=2, **QUIET)
    if study == "schemes":
        assert res["fails"] == 0 and 1 <= res["mean"] <= 8
        assert res["oracle_cost"] <= res["random_cost"]
        assert "A:k1=1" in res
    else:
        assert len(res) == (8 if study == "variants" else 6)
        shipped = "natural" if study == "schedules" else \
            "f32 shipped  off0.5"
        assert res[shipped]["fails"] == 0


def test_minsum_variant_study_converges():
    res = minsum_variant_study.run(
        snr=24.0, blocks=2, max_iters=8,
        variants=minsum_variant_study.VARIANTS[:3], device="cpu", **QUIET)
    assert all(v["fails"] == 0 for v in res.values())


@pytest.mark.cuda
def test_tools_on_card():
    """The headline-mode tools on the card (chip_smoke.py's phase_tools
    runs them with its own gates)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K2, K3, K4 and K6 run there)")
    assert hbm_vmem_equivalence.main([]) == 0
    assert ldpc_microbench.main(["--reps", "2"]) == 0
    assert fec_tail_microbench.main(["--frames", "16", "--reps", "1"]) == 0
    assert demod_split_microbench.main(["32", "--reps", "1"]) == 0
