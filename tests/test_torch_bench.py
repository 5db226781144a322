"""The port's bench (sdr_receiver_dvb_t2_tpu_torch/bench.py) and its frame
synthesis (utils/benchgen.py) at the CI mode of tests/test_benchgen.py:
8K FFT, GI 1/32, PP1, 16QAM C1/2 SHORT, F=3 frames of NB=3 codewords.

Tolerances.  The shipped ingredients are integers and must equal the JAX
package's exactly.  The synthesised frames come from the same f32
products and an f32 inverse FFT of 8192 points, whose rounding differs
between the two FFT libraries: within 1e-5 of the frame rms.  Frame 0
matches the modulator within 2e-3 of its rms, the int16 coding of the
ingredients (as tests/test_benchgen.py has it).  Gates are exact: hashes,
BCH-clean counts and TS bytes.
"""
import inspect

import jax
import numpy as np
import pytest
import torch

import sdr_receiver_dvb_t2_tpu.dvbt2.l1 as jl1
from sdr_receiver_dvb_t2_tpu.dvbt2.params import (
    CodeRate, Constellation, FECFrame, FFTMode, GuardInterval, PilotPattern,
    PLPParams, T2Params)
from sdr_receiver_dvb_t2_tpu.ops import frontend_device as jfe
from sdr_receiver_dvb_t2_tpu.tx import fec as jtxfec
from sdr_receiver_dvb_t2_tpu.tx import ofdm as jtxofdm
from sdr_receiver_dvb_t2_tpu.tx.modulator import T2Modulator
from sdr_receiver_dvb_t2_tpu.utils import benchgen as jbg
from sdr_receiver_dvb_t2_tpu_torch import bench
from sdr_receiver_dvb_t2_tpu_torch.ops import frontend_device as tfe
from sdr_receiver_dvb_t2_tpu_torch.ops import ldpc_layered
from sdr_receiver_dvb_t2_tpu_torch.utils import benchgen as tbg
from sdr_receiver_dvb_t2_tpu_torch.utils.reference import from_reference as R

torch.set_num_threads(1)

F, NB = 3, 3


def _mode():
    p = T2Params(fft_mode=FFTMode.FFT_8K, guard=GuardInterval.GI_1_32,
                 pilot_pattern=PilotPattern.PP1, extended_carrier=False,
                 n_data=9)
    plp = PLPParams(constellation=Constellation.QAM16, rate=CodeRate.C1_2,
                    fec_frame=FECFrame.SHORT, num_blocks_max=NB,
                    time_il_length=1)
    return p, plp


def _ingredients():
    """tests/test_benchgen.py's set-up through the JAX package: the
    modulator's frame 0, the base codewords' cells, L1 and P1."""
    p, plp = _mode()
    rng = np.random.default_rng(77)
    mod = T2Modulator(p, [plp])
    ts = rng.integers(0, 256, (mod.packets_needed(1) + 4, 188)
                      ).astype(np.uint8)
    ts[:, 0] = 0x47
    probe = T2Modulator(p, [plp])
    probe.adapters[0].push_packets(ts.reshape(-1))
    bb0 = np.stack([probe.adapters[0].next_frame() for _ in range(NB)])
    out = mod.modulate(ts.reshape(-1), 1)
    l1_arr = np.concatenate([
        jl1.l1pre_encode(out.l1pre),
        jl1.l1post_encode(out.l1post_frames[0], mod.l1_post_mod)])
    cells0 = jtxfec.plp_encode(plp, bb0)
    return p, plp, out, l1_arr, cells0, jtxofdm.generate_p1(p)


def _synths():
    p, plp, out, l1_arr, cells0, p1 = _ingredients()
    maps = jbg.probe_maps(p, plp, l1_arr, cells0)
    cpf = cells0.shape[1]
    j_synth, j_ship = jbg.make_frame_synth(p, cpf, F, *maps, p1)
    t_synth, t_ship = tbg.make_frame_synth(R(p), cpf, F, *maps, p1, "cpu")
    return (p, out, maps, cpf, p1, (j_synth, j_ship), (t_synth, t_ship))


def test_probe_maps_is_the_jax_package_s():
    """A copy of the NumPy function, text and output (its asserts check
    the decomposition against the modulator)."""
    assert inspect.getsource(tbg.probe_maps) == \
        inspect.getsource(jbg.probe_maps)
    p, plp, _, l1_arr, cells0, _ = _ingredients()
    for a, b in zip(tbg.probe_maps(R(p), R(plp), l1_arr, cells0),
                    jbg.probe_maps(p, plp, l1_arr, cells0)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_ship_integers_equal_the_jax_package_s():
    *_, (_, j_ship), (_, t_ship) = _synths()
    assert sorted(t_ship) == sorted(j_ship)
    for k, v in j_ship.items():
        a = np.asarray(v)
        b = t_ship[k].numpy()
        assert b.dtype == a.dtype and b.shape == a.shape, k
        np.testing.assert_array_equal(b, a)
        assert t_ship[k].device.type == "cpu"


def test_synth_equals_jax_and_the_modulator():
    p, out, *_, (j_synth, j_ship), (t_synth, t_ship) = _synths()
    ref = np.asarray(jax.jit(j_synth)(j_ship))
    got = t_synth(t_ship).numpy()
    assert got.shape == ref.shape == (F, p.frame_samples)
    assert got.dtype == np.complex64
    rms = np.sqrt(np.mean(np.abs(ref) ** 2))
    assert np.abs(got - ref).max() / rms < 1e-5
    mod_rms = np.sqrt(np.mean(np.abs(out.samples) ** 2))
    assert np.abs(got[0] - out.samples).max() / mod_rms < 2e-3
    for a in range(F):
        for b in range(a + 1, F):
            assert np.abs(got[a] - got[b]).max() / rms > 0.1, (a, b)


def test_synth_refuses_more_frames_than_codewords():
    p, _, maps, cpf, p1, *_ = _synths()
    with pytest.raises(ValueError, match="FEC-block count"):
        tbg.make_frame_synth(R(p), cpf, NB + 1, *maps, p1, "cpu")


def test_frontend_raw_len_equals_jax():
    for n_samp in (94976, 2048 + 60 * 33024, 1, 12345):
        for sco in (0.0, 2e-5, 2.2e-5, -3e-5, 6.25e-3):
            for half in (4, 8):
                assert tfe.frontend_raw_len(n_samp, sco, half) == \
                    jfe.frontend_raw_len(n_samp, sco, half)


def _counting_plain(monkeypatch):
    calls = []
    inner = ldpc_layered.decode_plain

    def counted(*a, **k):
        calls.append(1)
        return inner(*a, **k)
    monkeypatch.setattr(ldpc_layered, "decode_plain", counted)
    return calls


RUNS = {
    "clean": dict(snr=0.0),
    "9dB-and-echo": dict(snr=9.0),
    "fixed-iters-no-impairments": dict(snr=9.0, fixed_iters=10,
                                       no_impairments=True),
}


@pytest.mark.parametrize("case", sorted(RUNS))
def test_bench_run_passes_every_gate_on_the_cpu(monkeypatch, case):
    """The bench end to end at the CI mode: F=3 distinct frames
    synthesised, impaired, tracking estimated, and every point's gates
    (3 hashes, 3 BCH-clean codewords per frame, the gate frame's TS)
    pass through the plain version of the decoder (K1's adaptive one, or
    the fixed one with fixed_iters); nothing is timed on the CPU."""
    kw = RUNS[case]
    p, plp = _mode()
    calls = _counting_plain(monkeypatch)
    fixed = []
    inner = ldpc_layered.decode_fixed_plain
    monkeypatch.setattr(ldpc_layered, "decode_fixed_plain",
                        lambda *a, **k: fixed.append(a[2]) or inner(*a, **k))
    ldpc_layered.ldpc_layered_cuda.launches = 0
    rec = bench.run(R(p), R(plp), frames=F, device="cpu", gate_frame=2,
                    log=lambda msg: None, **kw)
    labels = ["clean"] + (["9 dB", "10 dB", "9 dB echo 0.15@32"]
                          if kw["snr"] else [])
    assert list(rec["points"]) == labels
    for pt in rec["points"].values():
        assert pt["ok"] and pt["hashes_ok"] and pt["bch_ok"] and pt["ts_ok"]
        assert pt["bch_clean_min"] == NB and pt["ts_bytes"] > 0
        assert "ms_per_frame" not in pt
    if kw.get("fixed_iters"):
        assert calls == [] and fixed == [10] * (F * len(labels))
        assert all(pt["sweeps_per_frame"] == 10
                   for pt in rec["points"].values())
    else:
        assert len(calls) == F * len(labels) and fixed == []
    assert ldpc_layered.ldpc_layered_cuda.launches == 0
    if kw.get("no_impairments"):
        assert rec["tracking"] == "oracle" and not rec["impairments"]
    else:
        assert abs(rec["tracking"]["cfo_err_hz"]) < 5.0
    assert rec["device"]["platform"] == "cpu"
    assert "busy_clean" not in rec and "peak_memory_bytes" not in rec
    assert rec["metric"]["metric"] == "demod_32k_Msamples_per_s"
    assert rec["metric"]["value"] == 0.0       # nothing timed on the CPU


def test_gate_fails_on_frame_and_slot_permutations():
    """The same synthesised frames in another frame order, or frames
    synthesised from the codewords in another slot order (every codeword
    still BCH-clean), fail the hash gate."""
    p, plp = _mode()
    b = bench.Bench(R(p), R(plp), F, "cpu", torch.Generator().manual_seed(7),
                    torch.Generator().manual_seed(11), gate_frame=0,
                    log=lambda msg: None)
    frames = b.synth()
    assert b.gate(0.0, "as synthesised", frames=frames)["ok"]
    moved = b.gate(0.0, "frames rolled", frames=frames[[1, 2, 0]])
    assert not moved["hashes_ok"] and moved["bch_ok"]
    stream0, cellmap, overlay = b.maps
    reversed_slots = stream0.reshape(b.nb, b.cpf)[::-1].reshape(-1)
    synth, ship = tbg.make_frame_synth(R(p), b.cpf, F, reversed_slots,
                                       cellmap, overlay, b.p1, "cpu")
    swapped = b.gate(0.0, "slots reversed", frames=synth(ship))
    assert not swapped["hashes_ok"] and swapped["bch_ok"]


def test_bench_refuses_a_missing_card(monkeypatch):
    """The bench never carries on on the CPU when the card was asked
    for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p, plp = _mode()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run(R(p), R(plp), frames=F, device="cuda")
