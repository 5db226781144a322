"""The receiver's spans and counters (sdr_receiver_dvb_t2_tpu_torch/utils/
metrics.py `span`, `count`, `TRACER`): off, a superstep step records
nothing and opens no profiler range; on, its spans carry the names,
nesting and `step`/`frame` ids of `rx/superstep.py`, on the clock of
torch.profiler's exported trace, and the acquisition, the streaming
stages and the CLI's device trace record theirs.  The `cuda`-marked test
runs a step on the card, where neither side may make the host wait for
the device."""
import json
import os
import sys

import numpy as np
import pytest
import torch

from sdr_receiver_dvb_t2_tpu_torch.dvbt2.params import (
    CodeRate, Constellation, FECFrame, FFTMode, GuardInterval, PilotPattern,
    PLPParams, T2Params)
from sdr_receiver_dvb_t2_tpu_torch.rx import superstep as tss
from sdr_receiver_dvb_t2_tpu_torch.rx.receiver import T2Receiver
from sdr_receiver_dvb_t2_tpu_torch.utils import benchgen, metrics
from sdr_receiver_dvb_t2_tpu_torch.utils.metrics import (
    NULL_SPAN, TRACER, count, span)

torch.set_num_threads(1)

F, NB = 2, 3
STEP_SPANS = ["t2.step", "t2.frontend", "t2.demod_llr"] + [
    "t2.ldpc", "t2.fec_tail", "t2.fec_tail.bch", "t2.fec_tail.pack",
    "t2.fec_tail.hash"] * F


@pytest.fixture(autouse=True)
def tracer_off():
    """Every test starts and ends with the tracer off and empty."""
    TRACER.disable()
    TRACER.clear()
    yield
    TRACER.disable()
    TRACER.clear()


@pytest.fixture(scope="module")
def cell():
    """The 8K/16QAM SHORT mode, 2 frames of 3 blocks, impaired without
    noise, the tracking state its acquisition estimates, and a step."""
    p = T2Params(fft_mode=FFTMode.FFT_8K, guard=GuardInterval.GI_1_32,
                 pilot_pattern=PilotPattern.PP1, extended_carrier=False,
                 n_data=9)
    plp = PLPParams(constellation=Constellation.QAM16, rate=CodeRate.C1_2,
                    fec_frame=FECFrame.SHORT, num_blocks_max=NB,
                    time_il_length=1)
    _, frames, _ = benchgen.modulate(p, plp, F, seed=5)
    gen = torch.Generator().manual_seed(1)
    raw = benchgen.impaired(frames, 0.0, gen, "cpu")
    track, _ = benchgen.estimate_tracking(frames, 0.0, gen, "cpu")
    step = tss.Superstep(p, plp, NB, F, benchgen.FS,
                         tss.hash_weights(plp.fec.k_bch // 8, NB))
    return frames, raw, track, step


def _run(step, raw, track, marks=None):
    # 20 dB: the first syndrome check waits for sweep 8
    return step(raw[0], raw[1], 100.0, track, keep=(0,),
                mark=None if marks is None else marks.append)


def _profiled(fn, tmp_path):
    """Run fn() under torch.profiler -> (its result, the exported trace)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = os.path.join(tmp_path, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        return out, json.load(f)


def _ranges(trace, prefix="t2."):
    return [e for e in trace["traceEvents"]
            if e.get("cat") == "user_annotation"
            and str(e.get("name", "")).startswith(prefix)]


def test_off_span_is_the_shared_null_and_count_keeps_nothing():
    assert not TRACER.on
    assert span("t2.step", step=3) is NULL_SPAN
    assert span("t2.ldpc", frame=1) is NULL_SPAN
    with span("t2.fec_tail"):
        count("ldpc.codeword_sweeps", 5)
        count("ldpc.codeword_sweeps", torch.tensor(5))
    assert TRACER.dump() == {"clock": "unix_ns", "spans": [],
                             "counters": {}}
    # nothing is kept however often it is called
    before = sys.getallocatedblocks()
    for i in range(20000):
        with span("t2.ldpc", frame=i & 63):
            count("ldpc.codeword_sweeps", i)
    assert sys.getallocatedblocks() - before < 50


def test_on_without_a_profiler_records_spans_but_opens_no_range(
        monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a profiler range with no profiler")
    TRACER.enable()
    monkeypatch.setattr(TRACER, "_record_function", refuse)
    with span("t2.step", step=1):
        with span("t2.ldpc", frame=0):
            pass
    TRACER.disable()
    inner, outer = TRACER.dump()["spans"]
    assert (inner["name"], outer["name"]) == ("t2.ldpc", "t2.step")
    assert inner["parent"] == outer["id"] and outer["parent"] is None
    assert (inner["step"], inner["frame"], outer["step"]) == (1, 0, 1)
    assert outer["start_ns"] <= inner["start_ns"] <= inner["end_ns"] \
        <= outer["end_ns"]


def test_off_step_opens_no_range_and_records_nothing(cell, tmp_path,
                                                     monkeypatch):
    """With the tracer off a step makes no profiler range, no CUDA event
    and no span, and its stage marks keep their order."""
    _, raw, track, step = cell

    def refuse(*a, **k):
        raise AssertionError("created with the tracer off")
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(metrics, "_Span", refuse)
    marks = []
    (sums, oks, iters, _), trace = _profiled(
        lambda: _run(step, raw, track, marks), tmp_path)
    assert marks == ["frontend", "demod_llr"] + ["ldpc", "fec_tail"] * F
    assert oks.tolist() == [NB] * F and int(iters) == 8 * F
    assert _ranges(trace) == []
    assert TRACER.dump()["spans"] == [] and TRACER.counters() == {}


def test_on_step_spans_nest_with_ids_on_the_trace_clock(cell, tmp_path):
    _, raw, track, step = cell
    off = _run(step, raw, track)
    TRACER.enable()
    first = step.steps
    on, trace = _profiled(lambda: _run(step, raw, track), tmp_path)
    TRACER.disable()
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    spans = sorted(TRACER.dump()["spans"], key=lambda s: s["start_ns"])
    assert [s["name"] for s in spans] == STEP_SPANS
    by_id = {s["id"]: s for s in spans}
    root = spans[0]
    assert root["parent"] is None and root["step"] == first
    for s in spans[1:]:
        up = by_id[s["parent"]]
        assert s["step"] == first
        assert up["start_ns"] <= s["start_ns"] <= s["end_ns"] <= up["end_ns"]
        if s["name"].startswith("t2.fec_tail."):
            assert up["name"] == "t2.fec_tail"
        else:
            assert up is root
    frames = [(s["name"], s.get("frame")) for s in spans
              if s["name"] in ("t2.ldpc", "t2.fec_tail.hash")]
    assert frames == [("t2.ldpc", 0), ("t2.fec_tail.hash", 0),
                      ("t2.ldpc", 1), ("t2.fec_tail.hash", 1)]
    # each span begins less than 1 ms before the profiler's range of its
    # name: an event's ts (us) plus baseTimeNanoseconds is the Unix clock
    base = trace.get("baseTimeNanoseconds", 0)
    ranges = sorted(_ranges(trace), key=lambda e: e["ts"])
    assert [e["name"] for e in ranges] == STEP_SPANS
    for s, e in zip(spans, ranges):
        lead = base + e["ts"] * 1e3 - s["start_ns"]
        assert 0 <= lead < 1e6, (s["name"], lead)
    # the decoder's counters: 3 codewords x 8 sweeps per frame, no vote
    # before the floor, the first one clean; on the CPU no decode overlaps,
    # no LLR tail runs K7 and no front end runs K8
    assert TRACER.counters() == {"ldpc.codeword_sweeps": NB * 8 * F,
                                 "ldpc.clean_codeword_sweeps": 0,
                                 "ldpc.overlapped_decodes": 0,
                                 "demod.llr_kernel_frames": 0,
                                 "frontend.kernel_frames": 0}


def test_acquisition_records_one_span_and_its_rounds(cell):
    frames = cell[0]
    gen = torch.Generator().manual_seed(2)
    ar, ai = benchgen.impaired(frames[:2].reshape(1, -1), 0.0, gen, "cpu")
    x = (ar[0].numpy() + 1j * ai[0].numpy()).astype(np.complex64)
    TRACER.enable()
    ls, cfo, _, _ = T2Receiver(fs=benchgen.FS).refine_acquire(x - x.mean())
    TRACER.disable()
    assert ls is not None and abs(cfo - benchgen.CFO_HZ) < 5.0
    spans = TRACER.dump()["spans"]
    acq = [s for s in spans if s["name"] == "t2.acquire"]
    rounds = [s for s in spans if s["name"] == "t2.acquire.round"]
    scans = [s for s in spans if s["name"] == "t2.acquire.scan_mode"]
    assert len(acq) == 1 and acq[0]["parent"] is None
    assert 1 <= len(rounds) <= 4
    assert all(r["parent"] == acq[0]["id"] for r in rounds)
    assert len(scans) == len(rounds)
    assert {s["parent"] for s in scans} == {r["id"] for r in rounds}
    assert len(spans) == 1 + 2 * len(rounds)


def test_stage_timer_is_a_span_and_device_trace_writes_them(tmp_path):
    m = metrics.Metrics()
    with m.stage("decode", items=3):
        pass
    assert TRACER.dump()["spans"] == [] and m.stages["decode"].calls == 1
    logdir = str(tmp_path / "trace")
    with metrics.device_trace(logdir):
        assert TRACER.on
        with m.stage("decode", items=3):
            with m.stage("acquire"):
                count("ldpc.codeword_sweeps", torch.tensor(7))
    assert not TRACER.on and TRACER.dump()["spans"] == []
    with open(os.path.join(logdir, metrics.TRACE_FILE)) as f:
        out = json.load(f)
    assert out["clock"] == "unix_ns"
    assert out["counters"] == {"ldpc.codeword_sweeps": 7}
    names = {s["name"]: s for s in out["spans"]}
    assert set(names) == {"t2.decode", "t2.acquire"}
    assert names["t2.acquire"]["parent"] == names["t2.decode"]["id"]
    assert m.stages["decode"].calls == 2 and m.stages["decode"].items == 6


@pytest.mark.cuda
@pytest.mark.parametrize("on", [False, True])
def test_step_on_card_never_waits_for_the_device(cell, monkeypatch, on):
    """On the card a step makes the host wait for the device nowhere
    (torch's sync debug mode, "error"), with the tracer off or on (its
    counters stay on the card until `dump`); off, it also makes no CUDA
    event and no profiler range."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import warnings
    _, raw, track, step = cell
    rr, ri = (r.cuda() for r in raw)
    inv = torch.tensor(100.0, device="cuda")
    args = (rr, ri, inv, track.cuda())
    step(*args)                                   # builds and uploads
    torch.cuda.synchronize()
    if on:
        TRACER.enable()
    else:
        def refuse(*a, **k):
            raise AssertionError("created with the tracer off")
        monkeypatch.setattr(torch.autograd.profiler, "record_function",
                            refuse)
        monkeypatch.setattr(torch.cuda, "Event", refuse)
        monkeypatch.setattr(metrics, "_Span", refuse)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")          # the mode is a prototype
        torch.cuda.set_sync_debug_mode("error")
        try:
            _, oks, iters, _ = step(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    TRACER.disable()
    assert oks.tolist() == [NB] * F and int(iters) == 8 * F
    dump = TRACER.dump()
    assert len(dump["spans"]) == (len(STEP_SPANS) if on else 0)
    # on the card the step's LLR tail is K7 and its slice corrector K8,
    # each over its F frames
    assert dump["counters"] == ({"ldpc.codeword_sweeps": NB * 8 * F,
                                 "ldpc.clean_codeword_sweeps": 0,
                                 "ldpc.overlapped_decodes": 0,
                                 "demod.llr_kernel_frames": F,
                                 "frontend.kernel_frames": F}
                                if on else {})
