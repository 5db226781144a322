"""The superstep's overlapped decodes (sdr_receiver_dvb_t2_tpu_torch/rx/
superstep.py, `ops/ldpc_layered.decodes_overlap`): where one frame's
decode needs more CTAs than the card holds at once, the frames' decodes
and FEC tails run on side streams in turn.  The rule is a pure function
of the batch and the card's resident CTAs, never engaged on the CPU; the
CPU step keeps its one-stream loop and its outputs.  The `cuda`-marked
test holds the overlapped step at the UK HD mode (202 blocks on 132 SMs)
to the same frames decoded and tailed one after another on the default
stream, bit for bit.  The kept bytes are uint8 (the pack's int32 values),
one row per entry of `keep`, in its order."""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from sdr_receiver_dvb_t2_tpu_torch.dvbt2.params import (
    CodeRate, Constellation, FECFrame, FFTMode, GuardInterval, PilotPattern,
    PLPParams, T2Params)
from sdr_receiver_dvb_t2_tpu_torch.ops import ldpc_layered as tl
from sdr_receiver_dvb_t2_tpu_torch.rx import superstep as tss
from sdr_receiver_dvb_t2_tpu_torch.utils import benchgen
from sdr_receiver_dvb_t2_tpu_torch.utils.metrics import TRACER

torch.set_num_threads(1)

# an H100 SXM's SMs, threads and shared memory per SM
H100 = SimpleNamespace(multi_processor_count=132,
                       max_threads_per_multi_processor=2048,
                       shared_memory_per_multiprocessor=233472)


@pytest.fixture(autouse=True)
def tracer_off():
    TRACER.disable()
    TRACER.clear()
    yield
    TRACER.disable()
    TRACER.clear()


@pytest.mark.parametrize("batch,resident,engaged", [
    (202, 132, True), (133, 132, True), (132, 132, False),
    (128, 132, False)])
def test_overlap_rule_is_the_batch_above_the_resident_ctas(batch, resident,
                                                           engaged):
    assert tl.overlaps(batch, resident) is engaged


def test_cpu_tensors_never_overlap():
    tab = tl.qc_tables(FECFrame.NORMAL, CodeRate.C2_3)
    assert not tl.decodes_overlap(tab, 202, "cpu")
    assert not tl.decodes_overlap(tab, 10_000, torch.device("cpu"))


def test_resident_ctas_on_an_h100_is_one_per_sm(monkeypatch):
    """At NORMAL C2/3 a CTA's tables and info totals fill an SM's shared
    memory: the H100 holds 132 CTAs, so the UK HD mode's 202 blocks
    overlap and the headline mode's 128 do not."""
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: H100)
    tab = tl.qc_tables(FECFrame.NORMAL, CodeRate.C2_3)
    assert tl.resident_ctas(tab, "cuda") == 132
    assert tl.decodes_overlap(tab, 202, "cuda")
    assert not tl.decodes_overlap(tab, 128, "cuda:0")
    # a SHORT code's CTA leaves room: the threads then bound an SM
    short = tl.qc_tables(FECFrame.SHORT, CodeRate.C2_3)
    assert tl.resident_ctas(short, "cuda") == 132 * (2048 // tl.THREADS)


def _sequential(step, raw, inv, track, keep):
    """The step's frames decoded and tailed one after another on the
    current stream through the step's own pieces -> (hashes, BCH-clean
    counts, total sweeps, kept bytes), as `Superstep.__call__` returns
    them."""
    (sr, si), _, _ = step.frontend(raw[0], raw[1], *track)
    llrs = step.mf.syms(sr, si, inv)                       # (N, B, F)
    min_it = torch.where(inv >= tss.FLOOR_INV_NVAR, 0,
                         tss.FLOOR_SWEEPS).to(torch.int32)
    wb = step.weights.on(llrs.device)
    sums, oks, iters, kept = [], [], 0, []
    for f in range(step.n_frames):
        bits, it = step.decode(llrs[:, :, f].contiguous(), min_it)
        oks.append(int(step.bch_check(bits[:step.plp.fec.n_bch]).sum()))
        byts = step.bb_pack(bits)
        sums.append(tss._wrap_i32((byts.long()[None] * wb).sum((1, 2))))
        iters += int(it)
        kept.append(byts)
    return (torch.stack(sums), oks, iters,
            torch.stack(kept)[list(keep)])


def _assert_same(got, ref):
    """The step's outputs equal the frames one after another; its kept
    bytes are uint8, equal by value to the pack's int32."""
    sums, oks, iters, kept = got
    r_sums, r_oks, r_iters, r_kept = ref
    assert torch.equal(sums.cpu(), r_sums.cpu())
    assert oks.tolist() == r_oks
    assert int(iters) == r_iters
    assert r_kept.dtype == torch.int32
    assert kept.dtype == torch.uint8 and kept.shape == r_kept.shape
    assert torch.equal(kept.cpu().to(torch.int32), r_kept.cpu())


def _small_step(f=2):
    """An f-frame step of 3 SHORT blocks at 8K on the CPU, its impaired
    capture and tracking state."""
    nb = 3
    p = T2Params(fft_mode=FFTMode.FFT_8K, guard=GuardInterval.GI_1_32,
                 pilot_pattern=PilotPattern.PP1, extended_carrier=False,
                 n_data=9)
    plp = PLPParams(constellation=Constellation.QAM16, rate=CodeRate.C1_2,
                    fec_frame=FECFrame.SHORT, num_blocks_max=nb,
                    time_il_length=1)
    _, frames, _ = benchgen.modulate(p, plp, f, seed=5)
    raw = benchgen.impaired(frames, 0.0, torch.Generator().manual_seed(1),
                            "cpu")
    track = torch.tensor([benchgen.CFO_HZ, 1 + benchgen.SCO,
                          tss.HALF * (1 + benchgen.SCO), benchgen.PHASE0])
    step = tss.Superstep(p, plp, nb, f, benchgen.FS,
                         tss.hash_weights(plp.fec.k_bch // 8, nb))
    return step, raw, track


def test_cpu_step_keeps_one_stream_and_its_outputs():
    """On the CPU the step takes no side stream, its outputs are the
    frames decoded one after another, and its counter reads 0."""
    step, raw, track = _small_step()
    f, nb = step.n_frames, step.num_blocks
    inv = torch.tensor(100.0)                     # 20 dB: floor at 8
    TRACER.enable()
    got = step(raw[0], raw[1], inv, track, keep=(0, 1))
    TRACER.disable()
    assert step._side_streams(torch.device("cpu")) == ()
    assert TRACER.counters()["ldpc.overlapped_decodes"] == 0
    ref = _sequential(step, raw, inv, track, keep=(0, 1))
    _assert_same(got, ref)
    assert got[1].tolist() == [nb] * f and int(got[2]) == 8 * f


@pytest.fixture(scope="module")
def three_frames():
    """A 3-frame CPU step at 20 dB, and its frames decoded one after
    another with every frame's int32 bytes kept."""
    step, raw, track = _small_step(3)
    inv = torch.tensor(100.0)
    return step, raw, track, inv, _sequential(step, raw, inv, track,
                                              keep=range(3))


@pytest.mark.parametrize("keep", [(0, 1, 2), (2, 0), ()],
                         ids=["all", "subset_out_of_order", "none"])
def test_kept_bytes_are_uint8_rows_in_keep_order(three_frames, keep):
    """Row r of the kept bytes is frame keep[r]'s pack, as uint8, and
    every frame's hash is `expected_hash` of its bytes."""
    step, raw, track, inv, ref = three_frames
    got = step(raw[0], raw[1], inv, track, keep=keep)
    assert got[3].shape == (len(keep), step.plp.fec.k_bch // 8,
                            step.num_blocks)
    _assert_same(got, ref[:3] + (ref[3][list(keep)],))
    weights = tss.hash_weights(step.plp.fec.k_bch // 8, step.num_blocks)
    for fi in range(step.n_frames):
        np.testing.assert_array_equal(
            got[0][fi].numpy(),
            tss.expected_hash(ref[3][fi].numpy().T, weights))


def test_keep_outside_the_frames_raises(three_frames):
    step, raw, track, inv, _ = three_frames
    with pytest.raises(IndexError):
        step(raw[0], raw[1], inv, track, keep=(0, 3))


@pytest.mark.cuda
def test_overlapped_step_equals_frames_one_after_another_on_card():
    """UK HD's code and batch (32K, 256QAM C2/3, 202 blocks) at 19 dB, 4
    distinct frames, every frame kept: the step decodes on side streams
    and gives the hashes, BCH-clean counts, sweeps, kept bytes and LDPC
    counters of the frames decoded and tailed one after another on the
    default stream.  The frames have 60 data symbols, not UK HD's 59: the
    port's modulator keeps a margin for L1-post that 202 blocks in 59
    symbols do not leave.  The kept bytes are uint8 rows in `keep`'s
    order, a strict subset's too."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    f, nb = 4, 202
    p, plp = benchgen.headline_mode(nb)
    p = dataclasses.replace(p, n_data=60)
    dev = torch.device("cuda")
    _, frames, rows = benchgen.modulate(p, plp, f)
    weights = tss.hash_weights(plp.fec.k_bch // 8, nb)
    expect = np.stack([tss.expected_hash(rows[fi], weights)
                       for fi in range(f)])
    step = tss.Superstep(p, plp, nb, f, benchgen.FS, weights)
    track = torch.tensor([benchgen.CFO_HZ, 1 + benchgen.SCO,
                          tss.HALF * (1 + benchgen.SCO), benchgen.PHASE0],
                         device=dev)
    assert tl.resident_ctas(step.decode.tab, dev) == \
        torch.cuda.get_device_properties(dev).multi_processor_count
    assert len(step._side_streams(dev)) == tss.SIDE_STREAMS
    raw = benchgen.impaired(frames, 10 ** -1.9,
                            torch.Generator(dev).manual_seed(7), dev)
    inv = torch.tensor(10 ** 1.9, device=dev)
    keep = tuple(range(f))
    step(raw[0], raw[1], inv, track, keep=keep)          # builds
    torch.cuda.synchronize()
    TRACER.enable()
    got = step(raw[0], raw[1], inv, track, keep=keep)
    torch.cuda.synchronize()
    on = TRACER.dump(clear=True)["counters"]
    ref = _sequential(step, raw, inv, track, keep)
    torch.cuda.synchronize()
    seq = TRACER.dump(clear=True)["counters"]
    TRACER.disable()
    _assert_same(got, ref)
    # side streams write a strict subset's rows out of frame order
    _assert_same(step(raw[0], raw[1], inv, track, keep=(3, 1)),
                 ref[:3] + (ref[3][[3, 1]],))
    assert got[1].tolist() == [202] * f
    assert int(got[2]) > tss.FLOOR_SWEEPS * f           # past the floor
    assert torch.equal(got[0].cpu(), torch.from_numpy(expect))
    assert on.pop("ldpc.overlapped_decodes") == f
    assert on == seq and on["ldpc.codeword_sweeps"] == 202 * int(got[2])
