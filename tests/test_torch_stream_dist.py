"""Two-process streaming in the port (sdr_receiver_dvb_t2_tpu_torch/
parallel/streaming.py, driven by tools/concurrent_stream_bench.py) against
the JAX package's two mechanisms (`tests/dist_child_stream.py`,
`tests/dist_child_stream2.py`), on two gloo ranks on the CPU at the JAX
children's 8K test mode.  Everything compared is bytes: tolerance 0.

- handoff, host receiver: the joined TS equals the JAX single-process
  stream of `test_streaming._waveform(8, seed=5)`, the JAX test's
  reference;
- handoff, `DeviceT2Receiver(device="cpu")`: the same, with the
  `DeviceFrontendChain` resume path crossing the process boundary;
- concurrent, host receiver, 8 frames: rank 0's TS equals the JAX
  `T2Receiver` on `dist_child_stream2.capture(8)`, both ranks used the
  same moving CFO history, and the port's capture equals JAX's sample for
  sample;
- the BB-row tap both mechanisms read, `regen_sink`: `DeviceT2Receiver`
  hands it the same rows as `T2Receiver`, in one-shot and streaming
  decodes;
- the rank set-up that lets gloo ranks share one card.
"""
import numpy as np
import pytest
import torch

from sdr_receiver_dvb_t2_tpu.io import devices as jdevices
from sdr_receiver_dvb_t2_tpu.rx.receiver import T2Receiver as JT2Receiver
from sdr_receiver_dvb_t2_tpu_torch.parallel import sharding, streaming
from sdr_receiver_dvb_t2_tpu_torch.tools import concurrent_stream_bench as csb

from tests import dist_child_stream2 as jchild2
from tests.test_streaming import _stream, _waveform

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_handoff_ref():
    flat, samples, _ = _waveform(8, seed=5)
    st, ts = _stream(jdevices.SimulatedDevice(samples, snr_db=32))
    assert st.frames_decoded == 8
    return samples, ts


@pytest.mark.parametrize("receiver", ["host", "device"])
def test_handoff_equals_jax(jax_handoff_ref, receiver):
    samples, ts_ref = jax_handoff_ref
    _, mine = streaming.handoff_capture(8, "test")
    np.testing.assert_array_equal(mine, samples)
    sec = csb.run_handoff("test", receiver, "cpu", 8, reference=False)
    assert sec["frames_by_rank"]["0"] >= 2 and sec["frames_by_rank"]["1"] >= 1
    assert sec["ts_errors"] == 0
    want = "DeviceFrontendChain" if receiver == "device" else "CorrectorChain"
    assert sec["frontend"] == {"0": want, "1": want}
    ts = sec["ts"]
    assert len(ts) >= len(ts_ref) - 2 * 188
    np.testing.assert_array_equal(ts, ts_ref[:len(ts)])


def test_concurrent_equals_jax():
    n = 8
    x_ref, _ = jchild2.capture(n)
    x, _ = streaming.capture(n, "test")
    np.testing.assert_array_equal(x, x_ref)
    sec = csb.run_concurrent("test", "host", "cpu", n, reference=False)
    assert sec["frames_by_rank"] == {"0": n // 2, "1": n // 2}
    assert sec["rounds"] == n // 4
    assert sec["ts_errors"] == 0
    # the exchanged tracking state was load-bearing: both ranks used the
    # merged state, and it moved
    h = sec["cfo_history_hz"]
    assert sec["cfo_history_equal"]
    assert any(abs(h[i + 1] - h[i]) > 1e-3 for i in range(len(h) - 1))
    ref = JT2Receiver().receive(
        np.concatenate([x_ref, np.zeros(2048, np.complex64)]))
    assert ref.stats.frames_decoded == n
    ts = sec["ts"]
    assert len(ts) >= len(ref.ts) - 2 * 188
    np.testing.assert_array_equal(ts, ref.ts[:len(ts)])


class _Sink:
    """A `regen_sink` that records what the receiver hands it."""

    def __init__(self):
        self.frames, self.rows, self.bad = 0, [], 0

    def start_frame(self, params, l1pre, l1post):
        self.frames += 1

    def add_bb(self, plp_id, bb):
        self.rows.append(np.packbits(np.asarray(bb, np.uint8), axis=1))

    def mark_bad(self):
        self.bad += 1


@pytest.mark.parametrize("route", ["receive", "stream"])
def test_device_receiver_regen_sink_equals_host(jax_handoff_ref, route):
    samples, _ = jax_handoff_ref
    cfg = streaming.STREAM["test"]
    sinks = {}
    for kind in streaming.RECEIVERS:
        rx = streaming.make_receiver(kind, torch.device("cpu"))
        rx.regen_sink = sinks[kind] = _Sink()
        if route == "receive":
            frames = rx.receive(samples).stats.frames_decoded
        else:
            from sdr_receiver_dvb_t2_tpu_torch.io import devices
            frames = devices.StreamingReceiver(
                devices.SimulatedDevice(samples, snr_db=streaming.SNR_DB),
                receiver=rx, acq_seconds=cfg["acq_seconds"],
                block_seconds=cfg["block_seconds"]).run().frames_decoded
        assert frames >= 6 and sinks[kind].frames == frames
        assert sinks[kind].bad == 0
        if kind == "device" and route == "stream":
            assert rx.batch_supersteps > 0    # the batched frames too
    host, dev = sinks["host"], sinks["device"]
    assert len(dev.rows) == len(host.rows) == host.frames
    for a, b in zip(host.rows, dev.rows):
        np.testing.assert_array_equal(a, b)


def test_gloo_ranks_share_one_card(monkeypatch):
    """On a machine with one card: gloo ranks both take cuda:0, NCCL ranks
    take cuda:rank, and `launch` refuses two NCCL ranks but starts two
    gloo ranks."""
    calls = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: calls.append(("set_device", d)))
    monkeypatch.setattr(sharding.dist, "init_process_group",
                        lambda backend, **kw: calls.append(
                            ("init", backend, kw["rank"])))
    monkeypatch.setattr(sharding.dist, "destroy_process_group",
                        lambda: calls.append(("destroy",)))
    for rank in (0, 1):
        with sharding.rank_group(rank, 2, "localhost:1", "cuda",
                                 backend="gloo"):
            pass
    assert calls == [("set_device", 0), ("init", "gloo", 0), ("destroy",),
                     ("set_device", 0), ("init", "gloo", 1), ("destroy",)]
    calls.clear()
    with sharding.rank_group(0, 1, "localhost:1", "cuda"):
        pass
    assert calls[1] == ("init", "nccl", 0)

    started = []
    monkeypatch.setattr(sharding.mp, "start_processes",
                        lambda fn, args, nprocs, **kw: started.append(
                            (nprocs, args[3])))
    with pytest.raises(RuntimeError, match="need 2 CUDA devices"):
        sharding.launch(2, print, device="cuda")
    sharding.launch(2, print, device="cuda", backend="gloo")
    assert started == [(2, "gloo")]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="found 0"):
        sharding.launch(2, print, device="cuda", backend="gloo")


@pytest.mark.cuda
def test_both_mechanisms_at_the_headline_mode_on_card():
    """Both mechanisms at the bench's mode with DeviceT2Receiver on the
    card (K2): TS bit-exact against one process (chip_smoke.py's
    phase_stream_dist runs the same)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the receiver's K2 runs there)")
    for run in (csb.run_handoff, csb.run_concurrent):
        sec = run("headline", "device", "cuda", 8)
        assert sec["ts_bit_exact_vs_single_process"]
        assert all(v["K2"] > 0 for v in sec["launches"].values())
