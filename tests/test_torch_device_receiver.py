"""The port's `DeviceT2Receiver` (sdr_receiver_dvb_t2_tpu_torch/rx/
device_receiver.py) against the JAX package's on the loopbacks of
tests/test_device_e2e.py, on the CPU: noiseless, AWGN, multipath, CFO,
MISO, the soft-L1 fallback and type-2 PLPs; one streaming run through
`io.devices.StreamingReceiver`; the decoder choice; and the layered
decoders' receiver routes at 128 codewords per frame.

TS bytes and frames decoded must be equal.  The SNR estimate is the L1
cells' EVM from f32 cells whose FFTs differ by f32 rounding, so it agrees
within 1e-3 dB (measured ~1e-6 dB)."""
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from sdr_receiver_dvb_t2_tpu.dvbt2.params import (
    CodeRate, Constellation, FECFrame, FFTMode, GuardInterval, PilotPattern,
    PLPParams, Preamble, T2Params)
from sdr_receiver_dvb_t2_tpu.rx import device_receiver as jdr
from sdr_receiver_dvb_t2_tpu.tx.modulator import T2Modulator, apply_cfo, awgn
from sdr_receiver_dvb_t2_tpu_torch.io import devices
from sdr_receiver_dvb_t2_tpu_torch.ops import ldpc as tldpc
from sdr_receiver_dvb_t2_tpu_torch.ops import ldpc_layered as tl
from sdr_receiver_dvb_t2_tpu_torch.rx import device_receiver as tdr
from sdr_receiver_dvb_t2_tpu_torch.tx import modulator as tmod
from sdr_receiver_dvb_t2_tpu_torch.utils.reference import (
    params_from_reference)

from tests.test_e2e import make_ts, small_config

torch.set_num_threads(1)

SNR_TOL_DB = 1e-3


def _port(**kw):
    return tdr.DeviceT2Receiver(device="cpu", **kw)


def _assert_same(mine, ref):
    assert mine.stats.frames_decoded == ref.stats.frames_decoded
    assert mine.stats.ts_errors == ref.stats.ts_errors
    np.testing.assert_array_equal(mine.ts, ref.ts)
    assert len(mine.stats.snr_db) == len(ref.stats.snr_db)
    np.testing.assert_allclose(mine.stats.snr_db, ref.stats.snr_db,
                               rtol=0, atol=SNR_TOL_DB)


def _multipath(x):
    taps = np.zeros(40, np.complex64)
    taps[0] = 1.0
    taps[7] = 0.35 * np.exp(1.1j)
    taps[23] = 0.2 * np.exp(-2.3j)
    return awgn(np.convolve(x, taps)[:len(x)].astype(np.complex64), 27,
                seed=6)


LOOPBACKS = {
    "noiseless": None,
    "awgn": lambda s: awgn(s, 20, seed=1),
    "multipath": _multipath,
    "cfo": lambda s: awgn(apply_cfo(s, 2000.0), 22, seed=2),
}


@pytest.mark.parametrize("case", sorted(LOOPBACKS))
def test_loopback_equals_jax_receiver(case):
    p, plp = small_config()
    mod = T2Modulator(p, [plp])
    ts = make_ts(mod.packets_needed(2) + 4, seed=0).reshape(-1)
    y = mod.modulate(ts, 2).samples
    if LOOPBACKS[case] is not None:
        y = LOOPBACKS[case](y)
    ref = jdr.DeviceT2Receiver().receive(y)
    mine = _port().receive(y)
    _assert_same(mine, ref)
    assert mine.stats.frames_decoded >= 1 and len(mine.ts) > 0
    np.testing.assert_array_equal(mine.ts, ts[:len(mine.ts)])


def test_miso_equals_jax_receiver():
    p = T2Params(fft_mode=FFTMode.FFT_8K, guard=GuardInterval.GI_1_32,
                 pilot_pattern=PilotPattern.PP1, extended_carrier=False,
                 n_data=9, miso=True, preamble=Preamble.T2_MISO)
    plp = PLPParams(constellation=Constellation.QAM16, rate=CodeRate.C1_2,
                    fec_frame=FECFrame.SHORT, rotated=True,
                    num_blocks_max=3, time_il_length=1)
    mod = T2Modulator(p, [plp])
    ts = make_ts(mod.packets_needed(2) + 4, seed=7).reshape(-1)
    out = mod.modulate(ts, 2)

    def ch(x, taps):
        return np.convolve(x, taps)[:len(x)].astype(np.complex64)

    y = awgn(ch(out.samples, [1.0, 0.08j])
             + ch(out.samples2, [0.0, 0.0, 0.6 * np.exp(0.7j), -0.05]),
             28, seed=3)
    ref = jdr.DeviceT2Receiver().receive(y)
    mine = _port().receive(y)
    assert mine.params.miso
    _assert_same(mine, ref)
    assert mine.stats.frames_decoded == 2 and len(mine.ts) > 0
    np.testing.assert_array_equal(mine.ts, ts[:len(mine.ts)])


def test_soft_l1_fallback_equals_jax_receiver():
    p, plp = small_config()
    mod = T2Modulator(p, [plp])
    ts = make_ts(mod.packets_needed(1) + 4, seed=9)
    y = awgn(mod.modulate(ts.reshape(-1), 1).samples, 7.0, seed=4)
    ref = jdr.DeviceT2Receiver().receive(y)
    mine = _port().receive(y)
    _assert_same(mine, ref)
    assert mine.stats.frames_decoded in (0, 1)
    assert mine.stats.l1_failures == ref.stats.l1_failures


def test_type2_plps_equal_jax_receiver():
    p = T2Params(fft_mode=FFTMode.FFT_8K, guard=GuardInterval.GI_1_32,
                 pilot_pattern=PilotPattern.PP1, extended_carrier=False,
                 n_data=9)
    plps = [PLPParams(plp_id=0, constellation=Constellation.QAM16,
                      rate=CodeRate.C1_2, fec_frame=FECFrame.SHORT,
                      num_blocks_max=1, time_il_length=1),
            PLPParams(plp_id=1, constellation=Constellation.QPSK,
                      rate=CodeRate.C1_2, fec_frame=FECFrame.SHORT,
                      rotated=False, num_blocks_max=1, time_il_length=1,
                      plp_type=2, sub_slices=3),
            PLPParams(plp_id=2, constellation=Constellation.QPSK,
                      rate=CodeRate.C1_2, fec_frame=FECFrame.SHORT,
                      rotated=False, num_blocks_max=2, time_il_length=1,
                      plp_type=2, sub_slices=3)]
    mod = T2Modulator(p, plps)
    ts = make_ts(mod.packets_needed(2) + 6, seed=23)
    y = mod.modulate(ts.reshape(-1), 2).samples
    src = {pkt.tobytes() for pkt in ts}
    for pid in (0, 1, 2):
        ref = jdr.DeviceT2Receiver(plp_filter=pid).receive(y)
        mine = _port(plp_filter=pid).receive(y)
        _assert_same(mine, ref)
        assert mine.stats.frames_decoded == 2 and len(mine.ts) >= 188
        assert all(pkt.tobytes() in src for pkt in mine.ts.reshape(-1, 188))


def _stream_waveform(n_frames):
    """tests/test_streaming.py's 8K/16QAM waveform."""
    p, plp = small_config(rotated=False)
    mod = T2Modulator(p, [plp])
    rng = np.random.default_rng(5)
    ts = rng.integers(0, 256, (mod.packets_needed(n_frames) + 4, 188)
                      ).astype(np.uint8)
    ts[:, 0] = 0x47
    ts[:, 1] &= 0x7F
    return ts.reshape(-1), mod.modulate(ts.reshape(-1), n_frames).samples


def _stream(samples, rx):
    got = []
    st = devices.StreamingReceiver(
        devices.SimulatedDevice(samples, snr_db=32), receiver=rx,
        acq_seconds=0.025, block_seconds=0.007).run(ts_sink=got.append)
    return st, np.concatenate(got) if got else np.zeros(0, np.uint8)


def test_streaming_batched_path():
    """The streaming loop with the port's receiver (the --stream
    --device-path route): after the frames that seed the noise estimate,
    frames decode in F-frame MultiFramePath supersteps; the TS is
    bit-exact.  At the elementary rate the samples go through the
    port's device front-end chain on the receiver's device."""
    flat, samples = _stream_waveform(8)
    rx = _port(stream_batch=3)
    assert rx.wants_device_frontend is True
    st, ts = _stream(samples, rx)
    assert st.frontend == "DeviceFrontendChain"
    assert st.frames_decoded == 8
    assert st.frames_skipped == 0
    assert rx.batch_supersteps >= 1
    assert len(ts) > 0
    np.testing.assert_array_equal(ts, flat[:len(ts)])


def test_streaming_run_never_imports_jax():
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import torch
        from sdr_receiver_dvb_t2_tpu_torch.dvbt2.params import (
            CodeRate, Constellation, FECFrame, FFTMode, GuardInterval,
            PilotPattern, PLPParams, T2Params)
        from sdr_receiver_dvb_t2_tpu_torch.io import devices
        from sdr_receiver_dvb_t2_tpu_torch.tx.modulator import T2Modulator
        from sdr_receiver_dvb_t2_tpu_torch.rx.device_receiver import (
            DeviceT2Receiver)
        torch.set_num_threads(1)
        p = T2Params(fft_mode=FFTMode.FFT_8K, guard=GuardInterval.GI_1_32,
                     pilot_pattern=PilotPattern.PP1, extended_carrier=False,
                     n_data=9)
        plp = PLPParams(constellation=Constellation.QAM16,
                        rate=CodeRate.C1_2, fec_frame=FECFrame.SHORT,
                        num_blocks_max=3, time_il_length=1)
        mod = T2Modulator(p, [plp])
        rng = np.random.default_rng(1)
        ts = rng.integers(0, 256, (mod.packets_needed(5) + 4, 188)
                          ).astype(np.uint8)
        ts[:, 0] = 0x47
        ts[:, 1] &= 0x7F
        x = mod.modulate(ts.reshape(-1), 5).samples
        rx = DeviceT2Receiver(device="cpu", stream_batch=2)
        got = []
        st = devices.StreamingReceiver(
            devices.SimulatedDevice(x, snr_db=32), receiver=rx,
            acq_seconds=0.025, block_seconds=0.007).run(ts_sink=got.append)
        out = np.concatenate(got)
        ok = np.array_equal(out, ts.reshape(-1)[:len(out)]) and len(out)
        print(st.frames_decoded, rx.batch_supersteps, bool(ok),
              sorted(m for m in sys.modules if m.split(".")[0] in
                     ("jax", "jaxlib", "sdr_receiver_dvb_t2_tpu")))
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    frames, supersteps, ok, jax_mods = proc.stdout.strip().split(" ", 3)
    assert int(frames) == 5 and int(supersteps) >= 1 and ok == "True"
    assert jax_mods == "[]"


def test_get_decoder_follows_jax_rule():
    n, s = FECFrame.NORMAL, FECFrame.SHORT
    cases = [  # (frame, rate, batch, adaptive, kind, layered variant)
        (n, CodeRate.C2_3, 128, True, "nb_adaptive", None),
        (n, CodeRate.C2_3, 256, True, "nb_adaptive", None),
        (n, CodeRate.C2_3, 128, False, "nb", "vmem"),
        (n, CodeRate.C3_5, 128, False, "nb", "hbm"),
        (s, CodeRate.C1_2, 128, False, "nb", "vmem"),
        (s, CodeRate.C1_2, 3, True, "flood", None),
        (n, CodeRate.C2_3, 100, False, "flood", None),
    ]
    for frame, rate, batch, adaptive, kind, variant in cases:
        plp = PLPParams(rate=rate, fec_frame=frame)
        mine_plp = params_from_reference(plp)
        rx = _port(adaptive=adaptive, ldpc_max_iters=24)
        got_kind, dec = rx._get_decoder(mine_plp, batch)
        ref_kind, _ = jdr.DeviceT2Receiver(
            adaptive=adaptive, ldpc_max_iters=24)._get_decoder(plp, batch)
        assert got_kind == ref_kind == kind
        assert rx._get_decoder(mine_plp, batch)[1] is dec  # built once
        if kind == "nb_adaptive":
            assert isinstance(dec, tl.AdaptiveDecoderNB)
            assert dec.in_dtype == torch.float32           # K2, not K1
            assert (dec.max_iters, dec.check_every) == (24, 2)
            assert dec.order == list(range(dec.tab.q))[::-1]
        elif kind == "nb":
            assert isinstance(dec, tl.FixedDecoderNB)
            assert dec.core.variant == variant and dec.core.iters == 12
        else:
            assert isinstance(dec, tldpc.FloodDecoder)
            assert tldpc.DTYPE == torch.bfloat16 and dec.iters == 24


@pytest.mark.parametrize("adaptive", [True, False], ids=["K2", "K3"])
def test_layered_routes_at_128_blocks(adaptive, monkeypatch):
    """128 SHORT codewords per frame take the layered decoders (K2
    adaptive, K3 fixed) through their plain versions on the CPU; the TS is
    bit-exact against the transmitted one."""
    p = T2Params(fft_mode=FFTMode.FFT_8K, guard=GuardInterval.GI_1_32,
                 pilot_pattern=PilotPattern.PP1, extended_carrier=False,
                 n_data=44)
    plp = PLPParams(constellation=Constellation.QAM256, rate=CodeRate.C2_3,
                    fec_frame=FECFrame.SHORT, rotated=True,
                    num_blocks_max=128, time_il_length=1)
    p, plp = params_from_reference(p), params_from_reference(plp)
    mod = tmod.T2Modulator(p, [plp])
    assert mod.blocks_per_frame(plp) == 128
    ts = make_ts(mod.packets_needed(2) + 4, seed=12).reshape(-1)
    y = tmod.awgn(mod.modulate(ts, 2).samples, 24, seed=12)
    calls = []
    for cls in (tl.AdaptiveDecoderNB, tl.FixedDecoderNB):
        plain = cls.plain
        monkeypatch.setattr(cls, "plain", lambda self, *a, _p=plain, **k: (
            calls.append(type(self).__name__), _p(self, *a, **k))[1])
    res = _port(adaptive=adaptive).receive(y)
    assert res.stats.frames_decoded == 2 and res.stats.ts_errors == 0
    assert len(res.ts) > 0
    np.testing.assert_array_equal(res.ts, ts[:len(res.ts)])
    want = "AdaptiveDecoderNB" if adaptive else "FixedDecoderNB"
    assert calls == [want, want]
    if adaptive:
        assert all(0 < it < 24
                   for it in res.stats.plp_stats[0].ldpc_iters)
