"""The port's streaming front end (sdr_receiver_dvb_t2_tpu_torch/ops/
frontend_device.py: `make_frontend`, `make_rational_resampler`,
`DeviceFrontendChain`) against the JAX package's on the same seeded
blocks, and a streaming run through the port's `StreamingReceiver`.

Tolerances.  Both sides run the same f32 operations in the same order;
cos/sin and the order of the block sums differ by an ulp, so
`make_frontend` and the rational resampler agree to 1e-5 of the signal's
standard deviation (as tests/test_torch_frontend.py).  The chain runs
the same stages with f32 read positions and phases that grow with the
block (at these sizes ~4e3 samples and ~4 rad), so it is held to 1e-4 of
the signal's standard deviation on every sample (measured 4e-6); the
output COUNT of every block and the host bookkeeping are equal exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdr_receiver_dvb_t2_tpu.ops import frontend_device as jf
from sdr_receiver_dvb_t2_tpu_torch.io import devices
from sdr_receiver_dvb_t2_tpu_torch.ops import frontend_device as tf
from sdr_receiver_dvb_t2_tpu_torch.rx import frontend as hostfe
from sdr_receiver_dvb_t2_tpu_torch.rx.device_receiver import DeviceT2Receiver
from sdr_receiver_dvb_t2_tpu_torch.tx.modulator import T2Modulator
from sdr_receiver_dvb_t2_tpu_torch.utils.reference import (
    params_from_reference)

from tests.test_e2e import small_config

torch.set_num_threads(1)

FS = 9.142857e6
HALF = 8
RTOL = 1e-5


def _bandlimited(n, seed, edge=0.425):
    rng = np.random.default_rng(seed)
    nf = int(n * edge)
    spec = np.zeros(n, np.complex128)
    spec[1:nf] = rng.normal(size=nf - 1) + 1j * rng.normal(size=nf - 1)
    spec[-nf + 1:] = rng.normal(size=nf - 1) + 1j * rng.normal(size=nf - 1)
    return (np.fft.ifft(spec) * np.sqrt(n)).astype(np.complex64)


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(a).std()


@pytest.mark.parametrize("planar", [False, True], ids=["paired", "planar"])
def test_make_frontend_equals_jax(planar):
    """Three chunks of 2048 outputs, two frames, raw with DC and IQ
    imbalance; the NCO runs on the raw samples."""
    n, f, chunk = 5000, 2, 2048
    ratio = np.float32(1 + 2e-5)
    n_raw = int(np.ceil((n + 2 * HALF) * ratio)) + 4 * HALF
    x = np.stack([_bandlimited(n_raw + 64, 20 + i)[:n_raw]
                  for i in range(f)])
    raw = np.stack([x.real + 0.01, 1.03 * x.imag - 0.02 + 0.01 * x.real],
                   -1).astype(np.float32)
    track = (np.float32(900.0), ratio, np.float32(HALF * ratio),
             np.float32(0.3))
    fe_j = jf.make_frontend(n, FS, half=HALF, chunk=chunk, planar=planar)
    fe_t = tf.make_frontend(n, FS, half=HALF, chunk=chunk, planar=planar)
    if planar:
        (ar, ai), adc, agiq = fe_j(jnp.asarray(raw[..., 0]),
                                   jnp.asarray(raw[..., 1]),
                                   *(jnp.float32(v) for v in track))
        (br, bi), bdc, bgiq = fe_t(torch.from_numpy(raw[..., 0].copy()),
                                   torch.from_numpy(raw[..., 1].copy()),
                                   *(torch.tensor(v) for v in track))
        a = np.asarray(ar) + 1j * np.asarray(ai)
        b = br.numpy() + 1j * bi.numpy()
    else:
        out_j, adc, agiq = fe_j(jnp.asarray(raw),
                                *(jnp.float32(v) for v in track))
        out_t, bdc, bgiq = fe_t(torch.from_numpy(raw),
                                *(torch.tensor(v) for v in track))
        assert out_t.shape == (f, n, 2)
        a = np.asarray(out_j)[..., 0] + 1j * np.asarray(out_j)[..., 1]
        b = out_t.numpy()[..., 0] + 1j * out_t.numpy()[..., 1]
    assert b.shape == a.shape == (f, n)
    assert _rel(a, b) < RTOL
    np.testing.assert_allclose(bdc.numpy(), np.asarray(adc), atol=1e-7)
    np.testing.assert_allclose(bgiq.numpy(), np.asarray(agiq), atol=1e-6)


def test_resampler_chunk_changes_last_bits_as_in_jax():
    """The stencil start is taken per chunk: at chunk 64 the output
    differs from chunk 16384's in the last bits, and each equals JAX's at
    the same chunk."""
    x = _bandlimited(6000, 5)
    x2 = np.stack([x.real, x.imag], -1).astype(np.float32)[None]
    ratio = np.float32(1.00625)
    outs = {}
    for chunk in (64, 16384):
        a = np.asarray(jf.make_resampler(5000, half=HALF, chunk=chunk)(
            jnp.asarray(x2), jnp.float32(ratio), 8.0))
        b = tf.make_resampler(5000, half=HALF, chunk=chunk)(
            torch.from_numpy(x2), torch.tensor(ratio), 8.0).numpy()
        if chunk == 64:     # 16384 * 0.00625 is far beyond the mu range
            assert _rel(a, b) < RTOL
        outs[chunk] = b
    assert not np.array_equal(outs[64], outs[16384])


@pytest.mark.parametrize("num,den", [(35, 32), (65, 64)])
def test_rational_resampler_equals_jax(num, den):
    x = np.stack([_bandlimited(4000, 30 + i) for i in range(2)])
    xr = np.ascontiguousarray(x.real, np.float32)
    fn_j, spill_j = jf.make_rational_resampler(num, den, half=HALF)
    fn_t, spill_t = tf.make_rational_resampler(num, den, half=HALF)
    assert spill_t == spill_j
    a, a_blocks = fn_j(jnp.asarray(xr))
    b, b_blocks = fn_t(torch.from_numpy(xr))
    assert b_blocks == int(a_blocks) and b.shape == a.shape
    assert _rel(np.asarray(a), b.numpy()) < RTOL
    # too short for one block: empty, as in JAX
    short, n0 = fn_t(torch.zeros(2, num + 3))
    assert short.shape == (2, 0) and n0 == 0


def _rows_form(num, den, x):
    """The resampler as it was built before windows: each num-sample row
    extended by the first spill - num samples of the next row (it served
    only stencils that end within two rows)."""
    fn, spill = tf.make_rational_resampler(num, den, half=HALF)
    assert spill <= 2 * num
    f, n_in = x.shape
    a = (n_in - spill - num) // num
    xe = x[:, :a * num].reshape(f, a, num)
    if spill > num:
        ext = x[:, num:num + a * num].reshape(f, a, num)[:, :, :spill - num]
        xe = torch.cat([xe, ext], 2)
    cf = tf._bank(HALF)
    offs = [(r * num) // den for r in range(den)]
    w = torch.tensor([[_horner64(cf_t, (r * num) / den - offs[r])
                       for cf_t in cf] for r in range(den)], dtype=x.dtype)
    cols = torch.as_tensor(offs)
    acc = None
    for t in range(len(cf)):
        term = xe[:, :, cols + t] * w[:, t]
        acc = term if acc is None else acc + term
    return acc.reshape(f, a * den), a


def _horner64(cf_t, mu):
    w = 0.0
    for c in cf_t:
        w = w * mu + c
    return w


@pytest.mark.parametrize("num,den", [(35, 32), (65, 64)])
def test_rational_resampler_windows_equal_the_row_form(num, den):
    """Where the stencil ends within two rows, the windowed form reads the
    same samples with the same weights in the same order: bit-equal to the
    row-plus-next-row form (which test_rational_resampler_equals_jax holds
    against JAX)."""
    x = torch.from_numpy(np.ascontiguousarray(
        np.stack([_bandlimited(4000, 50 + i) for i in range(2)]).real,
        np.float32))
    fn, _ = tf.make_rational_resampler(num, den, half=HALF)
    got, n = fn(x)
    want, n_rows = _rows_form(num, den, x)
    assert n == n_rows > 0
    assert torch.equal(got, want)


TONE = 0.013           # cycles per input sample, inside the fitted band


def _tone_error(num, den, n_in=6000):
    """Resample a complex tone (real and imaginary planes as two rows) and
    compare with the ideal tone at the output grid k*num/den, after one
    complex gain that absorbs the stencil's constant delay.
    -> (output, max |error| relative to the tone's amplitude)."""
    n = np.arange(n_in)
    tone = np.exp(2j * np.pi * TONE * n)
    x = torch.from_numpy(np.stack([tone.real, tone.imag]).astype(np.float32))
    fn, _ = tf.make_rational_resampler(num, den, half=HALF)
    y, _ = fn(x)
    y = y[0].double().numpy() + 1j * y[1].double().numpy()
    ideal = np.exp(2j * np.pi * TONE * np.arange(len(y)) * num / den)
    gain = np.vdot(ideal, y) / len(y)
    return y, np.abs(y - gain * ideal).max() / abs(gain)


@pytest.mark.parametrize("num,den", [(5, 4), (7, 4)])
def test_rational_resampler_long_stencils(num, den):
    """5/4 and 7/4 (10 Msps on 7 and 5 MHz channels): the 17-tap stencil
    spans more than two rows.  The output equals a float64 NumPy evaluation
    of the same stencil (every output k = a*den + r is the sum over taps t
    of w_t(mu_r) x[a*num + floor(r*num/den) + t]) to f32 rounding, and a
    tone comes through as accurately as at 35/32 (within 2x of its error).
    The JAX version clamps the stencil's columns beyond two rows, so the
    port's output, and a TS decoded from it, may differ from the JAX
    receiver's at these ratios."""
    x = np.stack([_bandlimited(3000, 60 + i) for i in range(2)]).real
    fn, spill = tf.make_rational_resampler(num, den, half=HALF)
    assert spill > 2 * num
    got, a = fn(torch.from_numpy(x.astype(np.float32)))
    cf = tf._bank(HALF)
    want = np.zeros((2, a * den))
    for r in range(den):
        off, mu = (r * num) // den, (r * num) / den - (r * num) // den
        for t, cf_t in enumerate(cf):
            want[:, r::den] += _horner64(cf_t, mu) * x[
                :, off + t:off + t + (a - 1) * num + 1:num]
    assert a > 0 and got.shape == (2, a * den)
    assert np.abs(got.numpy() - want).max() / np.abs(want).std() < RTOL
    _, err = _tone_error(num, den)
    _, err_35 = _tone_error(35, 32)
    assert err < 2 * err_35, (err, err_35)


def test_chain_builds_or_refuses_at_every_vendor_rate_and_bandwidth():
    """Every vendor rate x channel bandwidth either builds the device
    chain or is refused with UnsupportedRatio (host chain); 10 Msps on 7
    and 5 MHz channels now build, with the polyphase stage at 5/4 and
    7/4."""
    from sdr_receiver_dvb_t2_tpu_torch.dvbt2.params import Bandwidth
    built = {}
    for bw in Bandwidth:
        for rate in sorted(set(hostfe.DEVICE_RATES.values())):
            try:
                chain = tf.DeviceFrontendChain(rate, bw.sample_rate, 4096,
                                               device="cpu")
            except tf.UnsupportedRatio:
                continue
            built[bw.name, rate] = chain._rat
    assert built[("BW_7", 10.0e6)] == (5, 4)
    assert built[("BW_5", 10.0e6)] == (7, 4)
    assert built[("BW_8", 10.0e6)] == (35, 32)
    assert built[("BW_8", 9.2e6)] is None


RATE = devices.SAMPLE_RATE      # the exact elementary rate, 64e6 / 7

# (label, device rate, block sizes fed in turn)
CHAIN_CASES = {
    "elementary": (RATE, (4096, 4096, 1000, 7000)),
    "sdrplay-9.2M-drift": (9.2e6, (4096, 4096, 3000, 5000)),
    "airspy-10M-rational": (10.0e6, (4096, 4096, 2000, 6000)),
    "oversized-call-split": (9.2e6, (4096, 11000, 4096)),
}


@pytest.mark.parametrize("case", sorted(CHAIN_CASES))
def test_chain_equals_jax_block_by_block(case):
    """Same seeded blocks (DC, IQ imbalance, a frequency correction added
    after the first block) through the JAX chain and the port's: equal
    output counts for every block, outputs within the stated tolerance,
    the DC/IQ estimates equal to f32 rounding, and the host bookkeeping
    (read position, phase, halo length) equal."""
    rate, sizes = CHAIN_CASES[case]
    block_len = 4096
    total = sum(sizes)
    x = _bandlimited(total + 64, 41)[:total]
    x = ((x.real + 0.02) + 1j * (1.03 * x.imag - 0.01 + 0.012 * x.real)
         ).astype(np.complex64)
    ref = jf.DeviceFrontendChain(rate, RATE, block_len)
    mine = tf.DeviceFrontendChain(rate, RATE, block_len, device="cpu")
    assert mine._chunk == 64 and mine._n_max == ref._n_max
    at, worst, diffs = 0, 0.0, []
    for k, n in enumerate(sizes):
        blk = x[at:at + n]
        at += n
        a, b = ref.process(blk), mine.process(blk)
        assert len(a) == len(b), (k, len(a), len(b))
        if k == 0:
            assert len(b) > 0
            for ch in (ref, mine):
                ch.add_frequency(1234.5, applied_samples=len(b))
        if len(a):
            scale = np.abs(a).std()
            worst = max(worst, np.abs(a - b).max() / scale)
            diffs.append(np.abs(a - b).mean() / scale)
        assert mine._pos == ref._pos and mine._phase == ref._phase
        assert len(mine._halo) == len(ref._halo)
        assert abs(mine.dciq.dc - ref.dciq.dc) < 1e-6
        assert abs(mine.dciq.g - ref.dciq.g) < 1e-5
        assert abs(mine.dciq.c - ref.dciq.c) < 1e-5
    assert worst < 1e-4 and max(diffs) < 1e-5
    assert mine._dciq_state.device.type == "cpu"
    assert mine.freq_hz == ref.freq_hz and mine.ratio == ref.ratio


def test_chain_refuses_unsupported_ratio():
    """The refusal is an error of its own kind (still a ValueError, as in
    the JAX package), so a caller can tell it from any other fault."""
    with pytest.raises(tf.UnsupportedRatio, match="host chain"):
        tf.DeviceFrontendChain(9.5e6, FS, 4096, device="cpu")
    assert issubclass(tf.UnsupportedRatio, ValueError)
    with pytest.raises(ValueError):
        jf.DeviceFrontendChain(9.5e6, FS, 4096)


def test_chain_rebase_splice_equals_jax():
    """The SCO re-lock splice (a host post-stage seeded from the pending
    output) gives the same samples and the same later counts."""
    x = _bandlimited(3 * 4096, 43)
    ref = jf.DeviceFrontendChain(FS, FS, 4096)
    mine = tf.DeviceFrontendChain(FS, FS, 4096, device="cpu")
    a0, b0 = ref.process(x[:4096]), mine.process(x[:4096])
    ra = ref.rebase_ratio(a0[-1000:], 1.00002)
    rb = mine.rebase_ratio(b0[-1000:], 1.00002)
    assert len(ra) == len(rb) and _rel(ra, rb) < 1e-4
    a1, b1 = ref.process(x[4096:8192]), mine.process(x[4096:8192])
    assert len(a1) == len(b1) and _rel(a1, b1) < 1e-3
    assert mine.ratio == ref.ratio


def _waveform(n_frames):
    """tests/test_streaming.py's 8K/16QAM waveform, from the port's own
    modulator."""
    p, plp = (params_from_reference(v) for v in small_config(rotated=False))
    mod = T2Modulator(p, [plp])
    rng = np.random.default_rng(5)
    ts = rng.integers(0, 256, (mod.packets_needed(n_frames) + 4, 188)
                      ).astype(np.uint8)
    ts[:, 0] = 0x47
    ts[:, 1] &= 0x7F
    return ts.reshape(-1), mod.modulate(ts.reshape(-1), n_frames).samples


def _stream(dev, rx):
    got = []
    st = devices.StreamingReceiver(
        dev, receiver=rx, acq_seconds=0.025, block_seconds=0.007).run(
            ts_sink=got.append)
    return st, np.concatenate(got) if got else np.zeros(0, np.uint8)


def test_stream_device_frontend_chain():
    """A 9.2 Msps capture (the SdrPlay/Pluto rate, +0.625%) with CFO, DC
    offset and IQ imbalance through the port's StreamingReceiver: the
    device chain corrects the samples, the TS is bit-exact, and the
    chain's estimates match the injected impairments (the gates of
    tests/test_streaming.py::test_stream_device_frontend_chain)."""
    flat, samples = _waveform(8)
    dev_samples = hostfe.sinc_resample(samples, devices.SAMPLE_RATE / 9.2e6)
    dev = devices.SimulatedDevice(dev_samples, snr_db=32, sample_rate=9.2e6,
                                  lo_offset_hz=700.0,
                                  dc_offset=0.012 - 0.008j,
                                  iq_gain=1.02, iq_skew=0.012)
    st, ts = _stream(dev, DeviceT2Receiver(device="cpu", stream_batch=3))
    assert st.frontend == "DeviceFrontendChain"
    assert st.frames_decoded == 8
    assert st.frames_skipped == 0
    assert len(ts) > 0
    np.testing.assert_array_equal(ts, flat[:len(ts)])
    assert abs(st.cfo_hz - 700.0) < 50.0
    assert abs(st.iq_gain_est - 1.02) < 8e-3
    assert abs(st.iq_skew_est - 0.012) < 8e-3
    assert abs(st.dc_offset_est - (0.012 - 0.008j)) < 5e-3


def test_stream_airspy_rate_polyphase():
    """The 10 Msps AirSpy rate (35/32 of elementary) runs on the device
    chain through the polyphase stage."""
    flat, samples = _waveform(6)
    dev_samples = hostfe.sinc_resample(samples, devices.SAMPLE_RATE / 10.0e6)
    dev = devices.SimulatedDevice(dev_samples, snr_db=32, sample_rate=10.0e6)
    st, ts = _stream(dev, DeviceT2Receiver(device="cpu", stream_batch=3))
    assert st.frontend == "DeviceFrontendChain"
    assert st.frames_decoded >= 5
    assert len(ts) > 0
    np.testing.assert_array_equal(ts, flat[:len(ts)])


def test_stream_airspy_rate_every_frame_with_a_tail():
    """The polyphase stage and the drift stage hold back about 150 samples
    for their stencils, more than the 32 the tracker forgives at the end of
    a capture: a capture that ends on a frame boundary loses its last
    frame to that (above), and one that runs on into the next frame's P1
    decodes every whole frame it holds."""
    n_play = 5
    flat, samples = _waveform(n_play + 1)
    fsamp = len(samples) // (n_play + 1)
    dev_samples = hostfe.sinc_resample(samples[:n_play * fsamp + 2048],
                                       devices.SAMPLE_RATE / 10.0e6)
    dev = devices.SimulatedDevice(dev_samples, snr_db=32, sample_rate=10.0e6)
    st, ts = _stream(dev, DeviceT2Receiver(device="cpu", stream_batch=3))
    assert st.frontend == "DeviceFrontendChain"
    assert st.frames_decoded == n_play
    assert st.ts_errors == 0 and len(ts) > 0
    np.testing.assert_array_equal(ts, flat[:len(ts)])


def test_stream_airspy_rate_on_a_7mhz_channel():
    """10 Msps on a 7 MHz channel (elementary rate 8 Msps, ratio 5/4: the
    stencil spans more than two 5-sample rows) streams through the device
    chain, with no host fallback, to a bit-exact TS of every whole frame.
    The JAX receiver clamps the stencil there, so its TS at this ratio is
    no reference for this one; the transmitted TS is."""
    from sdr_receiver_dvb_t2_tpu_torch.dvbt2.params import Bandwidth
    fs = Bandwidth.BW_7.sample_rate
    n_play = 4
    flat, samples = _waveform(n_play + 1)
    fsamp = len(samples) // (n_play + 1)
    dev_samples = hostfe.sinc_resample(samples[:n_play * fsamp + 2048],
                                       fs / 10.0e6)
    dev = devices.SimulatedDevice(dev_samples, snr_db=32, sample_rate=10.0e6)
    sr = devices.StreamingReceiver(
        dev, receiver=DeviceT2Receiver(device="cpu", stream_batch=3, fs=fs),
        acq_seconds=0.025, block_seconds=0.007)
    got = []
    st = sr.run(ts_sink=got.append)
    ts = np.concatenate(got) if got else np.zeros(0, np.uint8)
    assert st.frontend == "DeviceFrontendChain"
    assert sr.chain._rat == (5, 4)
    assert st.frames_decoded == n_play
    assert st.ts_errors == 0 and len(ts) > 0
    np.testing.assert_array_equal(ts, flat[:len(ts)])


def test_stream_unsupported_rate_keeps_host_chain(caplog):
    """A ratio the device chain refuses falls back to the documented host
    chain, as in the JAX package, and the fallback is logged."""
    _, samples = _waveform(2)
    dev = devices.SimulatedDevice(samples, snr_db=32, sample_rate=9.5e6)
    sr = devices.StreamingReceiver(dev, receiver=DeviceT2Receiver(device="cpu"),
                                   acq_seconds=0.025, block_seconds=0.007)
    with caplog.at_level("WARNING"):
        st = sr.run()
    assert st.frontend == "CorrectorChain"
    assert type(sr.chain) is hostfe.CorrectorChain
    assert any("on the host" in r.getMessage() for r in caplog.records)


def test_stream_other_chain_errors_are_not_swallowed(monkeypatch):
    """Only the refused ratio moves the correction to the host: any other
    ValueError from the chain's constructor reaches the caller."""
    def broken(num, den, half=8):
        raise ValueError("no polyphase bank")
    monkeypatch.setattr(tf, "make_rational_resampler", broken)
    _, samples = _waveform(2)
    dev = devices.SimulatedDevice(samples, snr_db=32, sample_rate=10.0e6)
    with pytest.raises(ValueError, match="no polyphase bank"):
        devices.StreamingReceiver(
            dev, receiver=DeviceT2Receiver(device="cpu")).run()
