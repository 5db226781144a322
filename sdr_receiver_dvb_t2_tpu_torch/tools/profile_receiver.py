"""Stage split of the port's `DeviceT2Receiver` on one NVIDIA GPU.

Run from the repository root:

    python -m sdr_receiver_dvb_t2_tpu_torch.tools.profile_receiver

At the headline mode (32K FFT, GI 1/128, PP7 extended, 256QAM C2/3 NORMAL,
128 codewords per frame) it modulates 6 frames on the host and prints,
after a warm-up `receive()` that builds the tables and kernels:

1. `receive()` at CFO +1.2 kHz and 20 dB AWGN: host wall time per stage,
   with `torch.cuda.synchronize()` around the device stages so their time
   lands in them;
2. the same `receive()` under `torch.profiler`: device time against wall
   time (the busy share) and the kernels that take the most device time;
3. streaming through `io.devices.StreamingReceiver` (`SimulatedDevice`,
   30 dB, `stream_batch=2`: two frames per-frame, then F=2 batched
   supersteps): the run's own stage metrics and the stage split of (1).

The wrappers add two synchronisations per device stage, so the times of
(1) and (3) are upper bounds of the unwrapped receiver's; (2) runs
unwrapped.
"""
import collections
import sys
import time

import numpy as np
import torch

FRAMES = 6
SEED = 3


class StageTimer:
    """Host wall time per stage, by wrapping an attribute of a class or a
    module; a device stage is bracketed by `torch.cuda.synchronize()`."""

    def __init__(self):
        self.times = collections.defaultdict(list)    # tag -> s per call
        self._wrapped = []

    def wrap(self, owner, name: str, tag: str, device: bool) -> None:
        inner = getattr(owner, name)

        def timed(*args, **kwargs):
            if device:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return inner(*args, **kwargs)
            finally:
                if device:
                    torch.cuda.synchronize()
                self.times[tag].append(time.perf_counter() - t0)
        setattr(owner, name, timed)
        self._wrapped.append((owner, name, inner))

    def unwrap(self) -> None:
        for owner, name, inner in reversed(self._wrapped):
            setattr(owner, name, inner)
        self._wrapped.clear()

    def reset(self) -> None:
        self.times.clear()

    def report(self) -> None:
        """Mean per call, then every call in order: a first call carries
        what is built or loaded once."""
        for tag in sorted(self.times, key=lambda t: -sum(self.times[t])):
            ts = self.times[tag]
            print(f"  {tag:34s} {1e3 * sum(ts) / len(ts):9.3f} ms/call "
                  f"x{len(ts):<3d} total {1e3 * sum(ts):9.2f} ms; calls "
                  + " ".join(f"{1e3 * t:.2f}" for t in ts))


def wrap_stages(timer: StageTimer) -> None:
    """The receiver's stages: device work in the port, host work in the
    port's host modules that the receiver calls."""
    from ..ops import frontend_device as fdev
    from ..rx import device_receiver as tdr
    from ..rx import frontend as hostfe
    from ..rx import fusedpath as tfp
    for owner, name, tag, device in (
            (tfp.FusedFrameDemod, "__call__", "demod (device)", True),
            (tfp.FusedPLPPath, "__call__", "PLP LLRs (device)", True),
            (tfp.MultiFramePath, "__call__", "batched demod+LLRs (device)",
             True),
            (tdr.DeviceT2Receiver, "_decode_bits", "LDPC + bits to host",
             True),
            (tdr.rxp1, "measure_p1", "P1 timing (host)", False),
            (tdr.l1mod, "l1post_decode_hard", "L1 decode (host)", False),
            (tdr.rxdecode, "estimate_noise_var_l1", "noise estimate (host)",
             False),
            (tdr.fec_device, "bch_correct_batch", "BCH (host)", False),
            (tdr.bbframe, "scramble", "descramble (host)", False),
            (tdr.bbframe.TSAssembler, "push_frames", "TS assembly (host)",
             False),
            (fdev.DeviceFrontendChain, "process", "device front end",
             True),
            (hostfe.CorrectorChain, "process", "host front end", False),
            (tdr.DeviceT2Receiver, "_decode_frame", "_decode_frame in all",
             False),
            (tdr.DeviceT2Receiver, "decode_frames_batch",
             "decode_frames_batch in all", False)):
        timer.wrap(owner, name, tag, device)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: this tool profiles the receiver on the card")
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ..io import devices
    from ..tx.modulator import apply_cfo, awgn
    from ..rx.device_receiver import DeviceT2Receiver
    from ..utils import benchgen as bg

    p, plp = bg.headline_mode(128)
    ts, frames, _ = bg.modulate(p, plp, FRAMES, seed=SEED)
    clean = np.concatenate(frames)
    noisy = awgn(apply_cfo(clean, bg.CFO_HZ), 20.0, seed=SEED)
    warm = noisy[:3 * p.frame_samples]

    timer = StageTimer()
    wrap_stages(timer)
    rx = DeviceT2Receiver(device="cuda")
    rx.receive(warm)
    timer.reset()
    t0 = time.perf_counter()
    res = rx.receive(noisy)
    wall = time.perf_counter() - t0
    print(f"[receive 20 dB] {FRAMES} frames in {wall:.3f} s, frames "
          f"decoded {res.stats.frames_decoded}, TS errors "
          f"{res.stats.ts_errors}")
    timer.report()
    timer.unwrap()

    rx = DeviceT2Receiver(device="cuda")
    rx.receive(warm)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rx.receive(noisy)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    averages = prof.key_averages()
    # device-side events only: an operator's row repeats its kernels' time
    busy = sum(e.self_device_time_total for e in averages
               if e.device_type == DeviceType.CUDA) / 1e3
    print(f"[profiler receive 20 dB] wall {1e3 * wall:.1f} ms, device self "
          f"time {busy:.1f} ms ({100 * busy / (1e3 * wall):.1f}% busy)")
    print(averages.table(sort_by="self_device_time_total", row_limit=12))

    wrap_stages(timer)
    timer.reset()
    rx = DeviceT2Receiver(device="cuda", stream_batch=2)
    got = []
    t0 = time.perf_counter()
    st = devices.StreamingReceiver(
        devices.SimulatedDevice(clean, snr_db=30), receiver=rx).run(
            ts_sink=got.append)
    wall = time.perf_counter() - t0
    out = np.concatenate(got) if got else np.zeros(0, np.uint8)
    print(f"[streaming stream_batch=2, {st.frontend}] {wall:.3f} s, frames "
          f"{st.frames_decoded}, supersteps {rx.batch_supersteps}, TS "
          f"bit-exact {np.array_equal(out, ts[:len(out)])}")
    for name, stage in st.metrics.stages.items():
        print(f"  metrics {name:14s} calls {stage.calls:3d} "
              f"{1e3 * stage.seconds:9.2f} ms")
    timer.report()
    timer.unwrap()
    foreign = sorted(m for m in sys.modules if m.split(".")[0] in
                     ("jax", "jaxlib", "sdr_receiver_dvb_t2_tpu"))
    print(f"jax or JAX-package modules loaded: {foreign[:5]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
