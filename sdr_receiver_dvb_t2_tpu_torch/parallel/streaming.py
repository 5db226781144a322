"""Two-process streaming of one capture over `torch.distributed`.

Port of the JAX package's two streaming mechanisms across a process
boundary, `tests/dist_child_stream.py` and `tests/dist_child_stream2.py`
(there on `jax.distributed`, here on a gloo group: the state that crosses
is host bytes, so both ranks may share one card, `sharding.launch(...,
backend="gloo")`):

  - handoff (`handoff_rank`): rank 0 streams the head of the capture and
    hands its receiver state (the raw sample offset of the next frame, the
    CFO/SCO corrector state, the TS SYNCD continuation: the streaming
    checkpoint) to rank 1, which resumes from it and streams the tail.
    The checkpoint crosses as bytes, padded to STATE_BYTES with its length
    in front, in one broadcast.  Joined, the two TS outputs equal one
    process's stream of the whole capture.
  - concurrent (`concurrent_rank`): both ranks decode adjacent time slices
    of one impaired capture at the same time, G frames each per round;
    after each round rank 1 sends its slice's BB rows and its residual
    CFO/SCO to rank 0, and rank 0 sends back the merged tracking state both
    use for the next round.  Rank 0 owns the one TS assembler: it pushes
    its own rows, then its partner's, so the SYNCD chain lives in one
    assembler and the TS equals a single-process decode of the capture.

The receiver is a parameter (`make_receiver`): the host `rx/receiver.
T2Receiver` (the JAX children's) or `rx/device_receiver.DeviceT2Receiver`
on the rank's device, as the JAX `StreamingReceiver(receiver=...)` takes
either.  So is the mode (`stream_mode`): the JAX children's 8K PP1 16QAM
C1/2 SHORT with 3 blocks, or the bench's headline mode (32K, 256QAM C2/3
NORMAL, 128 blocks), where `DeviceT2Receiver` decodes with the K2 kernel
(3 blocks take its flooding decoder).  `decode_slice` builds a fresh
receiver per slice, as JAX does: its per-instance paths and decoders are
rebuilt (host tables, ~0.2 s at the headline mode), while the frame demod
is cached per mode in `rx/fusedpath.get_fused_demod`.  Reusing one
receiver would carry its noise estimate from slice to slice and change
the results.

Each rank writes its result to `out_dir` (`rank{r}.json`, the TS bytes
beside it): spawned ranks return nothing to their parent.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

FS = 9142857.142857143     # elementary sample rate (8 MHz channel)
STATE_BYTES = 8192         # the handoff checkpoint's room
CFO_TRUE = 600.0           # the concurrent capture's impairments
SCO_TRUE = 2.0e-5
G = 2                      # frames per slice
MODES = ("test", "headline")
RECEIVERS = ("host", "device")
# streaming settings per mode: acquisition and block lengths (s), blocks
# rank 0 streams before the handoff
STREAM = {"test": dict(acq_seconds=0.025, block_seconds=0.007, head=5),
          "headline": dict(acq_seconds=0.55, block_seconds=0.25, head=4)}
SNR_DB = 32.0              # the handoff capture's SimulatedDevice noise


def stream_mode(mode: str):
    """-> (T2Params, PLPParams) of "test" (the JAX children's 8K mode) or
    "headline" (`utils/benchgen.headline_mode(128)`)."""
    from ..dvbt2.params import (CodeRate, Constellation, FECFrame, FFTMode,
                                GuardInterval, PilotPattern, PLPParams,
                                T2Params)
    from ..utils import benchgen
    if mode == "headline":
        return benchgen.headline_mode(128)
    if mode != "test":
        raise ValueError(f"mode {mode!r} is not one of {MODES}")
    p = T2Params(fft_mode=FFTMode.FFT_8K, guard=GuardInterval.GI_1_32,
                 pilot_pattern=PilotPattern.PP1, extended_carrier=False,
                 n_data=9)
    plp = PLPParams(constellation=Constellation.QAM16, rate=CodeRate.C1_2,
                    fec_frame=FECFrame.SHORT, num_blocks_max=3,
                    time_il_length=1)
    return p, plp


def make_receiver(kind: str, device):
    """A fresh receiver: "host" (`T2Receiver`, NumPy) or "device"
    (`DeviceT2Receiver` on `device`)."""
    if kind == "host":
        from ..rx.receiver import T2Receiver
        return T2Receiver()
    if kind == "device":
        from ..rx.device_receiver import DeviceT2Receiver
        return DeviceT2Receiver(device=device)
    raise ValueError(f"receiver {kind!r} is not one of {RECEIVERS}")


def _modulate(mode: str, n_frames: int, seed: int):
    from ..tx.modulator import T2Modulator
    p, plp = stream_mode(mode)
    mod = T2Modulator(p, [plp])
    rng = np.random.default_rng(seed)
    ts = rng.integers(0, 256, (mod.packets_needed(n_frames) + 4, 188)
                      ).astype(np.uint8)
    ts[:, 0] = 0x47
    ts[:, 1] &= 0x7F
    return ts.reshape(-1), mod.modulate(ts.reshape(-1), n_frames).samples, \
        rng, p


def handoff_capture(n_frames: int = 8, mode: str = "test"):
    """The handoff's capture, clean (the streaming device adds its noise):
    -> (ts (bytes,) uint8, samples complex64).  At the test mode it is
    the JAX child's `waveform()` (`test_streaming._waveform(8, seed=5)`)."""
    ts, samples, _, _ = _modulate(mode, n_frames, seed=5)
    return ts, samples


def capture(n_frames: int = 12, mode: str = "test"):
    """The concurrent mechanism's capture, impaired: CFO_TRUE + SCO_TRUE
    (a device clock SCO_TRUE fast) + AWGN 30 dB below the signal.
    -> (x complex64, T2Params).  At the test mode it equals the JAX
    child's `capture(n_frames)` sample for sample."""
    from ..rx import frontend
    _, x, rng, p = _modulate(mode, n_frames, seed=23)
    # device clock +SCO_TRUE: raw sample m sees the signal at m/(1+sco)
    x = frontend.sinc_resample(x, 1.0 / (1.0 + SCO_TRUE))
    n = np.arange(len(x))
    x = (x * np.exp(2j * np.pi * CFO_TRUE * n / FS)).astype(np.complex64)
    sig = float(np.sqrt(np.mean(np.abs(x) ** 2)))
    x = x + (sig * 10 ** (-30 / 20) / np.sqrt(2)
             * (rng.normal(size=len(x)) + 1j * rng.normal(size=len(x)))
             ).astype(np.complex64)
    return x, p


def _slots(plp):
    """(BB rows per slice, bytes per row) of the mode's PLP."""
    return G * plp.num_blocks_max, plp.fec.k_bch // 8


class _BBCollector:
    """A receiver's `regen_sink`: each decoded frame's BB rows
    (descrambled bytes)."""

    def __init__(self, rows: list):
        self.rows = rows

    def start_frame(self, params, l1pre, l1post):
        pass

    def add_bb(self, plp_id, bb):
        self.rows.append(np.packbits(np.asarray(bb, np.uint8), axis=1))

    def mark_bad(self):
        raise AssertionError("FEC failure in concurrent slice decode")


def decode_slice(x, state, s: int, frame_samp: int, receiver: str,
                 device, plp):
    """Decode slice s (frames s*G .. s*G+G-1) of the raw capture with the
    SHARED tracking state (cfo Hz, resample ratio, raw P1 position) and a
    fresh receiver.  -> (rows (G*nb, kbch/8) uint8, residual cfo Hz,
    residual sco)."""
    from ..rx import frontend
    cfo, ratio, p1_raw = state
    fa = p1_raw + (s * G) * frame_samp * ratio
    fb = p1_raw + (s * G + G) * frame_samp * ratio
    a = max(0, int(np.floor(fa)) - 64)
    b = min(len(x), int(np.ceil(fb)) + frame_samp // 2)
    xs = x[a:b]
    if b >= len(x) - 8:
        # capture-end slice: the resampler's tap margin would otherwise
        # eat the last frame's final samples
        xs = np.concatenate([xs, np.zeros(1024, np.complex64)])
    n = np.arange(len(xs)) + a          # absolute phase: slice-invariant
    xs = (xs * np.exp(-2j * np.pi * cfo * n / FS)).astype(np.complex64)
    if abs(ratio - 1.0) > 1e-7:
        xs = frontend.sinc_resample(xs, ratio)
    rx = make_receiver(receiver, device)
    got: list = []
    rx.regen_sink = _BBCollector(got)
    res = rx.receive(xs)
    if res.stats.frames_decoded != G:
        raise RuntimeError(f"slice {s}: {res.stats.frames_decoded} of {G} "
                           "frames decoded")
    fails = sum(ps.ldpc_failures + ps.bch_failures
                for ps in res.stats.plp_stats.values())
    if fails:
        raise RuntimeError(f"slice {s}: FEC failure in the slice decode")
    rows = np.concatenate(got)
    want = _slots(plp)
    if rows.shape != want:
        raise RuntimeError(f"slice {s}: rows {rows.shape}, expected {want}")
    return rows, float(res.stats.cfo_hz), float(res.stats.sco_ppm) * 1e-6


def _broadcast_bytes(buf: np.ndarray, src: int) -> np.ndarray:
    """One broadcast of a uint8 host buffer from rank `src` (every rank
    passes a buffer of the same size) -> the source's bytes."""
    t = torch.from_numpy(np.ascontiguousarray(buf, np.uint8).copy())
    dist.broadcast(t, src=src)
    return t.numpy()


def _f64_bytes(values) -> np.ndarray:
    return np.frombuffer(np.asarray(values, np.float64).tobytes(), np.uint8)


def _launches() -> dict:
    """This process's launch counts of the port's kernels."""
    from ..ops import kernel_wrappers
    return {k: fn.launches for k, fn in kernel_wrappers().items()}


def _rank_device(device: str) -> torch.device:
    """The receiver's device in this rank: the current card (set by
    `sharding.rank_group`) or the CPU."""
    if torch.device(device).type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _pin(device: str, rank: int) -> None:
    """On the CPU, one core per rank (the JAX tool's taskset), so the two
    decodes run side by side."""
    if torch.device(device).type == "cpu" and hasattr(os,
                                                       "sched_setaffinity"):
        cores = sorted(os.sched_getaffinity(0))
        os.sched_setaffinity(0, {cores[rank % len(cores)]})
        torch.set_num_threads(1)


def _write(out_dir: str, rank: int, result: dict, ts=None) -> None:
    if ts is not None:
        result["ts_file"] = os.path.join(out_dir, f"ts{rank}.bin")
        np.asarray(ts, np.uint8).tofile(result["ts_file"])
    result["launches"] = _launches()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)


def read_results(out_dir: str) -> dict:
    """{rank: result} as the two ranks wrote them."""
    out = {}
    for r in range(2):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            out[r] = json.load(f)
    return out


def handoff_rank(mode: str, receiver: str, device: str, capture_path: str,
                 out_dir: str) -> None:
    """One rank of the handoff (in a 2-rank gloo group): rank 0 streams
    the head and broadcasts its checkpoint; rank 1 resumes from it.  The
    capture is `capture_path` (.npy, the clean samples both ranks read).
    Writes rank{r}.json {"pid", "frames", "ts_packets", "wall_s",
    "launches", "ts_file"}; rank 0's TS is cut to the packets the
    checkpoint counts."""
    from ..io import devices
    from ..utils.checkpoint import StreamCheckpoint
    rank = dist.get_rank()
    _pin(device, rank)
    dev = _rank_device(device)
    cfg = STREAM[mode]
    samples = np.load(capture_path)
    ck_path = os.path.join(out_dir, f"handoff_p{rank}.ck")
    got: list = []
    t0 = time.perf_counter()
    kw = dict(acq_seconds=cfg["acq_seconds"],
              block_seconds=cfg["block_seconds"])
    sdev = devices.SimulatedDevice(samples, snr_db=SNR_DB)
    rx = make_receiver(receiver, dev)
    if rank == 0:
        sr = devices.StreamingReceiver(sdev, receiver=rx,
                                       checkpoint_path=ck_path,
                                       checkpoint_every=1, **kw)
        st = sr.run(ts_sink=got.append, max_blocks=cfg["head"])
        with open(ck_path, "rb") as f:
            blob = f.read()
        if len(blob) >= STATE_BYTES:
            raise RuntimeError(f"checkpoint of {len(blob)} bytes")
        pad = np.zeros(STATE_BYTES + 4, np.uint8)
        pad[:4] = np.frombuffer(np.uint32(len(blob)).tobytes(), np.uint8)
        pad[4:4 + len(blob)] = np.frombuffer(blob, np.uint8)
        _broadcast_bytes(pad, src=0)
        ts = np.concatenate(got) if got else np.zeros(0, np.uint8)
        ck = StreamCheckpoint(**json.loads(blob))
        ts = ts[:ck.ts_packets * 188]
    else:
        # block until rank 0's handoff arrives over the process group
        pad = _broadcast_bytes(np.zeros(STATE_BYTES + 4, np.uint8), src=0)
        n = int(np.frombuffer(pad[:4].tobytes(), np.uint32)[0])
        with open(ck_path, "wb") as f:
            f.write(pad[4:4 + n].tobytes())
        sr = devices.StreamingReceiver(sdev, receiver=rx, **kw)
        st = sr.run(ts_sink=got.append, resume=ck_path)
        ts = np.concatenate(got) if got else np.zeros(0, np.uint8)
    _write(out_dir, rank, {
        "pid": rank, "frames": int(st.frames_decoded),
        "ts_packets": len(ts) // 188, "ts_errors": int(st.ts_errors),
        "frontend": st.frontend, "wall_s": time.perf_counter() - t0}, ts)


def concurrent_rank(mode: str, receiver: str, device: str,
                    capture_path: str, n_frames: int, out_dir: str) -> None:
    """One rank of the concurrent mechanism (in a 2-rank gloo group) on
    the impaired capture at `capture_path` (.npy).  Writes rank{r}.json
    {"pid", "frames", "rounds": [per-round decode s], "cfo_history",
    "wall_s", "launches"}, and on rank 0 "ts_file" and "ts_errors"."""
    from ..dvbt2 import bbframe
    rank = dist.get_rank()
    _pin(device, rank)
    dev = _rank_device(device)
    p, plp = stream_mode(mode)
    x = np.load(capture_path)
    frame_samp = p.frame_samples
    n_slices = n_frames // G
    if n_slices % 2:
        raise ValueError("frames must fill whole rounds (2*G per round)")
    n_rows, kb8 = _slots(plp)
    rows_bytes = n_rows * kb8
    t_wall = time.perf_counter()
    # initial acquisition on rank 0, its state broadcast to both; f64
    # crosses as bytes
    if rank == 0:
        ls, cfo_e, ratio_e, _ = make_receiver(receiver, dev).refine_acquire(
            x[:3 * frame_samp])
        if ls is None:
            raise RuntimeError("initial acquisition failed")
        buf = _f64_bytes([cfo_e, ratio_e, float(ls.frame_start) * ratio_e])
    else:
        buf = np.zeros(24, np.uint8)
    state0 = np.frombuffer(_broadcast_bytes(buf, src=0).tobytes(),
                           np.float64)
    state = (float(state0[0]), float(state0[1]), float(state0[2]))
    cfo_history = [state[0]]
    assembler = bbframe.TSAssembler() if rank == 0 else None
    round_times = []
    for r in range(n_slices // 2):
        t0 = time.perf_counter()
        rows, d_cfo, d_sco = decode_slice(x, state, 2 * r + rank, frame_samp,
                                          receiver, dev, plp)
        round_times.append(time.perf_counter() - t0)
        # exchange 1: rank 1's rows and residuals -> rank 0
        buf = np.zeros(rows_bytes + 64, np.uint8)
        if rank == 1:
            buf[:rows_bytes] = rows.reshape(-1)
            buf[rows_bytes:rows_bytes + 16] = _f64_bytes([d_cfo, d_sco])
        got = _broadcast_bytes(buf, src=1)
        if rank == 0:
            partner = got[:rows_bytes].reshape(n_rows, kb8)
            p_cfo, p_sco = np.frombuffer(
                got[rows_bytes:rows_bytes + 16].tobytes(), np.float64)
            # own slice first (earlier frames), then the partner's
            assembler.push_frames(rows)
            assembler.push_frames(partner)
            # both ranks' residuals merged into the next round's state
            new_cfo = state[0] + 0.5 * (d_cfo + p_cfo)
            new_ratio = state[1] * (1.0 + 0.5 * (d_sco + p_sco))
            upd = _f64_bytes([new_cfo, new_ratio, state[2]])
        else:
            upd = np.zeros(24, np.uint8)
        # exchange 2: the merged tracking state -> both
        upd = np.frombuffer(_broadcast_bytes(upd, src=0).tobytes(),
                            np.float64)
        state = (float(upd[0]), float(upd[1]), float(upd[2]))
        cfo_history.append(state[0])
    result = {"pid": rank, "frames": len(round_times) * G,
              "rounds": round_times, "cfo_history": cfo_history,
              "wall_s": time.perf_counter() - t_wall}
    ts = None
    if rank == 0:
        ts = assembler.ts_bytes()
        result["ts_errors"] = int(assembler.errors)
    _write(out_dir, rank, result, ts)
