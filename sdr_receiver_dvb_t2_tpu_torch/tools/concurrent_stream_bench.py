#!/usr/bin/env python
"""Two-process streaming measurement: two ranks of a gloo group
(`parallel/streaming.py`) stream one capture, and the TS is held against a
single-process decode of the same capture.  After the JAX repository's
`tools/concurrent_stream_bench.py`.

  concurrent (default): both ranks decode adjacent time slices of one
      impaired capture (CFO 600 Hz, SCO +20 ppm, 30 dB) at the same time,
      exchanging BB rows, residual CFO/SCO and the merged tracking state
      every round; rank 0's TS against `receive()` of the whole capture
      in one process.
  --handoff: rank 0 streams the head and hands its checkpoint to rank 1,
      which streams the tail; the joined TS against one process's
      `StreamingReceiver` run of the whole capture.

The single-process reference runs in this process once the ranks have
ended, as the JAX tool runs it, so no walltime is taken under another
decode's load.
Prints one JSON line: the JAX tool's section (per-round walltimes, wall
times, CFO history, bit-exactness, TS errors) with the mode, the receiver
and the ranks' kernel launches.  Exit 1 unless the TS is bit-exact.  It
writes no SCALING.json (that file is the JAX package's); `--out` writes
the section to a file.

Usage: python -m sdr_receiver_dvb_t2_tpu_torch.tools.concurrent_stream_bench
[--frames 8] [--handoff] [--device cuda|cpu] [--receiver host|device]
[--mode test|headline] [--out FILE]
(on the card both ranks share cuda:0; on the CPU each rank is pinned to
one core, as the JAX tool pins them with taskset).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

from .._device import resolve
from ..parallel import sharding, streaming


def _exact(ts: np.ndarray, ref: np.ndarray) -> bool:
    """The JAX tool's rule: at most two packets short of the reference,
    and equal to its prefix."""
    return bool(len(ts) > 0 and len(ts) >= len(ref) - 2 * 188
                and np.array_equal(ts, ref[:len(ts)]))


def _run_ranks(fn, args, device, reference):
    """Run the two ranks of fn(*args, out_dir) to their end, then
    `reference()` here, so that neither is timed under the other's load.
    -> (results by rank, reference())."""
    with tempfile.TemporaryDirectory() as tmp:
        sharding.launch(2, fn, *args, tmp, device=device, backend="gloo")
        rs = streaming.read_results(tmp)
        for r in rs.values():
            if "ts_file" in r:
                r["ts"] = np.fromfile(r.pop("ts_file"), np.uint8)
    return rs, reference()


def run_handoff(mode="test", receiver="host", device="cuda", frames=8,
                reference=True) -> dict:
    """The handoff mechanism on two ranks.  -> the section, with "ts" (the
    joined TS) and, with `reference`, "ts_ref" (one process's stream)."""
    from ..io import devices
    dev = resolve(device, "concurrent_stream_bench")
    cfg = streaming.STREAM[mode]
    t0 = time.perf_counter()
    _, samples = streaming.handoff_capture(frames, mode)
    t_cap = time.perf_counter() - t0

    def single():
        if not reference:
            return None
        got = []
        t = time.perf_counter()
        st = devices.StreamingReceiver(
            devices.SimulatedDevice(samples, snr_db=streaming.SNR_DB),
            receiver=streaming.make_receiver(receiver, dev),
            acq_seconds=cfg["acq_seconds"],
            block_seconds=cfg["block_seconds"]).run(ts_sink=got.append)
        ts = np.concatenate(got) if got else np.zeros(0, np.uint8)
        return ts, int(st.frames_decoded), time.perf_counter() - t

    with tempfile.TemporaryDirectory() as cap_dir:
        cap = os.path.join(cap_dir, "capture.npy")
        np.save(cap, samples)
        rs, ref = _run_ranks(streaming.handoff_rank,
                             (mode, receiver, device, cap), device, single)
    ts = np.concatenate([rs[0]["ts"], rs[1]["ts"]])
    sec = {
        "mechanism": "handoff", "mode": mode, "receiver": receiver,
        "device": str(dev), "frames": frames, "capture_s": t_cap,
        "frames_by_rank": {str(r): rs[r]["frames"] for r in rs},
        "ts_packets_by_rank": {str(r): rs[r]["ts_packets"] for r in rs},
        "ts_errors": sum(rs[r]["ts_errors"] for r in rs),
        "frontend": {str(r): rs[r]["frontend"] for r in rs},
        "wall_s": {str(r): rs[r]["wall_s"] for r in rs},
        "launches": {str(r): rs[r]["launches"] for r in rs},
        "ts": ts}
    if ref is not None:
        sec.update(ts_ref=ref[0], single_frames=ref[1], single_wall_s=ref[2],
                   ts_bit_exact_vs_single_process=_exact(ts, ref[0]))
    return sec


def run_concurrent(mode="test", receiver="host", device="cuda", frames=8,
                   reference=True) -> dict:
    """The concurrent mechanism on two ranks.  -> the JAX tool's section,
    with "ts" (rank 0's TS) and, with `reference`, "ts_ref" (the
    single-process `receive()` of the capture)."""
    dev = resolve(device, "concurrent_stream_bench")
    if frames % (2 * streaming.G):
        raise ValueError(f"frames must fill whole rounds "
                         f"({2 * streaming.G} per round)")
    t0 = time.perf_counter()
    x, _ = streaming.capture(frames, mode)
    t_cap = time.perf_counter() - t0

    def single():
        if not reference:
            return None
        t = time.perf_counter()
        # tail pad: the SCO resample otherwise eats the final frame's margin
        res = streaming.make_receiver(receiver, dev).receive(
            np.concatenate([x, np.zeros(2048, np.complex64)]))
        return res.ts, int(res.stats.frames_decoded), time.perf_counter() - t

    with tempfile.TemporaryDirectory() as cap_dir:
        cap = os.path.join(cap_dir, "capture.npy")
        np.save(cap, x)
        rs, ref = _run_ranks(streaming.concurrent_rank,
                             (mode, receiver, device, cap, frames), device,
                             single)
    sec = {
        "description": "both ranks decode adjacent time slices of one "
                       "continuous impaired capture (CFO 600 Hz, SCO "
                       "+20 ppm, 30 dB) CONCURRENTLY, exchanging BB rows "
                       "+ residual CFO/SCO + merged tracking state every "
                       "round over a gloo group; rank 0 owns the single "
                       "TS assembler",
        "mechanism": "concurrent", "mode": mode, "receiver": receiver,
        "device": str(dev), "frames": frames, "capture_s": t_cap,
        "rounds": len(rs[0]["rounds"]),
        "round_walltimes_s": {str(r): rs[r]["rounds"] for r in (0, 1)},
        "wall_s": {str(r): rs[r]["wall_s"] for r in (0, 1)},
        "cfo_history_hz": rs[0]["cfo_history"],
        "cfo_history_equal": rs[0]["cfo_history"] == rs[1]["cfo_history"],
        "ts_errors": rs[0]["ts_errors"],
        "launches": {str(r): rs[r]["launches"] for r in (0, 1)},
        "frames_by_rank": {str(r): rs[r]["frames"] for r in (0, 1)},
        "ts": rs[0]["ts"]}
    if ref is not None:
        sec.update(ts_ref=ref[0], single_frames=ref[1], single_wall_s=ref[2],
                   ts_bit_exact_vs_single_process=_exact(rs[0]["ts"],
                                                         ref[0]))
    return sec


def public(sec: dict) -> dict:
    """The section without its TS arrays (what the tool prints)."""
    return {k: v for k, v in sec.items() if k not in ("ts", "ts_ref")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--handoff", action="store_true",
                    help="the checkpoint handoff instead of the "
                         "concurrent slices")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--receiver", choices=streaming.RECEIVERS,
                    default="device")
    ap.add_argument("--mode", choices=streaming.MODES, default="headline")
    ap.add_argument("--out", default=None,
                    help="also write the section to this JSON file")
    args = ap.parse_args(argv)
    run = run_handoff if args.handoff else run_concurrent
    sec = public(run(args.mode, args.receiver, args.device, args.frames))
    line = json.dumps(sec)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0 if sec["ts_bit_exact_vs_single_process"] else 1


if __name__ == "__main__":
    sys.exit(main())
