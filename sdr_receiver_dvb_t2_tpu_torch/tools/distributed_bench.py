"""Weak scaling of the sharded receive step across processes.

Port of the repository's `tools/distributed_bench.py`, with its child
(`tests/dist_child_fused.py`) inside it as `--_child`, and of
`tools/scaling_bench.py`'s sweep (`--procs`): torch has no virtual
devices, so ranks are processes, one device each (rank r on cuda:r with
NCCL, or the CPU with gloo).

For each n of `--procs`, n ranks join one process group.  Every rank
modulates the same frames from a seed (8K GI 1/32 PP1, 16QAM C1/2 SHORT,
3 blocks, n x `--frames` frames), keeps its own `--frames`, runs
`parallel.sharding.sharded_fused_step` on them (MultiFramePath, the f32
flooding decoder at 8 iterations, the stats all-reduce) and writes its
bits and stats to `--out-dir` (`n{n}_rank{r}.npz`).  Fixed work per rank:
ideal weak scaling keeps the step time flat as n grows.  On the CPU each
rank is pinned to its own core with one thread, so n=1 and n=2 compare
the program, not the host's oversubscription.

Prints one JSON line: per n, each rank's median step ms and the weak
scaling efficiency (the n=1 time over the slowest rank's).

    python -m sdr_receiver_dvb_t2_tpu_torch.tools.distributed_bench \\
        [--procs 1,2] [--frames 2] [--reps 5] [--device cuda|cpu] \\
        [--out-dir DIR]
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from .._device import resolve
from ..parallel import sharding

ROOT = pathlib.Path(__file__).resolve().parents[2]
NUM_BLOCKS = 3
LDPC_ITERS = 8
INV_NVAR = 1.0e3        # clean loopback: a high-confidence LLR scale
SEED = 11
MODE = "8K GI1/32 PP1 QAM16 C1/2 short, 3 blocks, sharded_fused_step"


def mode():
    from ..dvbt2.params import (
        CodeRate, Constellation, FECFrame, FFTMode, GuardInterval,
        PilotPattern, PLPParams, T2Params)
    p = T2Params(fft_mode=FFTMode.FFT_8K, guard=GuardInterval.GI_1_32,
                 pilot_pattern=PilotPattern.PP1, extended_carrier=False,
                 n_data=9)
    plp = PLPParams(constellation=Constellation.QAM16, rate=CodeRate.C1_2,
                    fec_frame=FECFrame.SHORT, num_blocks_max=NUM_BLOCKS,
                    time_il_length=1)
    return p, plp


def frame_bodies(p, plp, n_frames: int) -> np.ndarray:
    """(n_frames, len_frame*symbol_size, 2) f32: the P1-stripped bodies of
    n_frames frames modulated from a seeded TS."""
    from ..rx import p1_detect
    from ..tx.modulator import T2Modulator
    mod = T2Modulator(p, [plp])
    rng = np.random.default_rng(SEED)
    ts = rng.integers(0, 256, (mod.packets_needed(n_frames) + 4, 188)
                      ).astype(np.uint8)
    ts[:, 0] = 0x47
    ts[:, 1] &= 0x7F
    samples = mod.modulate(ts.reshape(-1), n_frames).samples
    blen = p.len_frame * p.symbol_size
    bodies = np.empty((n_frames, blen, 2), np.float32)
    for k in range(n_frames):
        b = samples[k * p.frame_samples + p1_detect.P1_LEN:
                    k * p.frame_samples + p1_detect.P1_LEN + blen]
        bodies[k, :, 0] = b.real
        bodies[k, :, 1] = b.imag
    return bodies


def child(rank: int, world: int, addr: str, fpd: int, reps: int,
          device: str, out_dir: str) -> dict:
    """One rank: join the group, run the sharded step on this rank's
    frames, write bits and stats, -> the JSON record it prints."""
    if device == "cuda":
        dev = torch.device("cuda", rank)
    else:
        # identical resources per rank at every n: one core, one thread
        cpus = sorted(os.sched_getaffinity(0))
        os.sched_setaffinity(0, {cpus[rank % len(cpus)]})
        torch.set_num_threads(1)
        dev = torch.device("cpu")
    with sharding.rank_group(rank, world, addr, device):
        p, plp = mode()
        local = frame_bodies(p, plp, world * fpd)[rank * fpd:
                                                  (rank + 1) * fpd]
        step = sharding.sharded_fused_step(
            p, plp, NUM_BLOCKS, frames_per_device=fpd,
            mesh=sharding.make_mesh(world), ldpc_iters=LDPC_ITERS)
        x = torch.from_numpy(local).to(dev)
        bits, stats = step(x, INV_NVAR)
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            bits, stats = step(x, INV_NVAR)
            stats.cpu()                 # waits for the step's device work
            times.append(time.perf_counter() - t0)
        np.savez(os.path.join(out_dir, f"n{world}_rank{rank}.npz"),
                 bits=bits.cpu().numpy(), stats=stats.cpu().numpy())
        return {"rank": rank, "world": world,
                "stats": [float(v) for v in stats.cpu()],
                "expected_codewords": world * fpd * NUM_BLOCKS,
                "step_ms": 1e3 * float(np.median(times))}


def run_cluster(n: int, fpd: int, reps: int, device: str, out_dir: str,
                timeout: float = 900.0) -> list[dict]:
    """Start n `--_child` ranks and wait for them; a rank that fails or
    outlasts `timeout` seconds makes this raise (the others are killed).
    -> each rank's record."""
    addr = sharding.free_addr()
    procs = [subprocess.Popen(
        [sys.executable, "-m", __spec__.name, "--_child", str(r),
         "--world", str(n), "--addr", addr, "--frames", str(fpd),
         "--reps", str(reps), "--device", device, "--out-dir", out_dir],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=str(ROOT), env={**os.environ, "OMP_NUM_THREADS": "1"})
        for r in range(n)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, (out, err) in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"rank failed (rc {p.returncode}):\n"
                               f"{err[-3000:]}")
    return [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--procs", default="1,2",
                    help="process counts to run, comma-separated")
    ap.add_argument("--frames", type=int, default=2,
                    help="frames per rank (fixed work: weak scaling)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out-dir", default=None,
                    help="where the ranks write their bits and stats "
                         "(default: a temporary directory)")
    ap.add_argument("--_child", type=int, default=None, dest="child_rank")
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--addr", default=None)
    args = ap.parse_args(argv)
    resolve(args.device, "distributed_bench", cli=True)
    if args.child_rank is not None:
        print(json.dumps(child(args.child_rank, args.world, args.addr,
                               args.frames, args.reps, args.device,
                               args.out_dir)), flush=True)
        return 0

    procs = [int(v) for v in args.procs.split(",")]
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = args.out_dir or tmp
        os.makedirs(out_dir, exist_ok=True)
        rows = []
        for n in procs:
            recs = run_cluster(n, args.frames, args.reps, args.device,
                               out_dir)
            for r in recs:
                if r["stats"][1] != r["expected_codewords"]:
                    raise RuntimeError(f"n={n}: stats {r['stats']} miss "
                                       f"codewords")
            rows.append({"procs": n, "step_ms_per_rank":
                         [r["step_ms"] for r in recs]})
        base = rows[0]["step_ms_per_rank"][0] if procs[0] == 1 else None
        for row in rows:
            row["weak_scaling_efficiency"] = (
                base / max(row["step_ms_per_rank"]) if base else None)
        print(json.dumps({
            "mode": MODE, "device": args.device,
            "card": (torch.cuda.get_device_name(0)
                     if args.device == "cuda" else None),
            "frames_per_rank": args.frames, "reps": args.reps,
            "host_cores": os.cpu_count(), "results": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
