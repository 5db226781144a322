"""The readings that the tolerance limits are set from: the program's,
and the control's (the reference in the program's place one precision
below what the configuration states: the tracking state in bfloat16, its
stored intermediates in float8 e4m3), on many seeds in one process, at the
cell's own size.

    python3 -m rxbench.control --workload uk32k.awgn19 --seeds 1,2,3 \\
        --control-seeds 1,2,3

One JSON line per seed and side on standard output: {"seed", "side":
"program" | "control", "correct": the harness's own verdict
(`check.verdict`) on the cell's limits, and the numbers}.  Each seed
builds the cell's inputs and the program as a run does, runs one check
step (the timed entry at the timed size) and compares its sampled frames;
the benchmark's own runs never run the control.  Exits 3 without a
card."""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from . import cells, check, stream


def stream_readings(wl: dict, cfg: dict, seed: int, control: bool,
                    device) -> list[dict]:
    """A live-path cell: the program's numbers from a run with a window of
    one block, and the control's (`stream.control_numbers`)."""
    out = stream.execute(wl, cfg, seed, 0.0, False, device,
                         time.perf_counter())
    sides = [("program", out["numbers"])]
    if control:
        sides.append(("control", {**out["numbers"], **stream.control_numbers(
            out["inputs"])}))
    return [{"seed": seed, "side": side,
             "correct": stream.verdict(numbers, wl["limits"])[0], **numbers}
            for side, numbers in sides]


def readings(name: str, seed: int, control: bool, device) -> list[dict]:
    """The program's numbers and verdict on `seed` and, with `control`,
    the control's."""
    _, wl, cfg = cells.specs(name)
    if stream.is_stream(wl):
        return stream_readings(wl, cfg, seed, control, device)
    inputs = cells.Inputs(cfg, wl, seed, device, pool=1)
    prog = cells.Program(inputs)
    frames = sorted(int(f) for f in inputs.sample_rng.choice(
        inputs.frames, min(int(wl["check_frames"]), inputs.frames),
        replace=False))
    got = check.capture(prog, inputs.pool[0], frames)
    del prog
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    layer = check.LayerCheck(inputs)
    sides = [("program", layer.numbers(0, frames, got))]
    if control:
        sides.append(("control", layer.numbers(0, frames, control=True)))
    return [{"seed": seed, "side": side,
             "correct": check.verdict(numbers, wl["limits"])[0], **numbers}
            for side, numbers in sides]


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds of the program's readings")
    ap.add_argument("--control-seeds", default="",
                    help="comma-separated seeds (among --seeds) that also "
                         "read the control")
    args = ap.parse_args(argv)
    if device is None:
        if not torch.cuda.is_available():
            print("no CUDA device", file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
    device = torch.device(device)
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    for s in (int(s) for s in args.seeds.split(",")):
        for row in readings(args.workload, s, s in ctl, device):
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
