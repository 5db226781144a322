"""Run one cell of the benchmark of the PyTorch and CUDA port: raw impaired
DVB-T2 samples to transport-stream bytes on the host, on one H100.

    python3 -m rxbench.run --workload uk32k.awgn19 --seed 7 --seconds 30 \\
        --trace 0

Set-up (counted in `setup_s`, from process start): the cell's files, the
host encoding of the base frame, the pool of impaired step inputs made on
the card, the program's superstep and its acquisition, and one warm step
per pool entry.  The window: a closed loop of `Superstep.__call__` steps
over the pool, each step's bytes of every frame fetched to the host before
the step counts, for --seconds.  Then the comparison that decides
`correct` (`check.py`) and, with --trace 1, the per-layer metrics of the
traced run (`trace.py`, `layer_metrics/`).

Standard output's last line is the result: correct, attempted and failed
(frames), the metrics (--trace 0: the cell's end-to-end metrics, --trace
1: its per-layer metrics), the device, the breakdown (--trace 1) and, last,
every number compared beside its limit.  Standard error's last lines give
the same numbers and limits.  With no CUDA device, or fewer than the cell
asks for, it exits 3 and prints no result; if a module named jax, jaxlib,
flax or sdr_receiver_dvb_t2_tpu is loaded once the window has closed, it
exits 4 and prints no result."""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse                                              # noqa: E402
import contextlib                                            # noqa: E402
import gc                                                    # noqa: E402
import importlib.util                                        # noqa: E402
import json                                                  # noqa: E402
import subprocess                                            # noqa: E402
import sys                                                   # noqa: E402

import torch                                                 # noqa: E402

from . import cells, check, stream, trace                    # noqa: E402

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "sdr_receiver_dvb_t2_tpu"})
SAMPLED_FROM = 16             # the steps compared in full are drawn
                              # from the window's first SAMPLED_FROM
PROFILE_FROM = 1              # traced run: every window step from this one
PROFILE_CHUNK = 8             # steps to one profiling session; each
                              # session's trace is read before the next


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared as whole names (the port's name begins with the JAX
    package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def reader(kind: str, name: str):
    """The `read(record)` of metric `name`: `rxbench/<kind>/<name>.py`."""
    path = cells.HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"rxbench_{kind}_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(kind: str, cell: str) -> list[dict]:
    """BENCHMARK.json's metrics of `kind` that cell `cell` reports."""
    return [m for m in cells.bench_spec()[kind]
            if "workloads" not in m or cell in m["workloads"]]


def read_metrics(cell: str, tracing: bool, rec: dict) -> dict:
    """The cell's end-to-end metrics (untraced) or per-layer metrics
    (traced) that their readers find in the run's record."""
    kind = "per_layer" if tracing else "end_to_end"
    metrics = {}
    for m in cell_metrics(kind, cell):
        v = reader("layer_metrics" if tracing else "end_to_end",
                   m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    return metrics


def emit(result: dict, table: dict) -> int:
    """Print the result line, the numbers compared last on standard error;
    exit 4 with no result where JAX or the JAX package is loaded."""
    found = forbidden_modules()
    if found:
        log(f"modules of JAX or the JAX package loaded: {found}")
        return 4
    for name, row in table.items():
        log(f"check {name}: {row['value']} (limit {row['limit']})")
    print(json.dumps(result), flush=True)
    return 0


def run_stream(args, wl: dict, cfg: dict, device, patch) -> int:
    """A cell on the live receive path (`stream.py`)."""
    on_card = device.type == "cuda"
    out = stream.execute(wl, cfg, args.seed, args.seconds, bool(args.trace),
                         device, T0, patch)
    rec, info = out["rec"], out["info"]
    log(f"set-up {rec['setup_s']:.2f} s: " + ", ".join(
        f"{k} {v:.2f}" for k, v in out["setup_parts"].items()))
    card = card_line() if on_card else "cpu"
    log(f"window: {info['window_blocks']} blocks, {info['window_frames']} "
        f"frames in {rec['window_s']:.3f} s; peak device memory "
        f"{out['peak']} bytes; {card}")
    for name, sec in out["device_ops"]:
        log(f"device op {sec:.6f} s: {name}")
    correct, table = stream.verdict(out["numbers"], wl["limits"])
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": out["peak"]}
    result = {"correct": correct, "attempted": info["window_frames"],
              "failed": out["failed"],
              "metrics": read_metrics(args.workload, bool(args.trace), rec),
              "device": dev}
    if args.trace:
        tr = rec["trace"]
        dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["window_s"]
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    result["card"] = card
    result["stream"] = info
    result["setup_parts_s"] = out["setup_parts"]
    result["checks"] = table
    return emit(result, table)


def main(argv=None, device=None, patch=None) -> int:
    """Run a cell and print its result.  `device` (tests only) skips the
    look for a card and runs there; `patch(program)` (tests only) is
    called on the program before the warm-up."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    entry, wl, cfg = cells.specs(args.workload)
    if device is None:
        chips = int(entry["chips"])
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < chips:
            log(f"{args.workload} needs {chips} CUDA device(s); found "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 3
        device = torch.device("cuda", 0)
    device = torch.device(device)
    on_card = device.type == "cuda"
    log(f"[{args.workload}] seed {args.seed}, {args.seconds:g} s, trace "
        f"{args.trace}")
    if stream.is_stream(wl):
        return run_stream(args, wl, cfg, device, patch)

    t_in = time.perf_counter()
    inputs = cells.Inputs(cfg, wl, args.seed, device)
    t_prog = time.perf_counter()
    prog = cells.Program(inputs)
    if patch is not None:
        patch(prog)
    log(f"tracking estimate errors ({prog.acq_tries} acquisition "
        f"captures): " + ", ".join(f"{k} {v:+.4f}"
                                   for k, v in prog.track_err.items()))
    t_warm = time.perf_counter()
    for raw in inputs.pool:
        prog(raw)
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T0
    setup_parts = {"imports and files": t_in - T0,
                   "inputs (host encoding, pool on the card)": t_prog - t_in,
                   **prog.seconds,
                   "warm steps": time.perf_counter() - t_warm}
    log(f"set-up {setup_s:.2f} s: " + ", ".join(
        f"{k} {v:.2f}" for k, v in setup_parts.items()))

    tracing = bool(args.trace)
    n_pool, n_frames = len(inputs.pool), inputs.frames
    step_ms, step_sweeps, records, kept, all_marks = [], [], [], [], []
    rng = inputs.sample_rng
    # steps whose bytes are compared in full, each fetched into a host
    # buffer of its own
    sampled = {int(i): j + 1 for j, i in enumerate(sorted(rng.choice(
        SAMPLED_FROM, cells.HOST_SLOTS, replace=False)))}
    last = [0]
    state = {"sweeps": 0, "steps": 0}
    ranged = (torch.autograd.profiler.record_function if tracing
              else lambda name: contextlib.nullcontext())

    def one():
        i = state["steps"]
        k = i % n_pool
        marks = trace.Marks(timed=on_card) if tracing else None
        t0 = time.perf_counter()
        with ranged("rx.step"):
            if marks:
                marks.start()
            out = prog.issue(inputs.pool[k], mark=marks)
            if marks:
                marks.finish()
        slot = sampled.get(i, 0)
        with ranged("rx.fetch"):
            sums, oks, it, _ = prog.fetch(out, slot)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        records.append((k, sums, oks))
        state["sweeps"] += it
        step_sweeps.append(it)
        state["steps"] = i + 1
        if marks:
            all_marks.append(marks)
        if slot:
            kept.append((k, slot))
        last[0] = k

    prof = trace.Profile() if tracing else None
    t_w0 = time.perf_counter()

    def more() -> bool:
        return (state["steps"] == 0
                or time.perf_counter() - t_w0 < args.seconds)

    def chunk():
        one()
        for _ in range(PROFILE_CHUNK - 1):
            if not more():
                break
            one()

    # a traced run traces one step at least
    while more() or (tracing and not prof.steps):
        if tracing and state["steps"] >= PROFILE_FROM:
            first = state["steps"]
            prof.run(chunk)
            prof.steps += range(first, state["steps"])
            continue
        one()
    window_s = time.perf_counter() - t_w0
    peak = 0
    if on_card:
        torch.cuda.synchronize()
        peak = int(torch.cuda.max_memory_allocated(device))
    frames = state["steps"] * n_frames
    card = card_line() if on_card else "cpu"
    log(f"window: {state['steps']} steps, {frames} frames in {window_s:.3f} "
        f"s; peak device memory {peak} bytes; {card}")

    # the bytes compared in full; a window shorter than the sampled steps
    # compares its last step
    kept = ([(k, prog.host[slot].numpy()) for k, slot in kept] if kept
            else [(last[0], prog.host[0].numpy().copy())])
    # the check steps (the timed entry, after the window), then the
    # reference with the program's state freed
    sel = [sorted(int(f) for f in rng.choice(
        n_frames, min(int(wl["check_frames"]), n_frames), replace=False))
        for _ in range(n_pool)]
    captured = [check.capture(prog, inputs.pool[k], sel[k])
                for k in range(n_pool)]
    stage_ms = {}
    for m in all_marks:
        for stage, ms in m.stage_ms().items():
            stage_ms[stage] = stage_ms.get(stage, 0.0) + ms
    track_err = prog.track_err
    acq_tries = prog.acq_tries
    del prog, all_marks
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    layer = check.LayerCheck(inputs)
    numbers = {}
    for k in range(n_pool):
        for name, v in layer.numbers(k, sel[k], captured[k]).items():
            numbers[name] = check.worst(numbers.get(name), v)
    numbers.update(check.window_numbers(inputs, records, kept))
    correct, table = check.verdict(numbers, wl["limits"])

    rec = {"setup_s": setup_s, "window_s": window_s, "step_ms": step_ms,
           "frames": frames, "samples_per_frame": inputs.p.frame_samples,
           "sweeps": state["sweeps"], "step_sweeps": step_sweeps,
           "stage_ms": stage_ms,
           "trace": prof.result() if tracing else None,
           "code": (inputs.plp.fec_frame, inputs.plp.rate),
           "num_blocks": inputs.nb, "inv_nvar": inputs.inv_nvar,
           "frames_per_step": n_frames}
    metrics = read_metrics(args.workload, tracing, rec)
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": frames,
              "failed": numbers["bad_frames"], "metrics": metrics,
              "device": dev}
    if tracing:
        dev["busy_s"] = rec["trace"]["busy_s"]
        dev["window_s"] = rec["trace"]["window_s"]
        result["breakdown"] = {"device_ops": rec["trace"]["device_ops"],
                               "idle_gaps": rec["trace"]["idle_gaps"]}
    result["card"] = card
    result["tracking_error"] = track_err
    result["acquisition_captures"] = acq_tries
    result["setup_parts_s"] = setup_parts
    result["checks"] = table
    return emit(result, table)


if __name__ == "__main__":
    sys.exit(main())
