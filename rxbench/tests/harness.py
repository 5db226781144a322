"""A scratch copy of the benchmark with the CPU test cells added as files
and entries, and runs of it in a fresh process (tests only)."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CELLS = Path(__file__).resolve().parent / "cells"
CELL = "test8k.awgn"


# The per-layer metrics of a live-path cell (`"path": "stream"`), as
# BENCHMARK.json would list them: it holds no such cell yet, so the tests
# add these entries with their test cell.  `device_idle_pct` reads both
# paths.
STREAM_METRICS = [
    {"name": "stream_frontend_ms_per_frame", "unit": "ms", "better": "lower",
     "source": "program_span",
     "layer": "streaming front end (ops/frontend_device.DeviceFrontendChain)",
     "moves": "rx_msamples_per_s"},
    {"name": "stream_track_ms_per_frame", "unit": "ms", "better": "lower",
     "source": "program_span",
     "layer": "host tracking loop (io/devices.StreamingReceiver)",
     "moves": "rx_msamples_per_s"},
    {"name": "stream_decode_ms_per_frame", "unit": "ms", "better": "lower",
     "source": "program_span",
     "layer": "device receiver decode (rx/device_receiver.py)",
     "moves": "rx_msamples_per_s"},
    {"name": "stream_batched_frames_pct", "unit": "%", "better": "higher",
     "source": "program_counter",
     "layer": "device receiver decode (rx/device_receiver.py)",
     "moves": "rx_msamples_per_s"}]
BOTH_PATHS = ("device_idle_pct",)


def tree(dst: Path, cells=(CELL,)) -> Path:
    """Copy BENCHMARK.json and rxbench/ to `dst` and add the named test
    cells (their workload and configuration files from tests/cells/, an
    entry in BENCHMARK.json each, and their names in the workloads of
    every per-layer metric of their receive path, STREAM_METRICS added
    for a live-path cell): no file of the harness is edited."""
    shutil.copytree(ROOT / "rxbench", dst / "rxbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    stream_only = {m["name"] for m in STREAM_METRICS}
    for name in cells:
        wl = json.loads((CELLS / f"{name}.json").read_text())
        shutil.copy(CELLS / f"{name}.json", dst / "rxbench" / "workloads")
        shutil.copy(CELLS / f"{wl['config']}.json",
                    dst / "rxbench" / "configs")
        bench["workloads"].append({"name": name, "config": wl["config"],
                                   "traffic": name.split(".")[1],
                                   "chips": 1, "why": wl["why"]})
        live = wl.get("path") == "stream"
        if live and not stream_only & {m["name"] for m in bench["per_layer"]}:
            bench["per_layer"] += [dict(m, workloads=[])
                                   for m in STREAM_METRICS]
        for m in bench["per_layer"]:
            if m["name"] in BOTH_PATHS or (m["name"] in stream_only) == live:
                m.setdefault("workloads", []).append(name)
    (dst / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dst


def run(dst: Path, code: str, timeout: int = 900):
    """`python -c code` in `dst`, the program importable from the repo
    root.  -> CompletedProcess."""
    env = dict(os.environ, PYTHONPATH=f"{dst}{os.pathsep}{ROOT}")
    return subprocess.run([sys.executable, "-c", code], cwd=dst, env=env,
                          capture_output=True, text=True, timeout=timeout)


def drive(dst: Path, argv: list[str], fault: str | None = None):
    """A whole CPU run of the harness in `dst` (`faults.drive`).
    -> (exit code, the last line of stdout as JSON or None, stderr)."""
    code = (f"import sys; from rxbench.tests import faults; "
            f"sys.exit(faults.drive({fault!r}, {argv!r}))")
    p = run(dst, code)
    lines = p.stdout.strip().splitlines()
    return p.returncode, (json.loads(lines[-1]) if lines else None), p.stderr
