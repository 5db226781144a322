"""Whole runs of the live-path cell on the CPU at the test mode
(`tests/cells/test8k.stream.json`: 8K, 16QAM C1/2 short FEC, 10 Msps, a
188-frame loop): the result line meets the contract and reads correct;
each planted fault of the live path, and the control, reads not correct.
The runs start together, each in a process of its own."""
import json
import os
import subprocess
import sys

import pytest

from rxbench.tests import harness

CELL = "test8k.stream"
ARGV = ["--workload", CELL, "--seed", "2147483711", "--seconds", "0",
        "--trace", "0"]
FAULTS = ("ts_byte_altered", "frame_dropped_at_seam", "batch_half_decoded",
          "frames_unchanged")


def _start(dst, code):
    env = dict(os.environ, PYTHONPATH=f"{dst}{os.pathsep}{harness.ROOT}")
    return subprocess.Popen([sys.executable, "-c", code], cwd=dst, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{name: (exit code, stdout, stderr)}: the sound run, one run per
    fault, the traced run and the control's readings."""
    dst = harness.tree(tmp_path_factory.mktemp("stream"), cells=(CELL,))
    drive = ("import sys; from rxbench.tests import faults; "
             "sys.exit(faults.drive({!r}, {!r}))")
    jobs = {"sound": drive.format(None, ARGV),
            "traced": drive.format(None, ARGV[:-1] + ["1"])}
    jobs.update({f: drive.format(f, ARGV) for f in FAULTS})
    jobs["control"] = (
        "import torch; torch.set_num_threads(2); "
        "from rxbench import control; control.main(['--workload', "
        f"{CELL!r}, '--seeds', '17', '--control-seeds', '17'], "
        "device='cpu')")
    procs = {k: _start(dst, code) for k, code in jobs.items()}
    return {k: (p.wait(timeout=1500), *p.communicate())
            for k, p in procs.items()}


def _last(out):
    lines = out.strip().splitlines()
    return json.loads(lines[-1]) if lines else None


def test_stream_run_prints_one_correct_line(runs):
    rc, out, err = runs["sound"]
    assert rc == 0, err[-3000:]
    res = _last(out)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True, (res["checks"], res["stream"])
    assert res["attempted"] > 0 and res["failed"] == 0
    # step_p90_ms, where the window held blocks enough for a percentile
    assert {"rx_msamples_per_s", "setup_s"} <= set(res["metrics"]) <= {
        "rx_msamples_per_s", "step_p90_ms", "setup_s"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    # the loop's seam was crossed, and the numbers compared close stderr
    assert res["stream"]["seams_crossed"] >= 1
    tail = err.strip().splitlines()[-len(res["checks"]):]
    assert [ln.split()[1].rstrip(":") for ln in tail] == list(res["checks"])


def test_traced_stream_run_prints_its_per_layer_metrics(runs):
    """On the CPU the stage times and the batched share are read; the
    device's idle share, which needs device operations, is left out."""
    rc, out, err = runs["traced"]
    assert rc == 0, err[-3000:]
    res = _last(out)
    assert res["correct"] is True, res["checks"]
    assert set(res["metrics"]) == {
        "stream_frontend_ms_per_frame", "stream_track_ms_per_frame",
        "stream_decode_ms_per_frame", "stream_batched_frames_pct"}
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert res["metrics"]["stream_batched_frames_pct"]["value"] == 100.0


@pytest.mark.parametrize("fault", FAULTS)
def test_stream_fault_reads_not_correct(runs, fault):
    rc, out, err = runs[fault]
    assert rc == 0, err[-3000:]
    res = _last(out)
    assert res["correct"] is False, (fault, res["checks"])


def test_stream_control_reads_not_correct(runs):
    """The control (the capture's sample clock in bfloat16 in the
    program's place) reads not correct by the harness's own verdict; the
    program on the same seed reads correct."""
    rc, out, err = runs["control"]
    assert rc == 0, err[-3000:]
    rows = [json.loads(ln) for ln in out.strip().splitlines()]
    assert [r["side"] for r in rows] == ["program", "control"]
    for r in rows:
        assert r["correct"] is (r["side"] == "program"), r
