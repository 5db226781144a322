"""Whole runs of the harness on the CPU at the test mode (8K FFT, PP1,
16QAM C1/2 short FEC, F=3 frames of 5 blocks): the result line meets the
contract and reads correct; every planted fault, and the float8 control,
reads not correct."""
import json

import pytest

from rxbench.tests import harness

ARGV = ["--workload", harness.CELL, "--seed", "2147483711",
        "--seconds", "1.5"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return harness.tree(tmp_path_factory.mktemp("bench"),
                        cells=(harness.CELL, "test8k.clean"))


def _contract(res, trace: bool):
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["attempted"] > 0 and res["failed"] >= 0
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
        assert isinstance(m["value"], float)
    dev = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    for row in res["checks"].values():
        assert set(row) == {"value", "limit"}


def test_run_prints_one_correct_line(tree):
    rc, res, err = harness.drive(tree, ARGV + ["--trace", "0"])
    assert rc == 0, err[-3000:]
    _contract(res, trace=False)
    assert res["correct"] is True, res["checks"]
    assert set(res["metrics"]) == {"rx_msamples_per_s", "step_p90_ms",
                                   "setup_s"}
    # the numbers compared are the last lines of standard error
    tail = err.strip().splitlines()[-len(res["checks"]):]
    assert [ln.split()[1].rstrip(":") for ln in tail] == list(res["checks"])


def test_traced_run_prints_the_per_layer_metrics(tree):
    rc, res, err = harness.drive(tree, ARGV + ["--trace", "1"])
    assert rc == 0, err[-3000:]
    _contract(res, trace=True)
    assert res["correct"] is True, res["checks"]
    # on the CPU only the counter is read; the device metrics are left out
    assert set(res["metrics"]) == {"ldpc_sweeps_per_frame"}


def test_added_workload_file_is_a_cell(tree):
    """test8k.clean exists only as files and entries added to the copy."""
    rc, res, err = harness.drive(
        tree, ["--workload", "test8k.clean", "--seed", "5", "--seconds",
               "0", "--trace", "0"])
    assert rc == 0, err[-3000:]
    assert res["correct"] is True, res["checks"]


@pytest.mark.parametrize("fault", ["ldpc_flip", "state_unchanged",
                                   "half_batch", "byte_altered"])
def test_fault_reads_not_correct(tree, fault):
    rc, res, err = harness.drive(tree, ARGV + ["--trace", "0"], fault)
    assert rc == 0, err[-3000:]
    assert res["correct"] is False, (fault, res["checks"])


def test_control_reads_not_correct(tree):
    """The control (the reference in the program's place, one precision
    below the configuration's) reads not correct by the harness's own
    verdict on every seed; the program on the same seeds reads correct."""
    p = harness.run(tree, "from rxbench import control; control.main(["
                    f"'--workload', {harness.CELL!r}, '--seeds', '11,12,13',"
                    " '--control-seeds', '11,12,13'], device='cpu')")
    assert p.returncode == 0, p.stderr[-3000:]
    rows = [json.loads(ln) for ln in p.stdout.strip().splitlines()]
    assert len(rows) == 6
    for r in rows:
        assert r["correct"] is (r["side"] == "program"), r


def test_no_card_no_result(tree):
    """Without a CUDA device the command exits with another code than 0
    and prints no result."""
    p = harness.run(tree, "import sys; from rxbench import run; "
                    f"sys.exit(run.main({ARGV + ['--trace', '0']!r}))")
    assert p.returncode == 3
    assert p.stdout.strip() == ""
