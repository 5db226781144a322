"""The port's receiver CLI (sdr_receiver_dvb_t2_tpu_torch/rx/cli.py, `t2rx`)
and stage plots (utils/plots.py), on the CPU with `--platform cpu`.

- The JAX CLI's own drives (tests/test_io_cli.py one-shot and --stream,
  tests/test_bandwidth.py's 1.7 MHz stream): the TS is a bit-exact prefix
  of the transmitted one.
- Against the JAX CLI (`--platform cpu`) on one capture: `--stream
  --device-path` writes byte-equal TS files; the port's `--flood-ldpc`
  (f32 flooding decoder) and JAX's `--jax-ldpc` write byte-equal TS files;
  the `--l1-dump` text is equal; `--stats-json` has the same keys and the
  same frame and packet counts.
- `--platform cuda` with no card exits nonzero and writes no TS; the host
  receive path imports no device code and needs no card.
- `--stream --plots` writes the JAX CLI's file names, and the equalized
  cells `stage_plots` draws are within the fused path's tolerance (1e-4
  of the largest magnitude) of the JAX demod's.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sdr_receiver_dvb_t2_tpu.dvbt2.params import Bandwidth
from sdr_receiver_dvb_t2_tpu.rx import cli as jcli
from sdr_receiver_dvb_t2_tpu.utils import plots as jplots
from sdr_receiver_dvb_t2_tpu_torch.rx import cli as tcli
from sdr_receiver_dvb_t2_tpu_torch.tx.cli import main as tx_main
from sdr_receiver_dvb_t2_tpu_torch.utils import plots as tplots

from tests.test_bandwidth import _waveform

torch.set_num_threads(1)

MODE = ["--fft", "8k", "--guard", "1/32", "--pp", "1", "--mod", "16qam",
        "--rate", "1/2", "--short-fec", "--blocks", "3", "--n-data", "9"]


@pytest.fixture(autouse=True)
def _jax_cache(tmp_path_factory, monkeypatch):
    """The JAX CLI's compile cache goes under the test's temporary tree."""
    monkeypatch.setenv("T2RX_JAX_CACHE",
                       str(tmp_path_factory.getbasetemp() / "t2rx_jax"))


def _capture(tmp_path, seed, frames):
    rng = np.random.default_rng(seed)
    ts = rng.integers(0, 256, (120, 188)).astype(np.uint8)
    ts[:, 0] = 0x47
    ts[:, 1] &= 0x7F
    ts_path = str(tmp_path / "in.ts")
    ts.tofile(ts_path)
    iq_path = str(tmp_path / "sig.cf32")
    assert tx_main([ts_path, iq_path, *MODE, "--frames", str(frames)]) == 0
    return ts.reshape(-1), iq_path


def _assert_prefix(out_path, ts):
    got = np.fromfile(out_path, np.uint8)
    assert len(got) >= 188
    np.testing.assert_array_equal(got, ts[:len(got)])
    return got


def test_cli_tx_rx_roundtrip(tmp_path):
    ts, iq = _capture(tmp_path, seed=2, frames=1)
    out = str(tmp_path / "out.ts")
    assert tcli.main([iq, "--out", out, "--platform", "cpu"]) == 0
    _assert_prefix(out, ts)


def test_cli_streaming_mode(tmp_path):
    ts, iq = _capture(tmp_path, seed=3, frames=2)
    out = str(tmp_path / "out.ts")
    assert tcli.main([iq, "--out", out, "--stream", "--platform",
                      "cpu"]) == 0
    _assert_prefix(out, ts)


def test_stream_cli_file_bandwidth(tmp_path):
    """--stream --bandwidth 1.7 on a lite-rate capture: the FileDevice
    takes the declared rate."""
    flat, samples, _ = _waveform(5, bandwidth=Bandwidth.BW_1_7)
    cap = tmp_path / "cap17.cf32"
    samples.astype(np.complex64).tofile(cap)
    out = tmp_path / "out.ts"
    assert tcli.main([str(cap), "--stream", "--bandwidth", "1.7",
                      "--platform", "cpu", "--no-agc",
                      "--out", str(out)]) == 0
    _assert_prefix(out, flat)


def _run_both(capsys, tmp_path, iq, port_flags, jax_flags):
    """-> {"port"|"jax": (TS bytes, stdout lines)}."""
    res = {}
    for name, main, flags in (("port", tcli.main, port_flags),
                              ("jax", jcli.main, jax_flags)):
        out = str(tmp_path / f"{name}.ts")
        assert main([iq, "--out", out, "--platform", "cpu", "--stats-json",
                     *flags]) == 0
        res[name] = (np.fromfile(out, np.uint8),
                     capsys.readouterr().out.strip().splitlines())
    return res


def _same_stats(a: str, b: str, counts):
    a, b = json.loads(a), json.loads(b)
    assert a.keys() == b.keys()
    for k in counts:
        assert a[k] == b[k], k
    return a


def test_device_path_stream_equals_jax_cli(tmp_path, capsys):
    ts, iq = _capture(tmp_path, seed=3, frames=2)
    flags = ["--stream", "--device-path"]
    res = _run_both(capsys, tmp_path, iq, flags, flags)
    (mine, out_t), (ref, out_j) = res["port"], res["jax"]
    assert len(mine) > 0
    np.testing.assert_array_equal(mine, ref)
    np.testing.assert_array_equal(mine, ts[:len(mine)])
    st = _same_stats(out_t[-1], out_j[-1], ("frames", "ts_packets",
                                            "ts_errors"))
    assert st["frames"] == 2
    assert json.loads(out_t[-1])["stages"].keys() \
        == json.loads(out_j[-1])["stages"].keys()


def test_flood_ldpc_equals_jax_ldpc(tmp_path, capsys):
    ts, iq = _capture(tmp_path, seed=4, frames=2)
    res = _run_both(capsys, tmp_path, iq, ["--flood-ldpc", "--l1-dump"],
                    ["--jax-ldpc", "--l1-dump"])
    (mine, out_t), (ref, out_j) = res["port"], res["jax"]
    assert len(mine) > 0
    np.testing.assert_array_equal(mine, ref)
    np.testing.assert_array_equal(mine, ts[:len(mine)])
    assert out_t[:-1] == out_j[:-1]                   # the L1 dump
    assert any("L1-post" in ln for ln in out_t[:-1])
    st = _same_stats(out_t[-1], out_j[-1], ("frames", "packets",
                                            "ts_errors", "l1_failures"))
    assert st["frames"] == 2


@pytest.mark.parametrize("flags", [
    ["--stream", "--device-path"], ["--flood-ldpc"],
    ["--stream", "--plots", "PLOTS"],
], ids=["device-path", "flood-ldpc", "stream-plots"])
def test_platform_cuda_without_a_card_is_refused(tmp_path, monkeypatch,
                                                 flags):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, iq = _capture(tmp_path, seed=5, frames=1)
    out = tmp_path / "out.ts"
    flags = [str(tmp_path / "plots") if f == "PLOTS" else f for f in flags]
    with pytest.raises(SystemExit) as e:
        tcli.main([iq, "--out", str(out), *flags])
    assert e.value.code not in (0, None)
    assert "no CUDA device" in str(e.value.code)
    assert not out.exists()


DEVICE_MODULES = ("rx.device_receiver", "rx.fusedpath", "ops.ldpc",
                  "ops.ldpc_layered", "ops.frontend_device", "_build")


def test_host_path_imports_no_device_code(tmp_path):
    """The one-shot host receive path, at the default --platform cuda, in
    a fresh process: it decodes, no device module of the port is imported
    and CUDA is never initialised (the host BCH gate's module,
    `ops/fec_device`, brings torch in for its NumPy functions, as the JAX
    package's brings jax)."""
    ts, iq = _capture(tmp_path, seed=6, frames=1)
    out = str(tmp_path / "out.ts")
    code = ("import sys\n"
            "from sdr_receiver_dvb_t2_tpu_torch.rx.cli import main\n"
            f"rc = main([{iq!r}, '--out', {out!r}])\n"
            "import torch\n"
            "print(rc, torch.cuda.is_initialized(), sorted(m for m in "
            "sys.modules if m.startswith(tuple("
            f"'sdr_receiver_dvb_t2_tpu_torch.' + d for d in "
            f"{DEVICE_MODULES!r}))))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300,
                       cwd=os.path.dirname(os.path.dirname(__file__)))
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "0 False []"
    _assert_prefix(out, ts)


def test_stream_plots_match_jax(tmp_path, capsys, monkeypatch):
    _, iq = _capture(tmp_path, seed=7, frames=2)
    cells = {}
    for name, mod, main in (("port", tplots, tcli.main),
                            ("jax", jplots, jcli.main)):
        drawn = cells.setdefault(name, {})
        draw = mod.constellation_png

        def record(c, path, *a, _draw=draw, _drawn=drawn, **kw):
            _drawn[os.path.basename(path)] = np.array(c)
            _draw(c, path, *a, **kw)
        monkeypatch.setattr(mod, "constellation_png", record)
        d = tmp_path / name
        assert main([iq, "--out", str(tmp_path / f"{name}.ts"), "--stream",
                     "--platform", "cpu", "--plots", str(d)]) == 0
        cells[name + " files"] = sorted(os.listdir(d))
    capsys.readouterr()
    assert cells["port files"] == cells["jax files"]
    assert "const_data.png" in cells["port files"]
    assert cells["port"].keys() == cells["jax"].keys() \
        == {"const_l1pre.png", "const_l1post.png", "const_data.png"}
    for k, ref in cells["jax"].items():
        mine = cells["port"][k]
        assert mine.shape == ref.shape and len(ref) > 0
        np.testing.assert_allclose(mine, ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max())
