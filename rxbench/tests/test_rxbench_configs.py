"""The configuration and workload files and BENCHMARK.json agree, each
configuration's FEC blocks per frame follow from its mode (202 for the UK
32K multiplex), and a live-path cell's capture is a whole loop of its TS."""
import json

import numpy as np
import pytest

from rxbench import cells, stream
from rxbench.gen import synth
from rxbench.tests import harness

BENCH = json.loads((cells.ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("name, blocks", [("t2_uk_hd_32k", 202)])
def test_fec_blocks_follow_from_the_mode(name, blocks):
    cfg = cells.load_json(cells.HERE / "configs" / f"{name}.json")
    p, plp = synth.mode(cfg)
    assert synth.fec_blocks_per_frame(p, plp) == blocks
    assert cfg["fec_blocks_per_frame"] == plp.num_blocks_max == blocks
    assert {"source", "assumed", "reduced"} <= set(cfg)


def test_every_entry_has_its_files():
    for c in BENCH["configs"]:
        cfg = cells.load_json(cells.ROOT / c["file"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        entry, wl, cfg = cells.specs(w["name"])
        assert wl["frames"] <= cfg["fec_blocks_per_frame"]
        assert set(wl["limits"]) == {"frontend_err", "llr_err",
                                     "timing_err_samples"}
    for m in BENCH["end_to_end"]:
        assert (cells.HERE / "end_to_end" / f"{m['name']}.py").exists()
    for m in BENCH["per_layer"]:
        assert (cells.HERE / "layer_metrics" / f"{m['name']}.py").exists()
        assert m["moves"] == "rx_msamples_per_s"


def test_stream_captures_are_whole_loops():
    """Every live-path workload file holds its stream keys and a whole
    number of its TS's loops, so its capture's seam is exact; the metrics
    a live-path cell would report have their readers."""
    live = 0
    for path in sorted((cells.HERE / "workloads").glob("*.json")):
        wl = cells.load_json(path)
        if not stream.is_stream(wl):
            continue
        live += 1
        assert set(wl["limits"]) == set(stream.TOLERANCE)
        assert {"device_rate", "block_seconds", "stream_batch",
                "capture_frames"} <= set(wl)
        p, plp = synth.mode(cells.load_json(
            cells.HERE / "configs" / f"{wl['config']}.json"))
        dfl = (plp.fec.k_bch - 80) // 8
        period = 188 // np.gcd(dfl, 188)
        loop = period // np.gcd(plp.num_blocks_max, period)
        assert wl["capture_frames"] % loop == 0, path.name
    assert live
    for m in harness.STREAM_METRICS:
        assert (cells.HERE / "layer_metrics" / f"{m['name']}.py").exists()
        assert m["moves"] == "rx_msamples_per_s"
