"""The frozen generator: frame 0 of the synthesis at roll 0 is the
transmitter's own frame (the self-check `probe_maps` left out), the frames
of a step differ, and the seed fixes the inputs."""
import numpy as np
import torch

from rxbench import cells
from rxbench.gen import synth
from rxbench.gen.tx.modulator import T2Modulator
from rxbench.tests import harness

CFG = cells.load_json(harness.CELLS / "t2_test_8k.json")


def test_synth_frame_is_the_modulator_s():
    p, plp = synth.mode(CFG)
    base = synth.BaseFrame(p, plp, 123)
    got = synth.make_frame_synth(base, 3, "cpu")(0).numpy()
    mod = T2Modulator(p, [plp])
    rng = np.random.default_rng(123)
    ts = rng.integers(0, 256, (mod.packets_needed(1) + 4, 188)
                      ).astype(np.uint8)
    ts[:, 0] = 0x47
    want = mod.modulate(ts.reshape(-1), 1).samples
    rms = np.sqrt(np.mean(np.abs(want) ** 2))
    # the ingredients ship as int16, as the bench's do
    assert np.abs(got[0] - want).max() / rms < 2e-3
    for a in range(3):
        for b in range(a + 1, 3):
            assert np.abs(got[a] - got[b]).max() / rms > 0.1


def test_the_seed_fixes_the_inputs():
    wl = cells.load_json(harness.CELLS / f"{harness.CELL}.json")
    a = cells.Inputs(CFG, wl, 2**31 + 17, "cpu")
    b = cells.Inputs(CFG, wl, 2**31 + 17, "cpu")
    c = cells.Inputs(CFG, wl, 2**31 + 18, "cpu")
    assert a.offsets == b.offsets
    for x, y in zip(a.pool, b.pool):
        assert torch.equal(x[0], y[0]) and torch.equal(x[1], y[1])
    assert np.array_equal(a.weights, b.weights)
    assert not torch.equal(a.pool[0][0], c.pool[0][0])
