"""Nothing a run loads is JAX or the JAX package, compared by whole
top-level name (the port's name begins with the JAX package's), and the
reference and the generator import nothing of the program."""
import json
import sys

from rxbench import run
from rxbench.tests import harness

# raises on importing any of the names given, compared as whole top-level
# names
BLOCKER = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def __init__(self, names): self.names = names
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in self.names:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block({names!r}))
"""


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    for name in ("sdr_receiver_dvb_t2_tpu_torch", "jaxtyping", "flaxen",
                 "sdr_receiver_dvb_t2_tpu_torch.rx"):
        monkeypatch.setitem(sys.modules, name, object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "sdr_receiver_dvb_t2_tpu.ops", object())
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert run.forbidden_modules() == ["jaxlib", "sdr_receiver_dvb_t2_tpu"]


def test_a_run_loads_no_jax(tmp_path):
    """A whole CPU run with importing jax, jaxlib, flax or the JAX package
    made to fail: it completes correct, and its own look at sys.modules
    finds none of them."""
    dst = harness.tree(tmp_path)
    code = BLOCKER.format(names={"jax", "jaxlib", "flax",
                                 "sdr_receiver_dvb_t2_tpu"}) + (
        "from rxbench.tests import faults; "
        f"sys.exit(faults.drive(None, {['--workload', harness.CELL, '--seed', '3', '--seconds', '0', '--trace', '0']!r}))")
    p = harness.run(dst, code)
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is True


def test_reference_and_generator_import_nothing_of_the_program(tmp_path):
    """The yardstick (reference, generator, checks, roofline, the metric
    readers' helpers) imports and runs with the program made unimportable:
    the reference front end and LLRs of one synthesised frame."""
    dst = harness.tree(tmp_path)
    code = BLOCKER.format(names={"jax", "jaxlib", "flax",
                                 "sdr_receiver_dvb_t2_tpu",
                                 "sdr_receiver_dvb_t2_tpu_torch"}) + """
import json, numpy as np, torch
from rxbench import cells, check, reference, roofline
from rxbench.gen import synth
_, wl, cfg = cells.specs("test8k.awgn")
inp = cells.Inputs(cfg, wl, 9, "cpu")
lay = check.LayerCheck(inp)
planes, llrs = lay.reference(0, 1)
truth = inp.base.codewords[inp.slots[0][1]].T
print(json.dumps({"sign_errors": int(((llrs < 0).numpy() != truth).sum()),
                  "bits": int(truth.size)}))
"""
    p = harness.run(dst, code)
    assert p.returncode == 0, p.stderr[-3000:]
    got = json.loads(p.stdout.strip().splitlines()[-1])
    # hard decisions of the reference LLRs at 14 dB, 16QAM: a few percent
    # of raw bit errors at most, no systematic inversion
    assert got["sign_errors"] < 0.05 * got["bits"]
