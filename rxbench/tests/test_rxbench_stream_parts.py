"""Parts of the live-path cell that need no receiver: the looped TS closes
over its period, the TS check finds a wrong, a lost and a repeated
packet, the control's number, and the superstep cells' inputs are those
the harness built before the stream path was added."""
import hashlib

import numpy as np
import pytest
import torch

from rxbench import cells, stream
from rxbench.gen import synth
from rxbench.gen.capture import Payload
from rxbench.gen.dvbt2 import bbframe
from rxbench.tests import harness

CFG = cells.load_json(harness.CELLS / "t2_test_8k.json")
UK = cells.load_json(cells.HERE / "configs" / "t2_uk_hd_32k.json")


@pytest.mark.parametrize("cfg, period, loop", [(CFG, 188, 188),
                                               (UK, 94, 47)])
def test_period_and_loop(cfg, period, loop):
    """P BB frames hold whole packets; C frames of nb blocks whole periods
    (the UK HD capture loops after 47 frames)."""
    p, plp = synth.mode(cfg)
    dfl = (plp.fec.k_bch - bbframe.BB_HEADER_BITS) // 8
    assert period * dfl % 188 == 0
    nb = plp.num_blocks_max
    got = period // np.gcd(nb, period)
    assert got == loop and loop * nb % period == 0


def test_looped_ts_closes_over_its_period():
    """The period's BB frames, pushed twice over through the generator's
    TS assembler, give the payload's packets twice, with no CRC error:
    the loop is one valid TS."""
    _, plp = synth.mode(CFG)
    pay = Payload(plp, 7)
    asm = bbframe.TSAssembler()
    for _ in range(2):
        asm.push_frames(pay.rows)
    got = np.stack([np.asarray(r) for r in asm.packets[:len(asm.packets)]])
    k = len(pay.packets)
    assert asm.error_count() == 0
    assert len(got) >= 2 * k - 1
    idx = (np.arange(len(got))) % k
    assert (got == pay.packets[idx]).all()


class _Inputs:
    """A stand-in of `stream.Inputs` for the TS check alone."""

    def __init__(self):
        _, self.plp = synth.mode(CFG)
        self.payload = Payload(self.plp, 11)
        self.nb = self.plp.num_blocks_max


def _sent(inp, first_frame, frames):
    """The packets that `frames` frames from capture frame `first_frame`
    hold, from the first that starts in them, as a receiver emits them."""
    pay, nb = inp.payload, inp.nb
    j0 = first_frame * nb % pay.period
    first = -(-j0 * pay.dfl // 188)
    n = (j0 + frames * nb) * pay.dfl // 188 - first
    return pay.packets[(first + np.arange(n)) % len(pay.packets)]


@pytest.mark.parametrize("first_frame", [0, 5, 187])
def test_ts_check_reads_a_sound_stream_as_sound(first_frame):
    inp = _Inputs()
    sent = _sent(inp, first_frame, 30)
    nums, ok = stream.ts_numbers(inp, [sent[:100].reshape(-1),
                                       sent[100:].reshape(-1)], 30)
    assert nums == {"ts_packets_wrong": 0, "ts_packets_missing": 0}
    assert ok.all() and len(ok) == 30


@pytest.mark.parametrize("fault", ["byte", "lost", "repeated"])
def test_ts_check_finds_the_fault(fault):
    inp = _Inputs()
    sent = _sent(inp, 3, 30).copy()
    if fault == "byte":
        sent[200, 50] ^= 1
    elif fault == "lost":
        sent = np.delete(sent, 200, axis=0)
    else:
        sent = np.insert(sent, 200, sent[199], axis=0)
    nums, ok = stream.ts_numbers(inp, [sent.reshape(-1)], 30)
    assert nums["ts_packets_wrong"] + nums["ts_packets_missing"] > 0
    assert not ok.all()


def test_control_rounds_the_sample_clock_to_bfloat16():
    """The control's sample-clock error: the capture's ratio (about
    1.00627 raw samples an elementary one at 9.2 Msps) in bfloat16, whose
    step near 1 is 2**-7, is off by well over a thousand ppm."""
    class Inp:
        rate = 9.2e6
        truth = {"ratio": 9.2e6 * (1 + synth.SCO) / (64e6 / 7)}
        sco_ppm = synth.SCO * 1e6
    assert stream.control_numbers(Inp())["sco_err_ppm"] > 1000.0


# sha256 of the test cells' pool, offsets, weights, expected hashes and
# slots at seed 2**31 + 101, from the harness before the live path came
PARENT_INPUTS = {
    "test8k.awgn":
        "d37f142eea81d45b588c63539fc638083d109237c45939fcb411a85b34e60785",
    "test8k.clean":
        "94f33dd9c0c1452357260944fd50ef44b1a0dfe27dd80cca9716cfd6a1778b65"}


@pytest.mark.parametrize("name", sorted(PARENT_INPUTS))
def test_superstep_cells_build_the_parent_s_inputs(name):
    torch.set_num_threads(2)
    wl = cells.load_json(harness.CELLS / f"{name}.json")
    inp = cells.Inputs(CFG, wl, 2**31 + 101, "cpu")
    h = hashlib.sha256()
    for a, b in inp.pool:
        h.update(a.numpy().tobytes())
        h.update(b.numpy().tobytes())
    h.update(np.asarray(inp.offsets, np.int64).tobytes())
    h.update(inp.weights.tobytes())
    for x in inp.hashes:
        h.update(x.tobytes())
    for s in inp.slots:
        h.update(s.astype(np.int64).tobytes())
    assert h.hexdigest() == PARENT_INPUTS[name]
