"""The receiver profiling tool (sdr_receiver_dvb_t2_tpu_torch/tools/
profile_receiver.py): its stage timer, and its refusal to run without a
card.  The profile itself runs only on the card."""
import torch

from sdr_receiver_dvb_t2_tpu_torch.tools import profile_receiver as pr


class _Stage:
    def __call__(self, x):
        return x + 1


def test_stage_timer_counts_calls_and_restores(capsys):
    inner = _Stage.__call__
    timer = pr.StageTimer()
    timer.wrap(_Stage, "__call__", "stage", device=False)
    stage = _Stage()
    assert [stage(1), stage(2)] == [2, 3]
    assert len(timer.times["stage"]) == 2 and min(timer.times["stage"]) > 0
    timer.report()
    out = capsys.readouterr().out
    assert "stage" in out and "x2" in out and "calls" in out
    timer.reset()
    assert not timer.times
    timer.unwrap()
    assert _Stage.__call__ is inner


def test_profile_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pr.main() == 1
    assert "no CUDA device" in capsys.readouterr().out
