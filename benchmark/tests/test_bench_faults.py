"""Each fault the timed path can have, planted under a run that skips the
look for a card (``run_cell`` on the CPU at a tiny size), turns ``correct``
false; the same run unbroken is correct (``test_bench_harness.py``)."""

import pytest
import torch

from benchmark import faults
from benchmark.harness import Context, load_json, run_cell

from conftest import ROOT

SPEC = load_json(ROOT / "BENCHMARK.json")
CASES = [(c["name"], f) for c in SPEC["workloads"] for f in faults.FAULTS[c["traffic"]]]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_planted_fault_is_not_correct(tiny_root, cell, fault):
    torch.set_num_threads(2)
    with faults.plant(fault):
        result, info = run_cell(cell, 2**31 + 29, 0.2, False, "cpu", root=tiny_root)
    assert result["correct"] is False and result["failed"] >= 1, info["readings"]


@pytest.mark.parametrize("cell", [c["name"] for c in SPEC["workloads"]
                                  if c["traffic"] == "unfrozen_epochs"])
@pytest.mark.parametrize("part", ["train_step", "predict"])
def test_a_fault_that_starts_with_the_window_is_not_correct(tiny_root, monkeypatch, cell, part):
    """Set-up runs the program sound; from the window's first call on,
    ``part`` leaves out half of each batch (a step) or negates the first
    row of its answer (an evaluation)."""
    from eav_tpu_torch.train.loop import Trainer

    torch.set_num_threads(2)
    sound, window = getattr(Trainer, part), {"open": False}

    def faulty(self, *args, **kw):
        if not window["open"]:
            return sound(self, *args, **kw)
        if part == "train_step":
            opt, x, y = args
            h = max(1, len(y) // 2)
            return sound(self, opt, x[:h], y[:h])
        out = sound(self, *args, **kw)
        out[:1] = -out[:1]
        return out

    def mark(ctx, name, sound_mark=Context.mark):
        sound_mark(ctx, name)
        window["open"] = window["open"] or name == "warmup"  # set-up's last part

    monkeypatch.setattr(Trainer, part, faulty)
    monkeypatch.setattr(Context, "mark", mark)
    result, info = run_cell(cell, 2**31 + 31, 0.2, False, "cpu", root=tiny_root)
    assert result["correct"] is False and result["failed"] >= 1, info["readings"]
