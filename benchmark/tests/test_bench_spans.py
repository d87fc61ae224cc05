"""The readers of the port's spans (``benchmark/port_spans.py`` and the
metric that uses it) on hand-built traces and span lists: the idle split by
span sums to the unit's gaps and charges each gap to the innermost span; a
trace without spans, a run off the card and a program without a span store
read None."""

import pytest

from conftest import ROOT

from benchmark import port_spans, trace
from benchmark.harness import Run, load_module

METRICS = ("layout_copy_pct.extract",)


def _event(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid}


def _span(name, ts, dur, tid=1):
    return _event("user_annotation", name, ts, dur, tid)


def _profile(with_spans=True):
    """A 1000 us unit: two training steps (0-400, 400-800) and an
    evaluation (800-950); kernels busy 100-150, 300-350, 500-700, 850-900."""
    events = [_span(trace.ANNOTATION, 0, 1000)]
    events += [_event("kernel", "k", a, b - a, tid=7)
               for a, b in ((100, 150), (300, 350), (500, 700), (850, 900))]
    if with_spans:
        for t0 in (0, 400):
            events += [_span("trainer.train_step", t0, 400),
                       _span("trainer.forward", t0 + 10, 190),
                       _span("attention.layout", t0 + 20, 30),
                       _span("trainer.backward", t0 + 200, 120),
                       _span("trainer.optimizer", t0 + 320, 60)]
        events += [_span("trainer.evaluate", 800, 150),
                   _span("attention.layout", 330, 10, tid=2)]  # the autograd engine's thread
    return trace.Profile(events)


def _run(profile):
    unit = {"train_samples": 16, "eval_samples": 4, "flops": 0.0,
            "seconds": 1.0, "work": [], "profiled": True}
    return Run({}, {}, {}, 1.0, 2.0, [dict(unit, profiled=False), unit], profile=profile)


@pytest.fixture
def device_spans(monkeypatch):
    """The port's span store, as ``take_spans`` hands it over once."""
    from eav_tpu_torch.utils import profiling

    given = {"spans": []}

    def take():
        spans, given["spans"] = given["spans"], []
        return spans, 0

    monkeypatch.setattr(profiling, "take_spans", take)
    return given


def test_the_idle_split_sums_to_the_gaps_and_charges_the_innermost_span():
    p = _profile()
    gaps = p.gaps()  # 0-100, 150-300, 350-500, 700-850, 900-1000
    split = port_spans.idle_split(p)
    assert sum(split.values()) == pytest.approx(sum(b - a for a, b in gaps))
    # step 1: forward 10-200 holds 10-100 and 150-200; backward 200-320 holds
    # 200-300; optimizer 320-380 holds 350-380; the step's rest 0-10, 380-400
    # step 2: forward 410-600 holds 410-500; backward 600-720 holds 700-720;
    # optimizer 720-780 all of it; the step's rest 400-410, 780-800
    assert split["trainer.forward"] == pytest.approx(90 + 50 + 90)
    assert split["trainer.backward"] == pytest.approx(100 + 20)
    assert split["trainer.optimizer"] == pytest.approx(30 + 60)
    assert split["trainer.train_step"] == pytest.approx(10 + 20 + 10 + 20)
    assert split["trainer.evaluate"] == pytest.approx(50 + 50)  # 800-850, 900-950
    assert split[port_spans.OUTSIDE] == pytest.approx(50)  # 950-1000


def test_the_metric_files_read_the_spans(device_spans):
    device_spans["spans"] = [("attention.layout", 0.02), ("trainer.optimizer", 0.05),
                             ("attention.layout", 0.03), ("trainer.optimizer", 0.07),
                             ("trainer.optimizer", 0.06)]
    run = _run(_profile())
    got = {m: load_module(ROOT / "benchmark" / "metrics" / f"{m}.py", f"spans_{m}").read(run)
           for m in METRICS}
    busy_ms = 0.35  # 50 + 50 + 200 + 50 us
    assert got == pytest.approx({"layout_copy_pct.extract": 100 * 0.05 / busy_ms})
    # the store was read once; its spans and the annotating thread's counts noted
    assert any("attention.layout 2 (0.050 ms)" in n for n in run.notes)
    assert any("attention.layout 2, trainer.backward 2" in n for n in run.notes)
    assert port_spans.device_ms(run, "trainer.optimizer") == pytest.approx([0.05, 0.07, 0.06])


def test_no_spans_no_reading(device_spans, monkeypatch):
    """A trace without the port's spans (a port from before them), a run off
    the card (no device activity) and a port without a span store read
    None, and raise nothing."""
    for run in (_run(_profile(with_spans=False)), _run(None)):
        assert all(load_module(ROOT / "benchmark" / "metrics" / f"{m}.py", f"spans_{m}")
                   .read(run) is None for m in METRICS)
    device_spans["spans"] = [("attention.layout", 0.02)]
    cpu = trace.Profile([_span(trace.ANNOTATION, 0, 100), _span("trainer.train_step", 0, 90),
                         _span("attention.layout", 0, 50)])
    assert cpu.busy_s == 0 and port_spans.share_of_busy_pct(_run(cpu), "attention.layout") is None
    from eav_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "take_spans")
    run = _run(_profile())
    assert port_spans.device_ms(run, "attention.layout") == []
    assert port_spans.share_of_busy_pct(run, "attention.layout") is None
    assert port_spans.idle_split(run.profile)["trainer.forward"] == pytest.approx(230)
