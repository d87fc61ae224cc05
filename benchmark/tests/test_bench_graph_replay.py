"""``graph_replay_pct.*`` on hand-built traces: 100 when every training step
of the profiled unit replays a CUDA graph, the share when some run eagerly
(0 for a trainer without graphs), and None without step spans."""

import pytest

from conftest import ROOT

from benchmark import trace
from benchmark.harness import Run, load_module

METRICS = ("graph_replay_pct.train", "graph_replay_pct.train.vit")


def _span(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid}


def _profile(replayed, eager):
    """A unit of ``replayed`` steps that replay a graph, then ``eager``
    eager ones, 100 us each, a kernel in each."""
    events = [_span(trace.ANNOTATION, 0, 100 * (replayed + eager) + 50)]
    for i in range(replayed + eager):
        t0 = 100 * i
        events += [_span("trainer.train_step", t0, 90),
                   {"ph": "X", "cat": "kernel", "name": "k", "ts": t0 + 20, "dur": 30,
                    "pid": 1, "tid": 7}]
        if i < replayed:
            events.append(_span("trainer.graph_replay", t0 + 5, 20))
        else:
            events.append(_span("trainer.forward", t0 + 5, 40))
    return trace.Profile(events)


def _run(profile):
    unit = {"train_samples": 16, "eval_samples": 4, "flops": 0.0,
            "seconds": 1.0, "work": [], "profiled": True}
    return Run({}, {}, {}, 1.0, 2.0, [dict(unit, profiled=False), unit], profile=profile)


def _read(run):
    return [load_module(ROOT / "benchmark" / "metrics" / f"{m}.py", f"replay_{m}").read(run)
            for m in METRICS]


@pytest.mark.parametrize("replayed,eager,want", [(5, 0, 100.0), (3, 1, 75.0), (0, 4, 0.0)])
def test_the_share_of_steps_that_replay(replayed, eager, want):
    assert _read(_run(_profile(replayed, eager))) == pytest.approx([want, want])


def test_no_steps_read_none():
    """A run without a profile and a unit without step spans read None, and
    raise nothing."""
    assert _read(_run(None)) == [None, None]
    assert _read(_run(trace.Profile([_span(trace.ANNOTATION, 0, 100)]))) == [None, None]
