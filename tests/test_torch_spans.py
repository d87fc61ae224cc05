"""The port's spans (``utils/profiling.span``): nothing at all with no
profiler running; under ``torch.profiler`` the trainer's phases nested in
``trainer.train_step`` and attention's layout copies, three a layer in a
training step; the bounded store of device-timed spans; and a fit that
gives the same bits with the profiler on and off."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from eav_tpu_torch.core.config import FinetuneConfig, PhaseConfig
from eav_tpu_torch.core.optim import make_optimizer
from eav_tpu_torch.models.ast import ast_tiny
from eav_tpu_torch.models.eegnet import EEGNet
from eav_tpu_torch.ops.attention import LAYOUT
from eav_tpu_torch.train.loop import Trainer
from eav_tpu_torch.utils import profiling
from eav_tpu_torch.utils.profiling import SpanStore, span, take_spans

CFG = dict(model="ast", batch_size=4, weight_decay=0.01, shuffle=True, eval_batch_size=3)
PHASES = ("trainer.forward", "trainer.backward", "trainer.optimizer")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread a test: the test runner runs several files at
    once, and torch's default of a thread per core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _annotations(prof, tmp_path):
    """The trace's port spans: [(name, start, end)] in order of start, on
    the profiler's clock (microseconds)."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
             if e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    return sorted(spans, key=lambda s: (s[1], -s[2]))


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _data(rng, n_train=6, n_test=5):
    return (rng.normal(size=(n_train, 128, 128)).astype(np.float32),
            rng.integers(0, 5, size=n_train).astype(np.int32),
            rng.normal(size=(n_test, 128, 128)).astype(np.float32),
            rng.integers(0, 5, size=n_test).astype(np.int32))


def test_off_a_span_does_nothing(monkeypatch):
    """With no profiler running, ``span`` opens no range, times nothing and
    stores nothing, with ``device`` or without."""
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler running")

    take_spans()
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    for device in (False, True):
        with span("trainer.optimizer", device=device) as opened:
            assert opened is None
    assert span("a") is span("b", device=True)  # one shared no-op: nothing allocated
    assert take_spans() == ([], 0)


def test_on_a_train_step_gives_nested_phases_and_three_layout_spans_a_layer(tmp_path):
    """One ``train_step`` of ``ast_tiny`` with ``attn_impl='flash'`` (the
    plain CPU versions): the step's span holds its phases in order, and
    each layer has three layout spans, two in the forward (q, k, v to
    head-major; O back) and one in the backward (dO made contiguous)."""
    layers = 2
    trainer = Trainer(ast_tiny(layers=layers, attn_impl="flash"),
                      FinetuneConfig(phases=(PhaseConfig(1, 5e-4, False),), **CFG), device="cpu")
    opt = make_optimizer(trainer.model, trainer.cfg)
    x, y = torch.randn(2, 128, 128), torch.tensor([0, 3])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.train_step(opt, x, y)
    spans = _annotations(prof, tmp_path)
    port = [s for s in spans if s[0].startswith(("trainer.", "attention."))]
    steps = [s for s in port if s[0] == "trainer.train_step"]
    assert len(steps) == 1
    phases = [s for s in port if s[0].startswith("trainer.") and s is not steps[0]]
    assert [s[0] for s in phases] == list(PHASES)  # no max-norm rules, no max-norm span
    assert all(_inside(s, steps[0]) for s in phases)
    assert all(a[2] <= b[1] for a, b in zip(phases, phases[1:]))
    layout = [s for s in port if s[0] == LAYOUT]
    assert len(layout) == 3 * layers
    forward, backward = phases[0], phases[1]
    assert sum(_inside(s, forward) for s in layout) == 2 * layers
    assert sum(_inside(s, backward) for s in layout) == layers
    assert take_spans() == ([], 0)  # no card: nothing timed


def test_the_max_norm_span_follows_the_optimizer_where_there_are_rules(tmp_path):
    model = EEGNet(chans=4, samples=64, kern_length=16, f1=4, d=2, f2=8)
    assert model.maxnorm_rules
    trainer = Trainer(model, FinetuneConfig(model="eegnet", batch_size=4,
                                            phases=(PhaseConfig(1, 1e-3, False),)), device="cpu")
    opt = make_optimizer(trainer.model, trainer.cfg)
    x, y = torch.randn(4, 4, 64), torch.tensor([0, 1, 2, 3])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.train_step(opt, x, y)
    names = [s[0] for s in _annotations(prof, tmp_path) if s[0].startswith("trainer.")]
    assert names == ["trainer.train_step", *PHASES, "trainer.maxnorm"]


class _Event:
    """A stand-in for a CUDA timing event at ``t`` ms."""

    def __init__(self, t: float):
        self.t = t

    def elapsed_time(self, end: "_Event") -> float:
        return end.t - self.t


def test_the_store_keeps_its_bound_counts_the_dropped_and_clears():
    store = SpanStore(capacity=2)
    for i, name in enumerate((LAYOUT, "trainer.optimizer", LAYOUT)):
        store.add(name, _Event(10.0 * i), _Event(10.0 * i + i + 0.5))
    assert store.take() == ([(LAYOUT, 0.5), ("trainer.optimizer", 1.5)], 1)
    assert store.take() == ([], 0)
    assert profiling.SPAN_CAPACITY == 65536 and SpanStore().capacity == profiling.SPAN_CAPACITY


def test_a_fit_gives_the_same_bits_with_the_profiler_on_and_off(rng, tmp_path):
    """A frozen phase on cached features, then an unfrozen one through the
    flash path's plain versions: history and test logits bit for bit, and
    the trace holds the fit's spans."""
    data = _data(rng)
    cfg = FinetuneConfig(phases=(PhaseConfig(1, 5e-3, True), PhaseConfig(2, 5e-4, False)), **CFG)
    trainer = Trainer(ast_tiny(layers=1, attn_impl="flash"), cfg, device="cpu")
    off = trainer.fit(data, seed=7)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = trainer.fit(data, seed=7)
    for k in ("loss", "train_acc", "test_acc"):
        np.testing.assert_array_equal(on.history[k], off.history[k], err_msg=k)
    np.testing.assert_array_equal(on.outputs_test, off.outputs_test)
    names = [s[0] for s in _annotations(prof, tmp_path)]
    assert names.count("fit.epoch") == 3 and names.count("fit.frozen_cache") == 1
    # an evaluation after each epoch, and the frozen cache's two feature passes
    assert names.count("trainer.evaluate") == 3 + 2
    assert names.count("trainer.train_step") == 3 * 2  # 6 rows at batch 4
