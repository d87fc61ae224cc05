"""The port's task farm (``core/sweep.SweepRunner.run_farmed``,
``parallel/farm.py``) against the JAX package's: the records of a farmed
sweep field for field on stub tasks, two CPU workers over real
``ModalityPipelines`` against the serial run (``tests/test_farm.py:35``),
the task- and prefetch-timeout retirements and the farm of one
(``tests/test_farm.py:80``, ``:130``, ``:177``; the wedges here wait on an
``Event`` nobody sets, under deadlines seconds longer than a task),
``run_batched``'s ``only_subjects``, ``cli run --chip-parallel`` on the CPU,
the deterministic mode across the farm's threads, and a stress run of the
log lock and the launch counters."""

import json
import sys
import threading

import numpy as np
import pytest
import torch

from eav_tpu.core import sweep as jax_sweep
from eav_tpu.core.config import SweepConfig as JaxSweepConfig
from eav_tpu.parallel.farm import DeviceWorker as JaxDeviceWorker
from eav_tpu_torch.core import sweep
from eav_tpu_torch.core.config import SweepConfig, apply_overrides
from eav_tpu_torch.core.device import deterministic_algorithms
from eav_tpu_torch.parallel.farm import DeviceWorker, device_workers
from eav_tpu_torch.train.pipeline import ModalityPipelines, _cfg_hash, default_presets

from test_torch_parallel import one_thread  # noqa: F401  (one intra-op thread a test)

SUBJECTS = (1, 2, 3, 4)
DEADLINE_S = 3.0  # each stub task returns at once
VOLATILE = {"ts", "wall_clock_s", "traceback", "makespan_s", "busy_s"}


def _stub(module):
    def task(subject, modality):
        acc = 0.1 * subject + (0.05 if modality == "audio" else 0.0)
        return module.TaskResult(metrics={"accuracy": acc, "weighted_f1": acc / 2})
    return task


def _records(path):
    with open(path) as f:
        return [{k: v for k, v in json.loads(line).items() if k not in VOLATILE} for line in f]


def _cfgs(tmp_path, **kw):
    return [cls(journal_path=str(tmp_path / name / "journal.jsonl"),
                metrics_path=str(tmp_path / name / "metrics.jsonl"), **kw)
            for name, cls in (("jax", JaxSweepConfig), ("torch", SweepConfig))]


def _key(r):
    return json.dumps(r, sort_keys=True)


@pytest.mark.parametrize("n_workers", [1, 2])
def test_farm_records_equal_jax(tmp_path, n_workers):
    """Stub tasks over eeg, audio and fusion (fusion stays for the serial
    pass): the same journal and metrics records as JAX's farm, the longest
    family first; with two workers, the same records but for which worker
    ran which task."""
    jcfg, tcfg = _cfgs(tmp_path, subjects=(1, 2, 3), modalities=("eeg", "audio", "fusion"))
    jr, tr = jax_sweep.SweepRunner(jcfg, _stub(jax_sweep)), sweep.SweepRunner(tcfg, _stub(sweep))
    jr.run_farmed([JaxDeviceWorker(f"w{i}", _stub(jax_sweep)) for i in range(n_workers)],
                  verbose=False)
    tr.run_farmed([DeviceWorker(f"w{i}", _stub(sweep)) for i in range(n_workers)],
                  verbose=False)
    for attr in ("journal_path", "metrics_path"):
        got, want = _records(getattr(tcfg, attr)), _records(getattr(jcfg, attr))
        if n_workers == 1:
            assert got == want and want, attr
        else:
            strip = lambda rows: sorted(_key({k: v for k, v in r.items()  # noqa: E731
                                             if k not in ("device", "worker")}) for r in rows)
            assert strip(got) == strip(want), attr
    journal = _records(tcfg.journal_path)
    assert {r["task"][10:] for r in journal} == {"eeg", "audio"}
    assert all({"device", "worker"} <= set(r) for r in journal)
    if n_workers == 1:  # audio (rank 2) claimed before eeg (rank 4)
        assert [r["task"] for r in journal][:3] == [f"subject0{s}_audio" for s in (1, 2, 3)]
    assert tr.pending_tasks() == [(s, "fusion") for s in (1, 2, 3)]


def _presets():
    return apply_overrides(default_presets(), [
        "eeg.finetune.model_kwargs.kern_length=8",
        "eeg.finetune.phases.0.epochs=2",
        "eeg.split.h_idx=2",
    ])


def _seed_cache(cache_dir, presets):
    """The preprocessed EEG of each subject, written where the pipelines'
    cache finds it (20 trials of 30 x 500)."""
    rng = np.random.default_rng(7)
    cache_dir.mkdir(parents=True, exist_ok=True)
    for s in SUBJECTS:
        x = rng.normal(size=(20, 30, 500)).astype(np.float32)
        y = np.repeat(np.arange(5), 4).astype(np.int32)
        np.savez(cache_dir / f"s{s:02d}_eeg_{_cfg_hash(presets['eeg'].eeg)}.npz", x=x, y=y)


def test_farm_real_pipelines_matches_serial(tmp_path):
    """Two CPU workers over real pipelines: every subject's row and archived
    logits equal the serial run's (the same seeds and ingest), both
    workers ran tasks, and the farmed rows carry ``device`` and
    ``worker``."""
    presets = _presets()
    _seed_cache(tmp_path / "cache", presets)

    def run(mode):
        out = tmp_path / mode
        make = lambda dev="cpu": ModalityPipelines(  # noqa: E731
            "/nonexistent", cache_dir=str(tmp_path / "cache"), logits_dir=str(out / "logits"),
            presets=presets, device=dev)
        cfg = SweepConfig(subjects=SUBJECTS, modalities=("eeg",),
                          journal_path=str(out / "journal.jsonl"),
                          metrics_path=str(out / "metrics.jsonl"))
        runner = sweep.SweepRunner(cfg, make().task_fn)
        if mode == "farm":
            state = runner.run_farmed(device_workers(make, devices=[torch.device("cpu")] * 2),
                                      verbose=False)
        else:
            state = runner.run(verbose=False)
        assert all(r["status"] == "done" for r in state.values())
        rows = [json.loads(line) for line in open(cfg.metrics_path)]
        return state, {r["subject"]: r for r in rows if r.get("accuracy") is not None}, out

    _, serial, s_out = run("serial")
    state, farmed, f_out = run("farm")
    for s in SUBJECTS:
        for k in ("accuracy", "weighted_f1", "confusion", "final_train_acc", "epochs"):
            assert farmed[s][k] == serial[s][k], (s, k)
        assert farmed[s]["device"] == "cpu"
        for split in ("train", "test"):
            np.testing.assert_array_equal(np.load(f_out / "logits" / f"s{s:02d}_eeg_{split}.npy"),
                                          np.load(s_out / "logits" / f"s{s:02d}_eeg_{split}.npy"))
    assert {state[f"subject{s:02d}_eeg"]["worker"] for s in SUBJECTS} == {0, 1}


def _timeout_cfg(tmp_path):
    return SweepConfig(subjects=(1, 2, 3, 4, 5, 6), modalities=("eeg",), max_retries=0,
                       journal_path=str(tmp_path / "journal.jsonl"),
                       metrics_path=str(tmp_path / "metrics.jsonl"))


def test_farm_task_timeout_retires_worker_and_drains(tmp_path):
    """A task still running at its deadline is journaled failed (note
    ``timeout``, JAX's error text), its worker retires and returns its
    ahead-claim, and the other worker drains the rest."""
    wedge = threading.Event()  # never set: the task never returns

    def hang(subject, modality):
        wedge.wait()

    runner = sweep.SweepRunner(_timeout_cfg(tmp_path), _stub(sweep))
    state = runner.run_farmed([DeviceWorker("bad", hang), DeviceWorker("good", _stub(sweep))],
                              verbose=False, task_timeout_s=DEADLINE_S)
    statuses = sorted(r["status"] for r in state.values())
    assert statuses == ["done"] * 5 + ["failed"], statuses
    failed = next(r for r in state.values() if r["status"] == "failed")
    assert failed["note"] == "timeout" and failed["device"] == "bad" and failed["worker"] == 0
    assert failed["error"] == (f"TimeoutError: task exceeded farm deadline ({DEADLINE_S}s); "
                               "worker 0 retired")
    assert {r["device"] for r in state.values() if r["status"] == "done"} == {"good"}
    summary = [r for r in _records(tmp_path / "metrics.jsonl") if r.get("event")][-1]
    assert summary == {"event": "farm_summary", "n_workers": 2, "n_tasks": 5,
                       "workers": ["bad", "good"]}


def test_farm_prefetch_timeout_retires_worker_and_drains(tmp_path):
    """A prefetch still running at the deadline retires its worker after
    its first task; its ahead-claim goes back to the pool, and nothing is
    journaled failed."""
    wedge = threading.Event()  # never set: the prefetch never returns
    task = _stub(sweep)
    runner = sweep.SweepRunner(_timeout_cfg(tmp_path), task)
    state = runner.run_farmed(
        [DeviceWorker("bad", task, prefetch_fn=lambda s, m: wedge.wait()),
         DeviceWorker("good", task)], verbose=False, task_timeout_s=DEADLINE_S)
    assert sorted(r["status"] for r in state.values()) == ["done"] * 6
    by_dev = {}
    for r in state.values():
        by_dev[r["device"]] = by_dev.get(r["device"], 0) + 1
    assert by_dev == {"bad": 1, "good": 5}
    summary = [r for r in _records(tmp_path / "metrics.jsonl") if r.get("event")][-1]
    assert summary["n_tasks"] == 6


def test_farm_of_one_ahead_claims_last_task(tmp_path):
    prefetched = []
    cfg = SweepConfig(subjects=(1, 2), modalities=("eeg",),
                      journal_path=str(tmp_path / "journal.jsonl"),
                      metrics_path=str(tmp_path / "metrics.jsonl"))
    worker = DeviceWorker("w0", _stub(sweep), prefetch_fn=lambda s, m: prefetched.append((s, m)))
    state = sweep.SweepRunner(cfg, _stub(sweep)).run_farmed([worker], verbose=False)
    assert all(r["status"] == "done" for r in state.values())
    assert prefetched == [(2, "eeg")]


def test_run_batched_only_subjects_equals_jax(tmp_path):
    """Each package runs the pending subjects of its slice only, in groups
    cut inside the slice, and writes the same records."""
    jcfg, tcfg = _cfgs(tmp_path, subjects=(1, 2, 3, 4, 5), modalities=("eeg",))
    calls = {"jax": [], "torch": []}

    def batch_fn(module, name):
        def run(subjects):
            calls[name].append(tuple(subjects))
            return {s: module.TaskResult(metrics={"accuracy": 0.5}) for s in subjects}
        return run

    jr, tr = jax_sweep.SweepRunner(jcfg, None), sweep.SweepRunner(tcfg, None)
    for only in ({1, 2, 5}, {3, 4}):
        jr.run_batched("eeg", batch_fn(jax_sweep, "jax"), group_size=2, verbose=False,
                       only_subjects=only)
        tr.run_batched("eeg", batch_fn(sweep, "torch"), group_size=2, verbose=False,
                       only_subjects=only)
        if only == {1, 2, 5}:
            assert sorted(s for s, _ in tr.pending_tasks()) == [3, 4]
    assert calls["torch"] == calls["jax"] == [(1, 2), (5,), (3, 4)]
    for attr in ("journal_path", "metrics_path"):
        assert _records(getattr(tcfg, attr)) == _records(getattr(jcfg, attr))
    assert tr.pending_tasks() == []


def test_cli_chip_parallel_on_cpu_matches_serial(tmp_path):
    """``run --device cpu --chip-parallel 2 --subject-parallel 2``: the
    stacked EEG chunks ([1, 2] and [3]) spread over both workers' setups (no
    farmed task, both busy), the rows equal those of the same groups
    without the farm, and the deterministic mode is off again after the
    run."""
    from eav_tpu_torch.cli import main
    from test_torch_cli import SHRINK, _eeg_tree

    root = _eeg_tree(tmp_path / "EAV", subjects=(1, 2, 3))

    def run(name, *extra):
        assert main(["run", "--data-root", str(root), "--subjects", "1-3", "--modalities", "eeg",
                     "--out", str(tmp_path / name), "--device", "cpu", "--subject-parallel", "2",
                     "--deterministic", *SHRINK, *extra]) == 0
        return [json.loads(line) for line in open(tmp_path / name / "metrics.jsonl")]

    before = torch.are_deterministic_algorithms_enabled()
    plain, farmed = run("plain"), run("farm", "--chip-parallel", "2")
    assert torch.are_deterministic_algorithms_enabled() == before
    summary = [r for r in farmed if r.get("event") == "farm_summary"]
    assert len(summary) == 1 and summary[0]["n_tasks"] == 0 and summary[0]["n_workers"] == 2
    assert all(b > 0 for b in summary[0]["busy_s"]), summary
    by_subject = {r["subject"]: r for r in plain if "subject" in r}
    for r in (r for r in farmed if "subject" in r):
        want = by_subject[r["subject"]]
        for k in ("group_size", "accuracy", "weighted_f1", "confusion", "final_train_acc"):
            assert r[k] == want[k], k


def test_device_workers_take_cards_or_given_devices(monkeypatch):
    made = []
    workers = device_workers(lambda dev: made.append(dev) or ModalityPipelines(
        "/nonexistent", device=dev), devices=["cpu", torch.device("cpu")])
    assert [w.name for w in workers] == ["cpu", "cpu"] and made == [torch.device("cpu")] * 2
    assert all(w.prefetch_fn is not None and w.pipelines.device.type == "cpu" for w in workers)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="0 visible"):
        device_workers(lambda dev: None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 2 CUDA devices, 1 visible"):
        device_workers(lambda dev: None, n=2)
    assert [w.device for w in device_workers(lambda dev: None)] == [torch.device("cuda", 0)]


def test_deterministic_mode_holds_across_overlapping_threads():
    """Thread A enters the mode, B enters, A leaves while B is still
    inside: the mode stays on until B leaves too."""
    before = torch.are_deterministic_algorithms_enabled()
    a_in, b_in, a_out = threading.Event(), threading.Event(), threading.Event()
    seen = {}

    def a():
        with deterministic_algorithms(True):
            a_in.set()
            b_in.wait(10)
        a_out.set()

    def b():
        a_in.wait(10)
        with deterministic_algorithms(True):
            b_in.set()
            a_out.wait(10)
            seen["after_a_left"] = torch.are_deterministic_algorithms_enabled()

    threads = [threading.Thread(target=f) for f in (a, b)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    assert seen == {"after_a_left": True}
    assert torch.are_deterministic_algorithms_enabled() == before


def test_deterministic_flag_on_for_every_fit_of_a_two_worker_farm(tmp_path):
    """Every forward of every farmed fit (two workers, deterministic
    pipelines) runs with the mode on; it is off again after the farm."""
    presets = _presets()
    _seed_cache(tmp_path / "cache", presets)
    seen = []
    hook = torch.nn.modules.module.register_module_forward_pre_hook(
        lambda m, a: seen.append(torch.are_deterministic_algorithms_enabled()))
    try:
        before = torch.are_deterministic_algorithms_enabled()
        cfg = SweepConfig(subjects=SUBJECTS, modalities=("eeg",),
                          journal_path=str(tmp_path / "journal.jsonl"),
                          metrics_path=str(tmp_path / "metrics.jsonl"))
        workers = device_workers(lambda dev: ModalityPipelines(
            "/nonexistent", cache_dir=str(tmp_path / "cache"), presets=presets, device=dev,
            deterministic=True), devices=[torch.device("cpu")] * 2)
        state = sweep.SweepRunner(cfg, None).run_farmed(workers, verbose=False)
    finally:
        hook.remove()
    assert sorted(r["status"] for r in state.values()) == ["done"] * 4
    assert {r["worker"] for r in state.values()} == {0, 1}
    assert seen and all(seen)
    assert torch.are_deterministic_algorithms_enabled() == before


def test_farm_stress_journals_every_task_once(tmp_path):
    """16 workers (more than the cores) over 96 stub tasks with a short
    switch interval, prefetch on: each task journaled once, done, with one
    metrics row; and 16 threads counting kernel launches lose none."""
    from eav_tpu_torch.ops import attention as A

    cfg = SweepConfig(subjects=tuple(range(1, 49)), modalities=("eeg", "audio"),
                      journal_path=str(tmp_path / "journal.jsonl"),
                      metrics_path=str(tmp_path / "metrics.jsonl"))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [DeviceWorker(f"w{i}", _stub(sweep), prefetch_fn=lambda s, m: None)
                   for i in range(16)]
        sweep.SweepRunner(cfg, None).run_farmed(workers, verbose=False)
        A.reset_launches()
        threads = [threading.Thread(target=lambda: [A._count(A.flash_fwd) for _ in range(2000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert A.flash_fwd.launches == 16 * 2000
    A.reset_launches()
    journal = _records(cfg.journal_path)
    assert sorted(r["task"] for r in journal) == sorted(
        f"subject{s:02d}_{m}" for s in range(1, 49) for m in ("eeg", "audio"))
    assert all(r["status"] == "done" for r in journal)
    rows = _records(cfg.metrics_path)
    assert len(rows) == 97 and rows[-1]["n_tasks"] == 96
