"""The port's sweep runtime against the JAX package's: ``SweepRunner``
(journal, metrics, resume, retries, a torn last line, ``run_batched``'s
bisection, ``aggregate``) on the same stub task functions, the npz
checkpoints each package reads from the other, the trainer's per-phase
checkpoints, and the pipelines' prefetch and ``task_fn`` under a sweep."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from eav_tpu.core import checkpoint as jax_ckpt
from eav_tpu.core import sweep as jax_sweep
from eav_tpu.core.config import SweepConfig as JaxSweepConfig
from eav_tpu_torch.core import checkpoint as ckpt
from eav_tpu_torch.core import sweep
from eav_tpu_torch.core.config import FinetuneConfig, PhaseConfig, SweepConfig

# what differs between two runs of the same tasks
VOLATILE = {"ts", "wall_clock_s", "traceback"}


@pytest.fixture
def no_orbax(monkeypatch):
    """The JAX package's checkpoints in their npz form (it writes Orbax
    directories when Orbax imports)."""
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)


def _task_fn(module):
    """A stub task of ``module``'s TaskResult: subject 3 has no data."""
    def task(subject, modality):
        if subject == 3:
            raise FileNotFoundError(f"no data for subject{subject:02d}")
        acc = 0.1 * subject + (0.05 if modality == "audio" else 0.0)
        return module.TaskResult(
            metrics={"accuracy": acc, "weighted_f1": acc / 2, "confusion": [[subject, 1], [0, 2]]},
            artifacts={"params": {"w": np.arange(4.0) * subject},
                       "history": {"loss": np.array([1.0, 0.5]) / subject}})
    return task


def _batch_fn(module):
    """A stub stacked task: a group that holds subject 3 fails."""
    task = _task_fn(module)

    def batch(subjects):
        if 3 in subjects:
            raise RuntimeError(f"group {subjects} failed")
        return {s: task(s, "eeg") for s in subjects}
    return batch


def _runners(tmp_path, **kw):
    """The two packages' runners, each on its own journal, metrics file and
    checkpoint directory."""
    out = []
    for name, module, cfg_cls in (("jax", jax_sweep, JaxSweepConfig), ("torch", sweep, SweepConfig)):
        d = tmp_path / name
        cfg = cfg_cls(journal_path=str(d / "journal.jsonl"), metrics_path=str(d / "metrics.jsonl"),
                      checkpoint_dir=str(d / "ckpt"), **kw)
        out.append(module.SweepRunner(cfg, _task_fn(module)))
    return out


def _records(path):
    with open(path) as f:
        return [{k: v for k, v in json.loads(line).items() if k not in VOLATILE} for line in f]


def _assert_same_files(jr, tr):
    for attr in ("journal_path", "metrics_path"):
        got, want = _records(getattr(tr.cfg, attr)), _records(getattr(jr.cfg, attr))
        assert got == want and want


def test_sweep_runner_writes_the_jax_records_and_resumes(tmp_path, no_orbax):
    kw = dict(subjects=(1, 2, 3), modalities=("eeg", "audio"), max_retries=1)
    jr, tr = _runners(tmp_path, **kw)
    jr.run(verbose=False)
    tr.run(verbose=False)
    _assert_same_files(jr, tr)
    state = tr.journal_state()
    assert [state[t]["status"] for t in sorted(state)] == ["done"] * 4 + ["failed"] * 2
    assert state["subject03_eeg"]["error"] == "FileNotFoundError: no data for subject03"
    # a new runner retries the failed tasks once (max_retries 1), then has none pending
    jr, tr = _runners(tmp_path, **kw)
    assert tr.pending_tasks() == jr.pending_tasks() == [(3, "eeg"), (3, "audio")]
    jr.run(verbose=False)
    tr.run(verbose=False)
    _assert_same_files(jr, tr)
    assert tr.journal_state()["subject03_audio"]["attempts"] == 2
    assert tr.pending_tasks() == jr.pending_tasks() == []
    # each task's artifacts, saved by each package, read by the other
    for tid in ("subject01_eeg", "subject02_audio"):
        from_torch = jax_ckpt.load_pytree(str(tmp_path / "torch" / "ckpt" / tid))
        from_jax = ckpt.load_pytree(str(tmp_path / "jax" / "ckpt" / tid))
        for tree in (from_torch, from_jax):
            np.testing.assert_array_equal(tree["params"]["w"], np.arange(4.0) * int(tid[7:9]))
            np.testing.assert_array_equal(tree["history"]["loss"],
                                          np.array([1.0, 0.5]) / int(tid[7:9]))
    assert tr.aggregate() == jr.aggregate()


def test_a_torn_last_line_is_not_yet_written(tmp_path):
    """A journal's last line cut mid-append reads as absent in both
    packages; a torn line before the last is corruption and raises."""
    path = tmp_path / "journal.jsonl"
    good = json.dumps({"task": "subject01_eeg", "status": "done", "attempts": 1})
    path.write_text(good + "\n" + '{"task": "subject02_e')
    assert sweep._read_jsonl(str(path)) == jax_sweep._read_jsonl(str(path)) == [json.loads(good)]
    path.write_text('{"task": "subject02_e\n' + good + "\n")
    for read in (sweep._read_jsonl, jax_sweep._read_jsonl):
        with pytest.raises(json.JSONDecodeError):
            read(str(path))


def test_run_batched_bisects_a_failing_group_as_jax_does(tmp_path, no_orbax):
    """Groups of 4 over subjects 1-5: [1, 2, 3, 4] fails, its halves run on
    their own, [3] falls back to the serial task and fails; every record
    has the serial path's keys."""
    kw = dict(subjects=(1, 2, 3, 4, 5), modalities=("eeg",), max_retries=0)
    jr, tr = _runners(tmp_path, **kw)
    prefetched = []
    jr.run_batched("eeg", _batch_fn(jax_sweep), group_size=4, verbose=False)
    tr.run_batched("eeg", _batch_fn(sweep), group_size=4, verbose=False,
                   prefetch_fn=lambda s, m: prefetched.append((s, m)))
    _assert_same_files(jr, tr)
    assert prefetched == [(5, "eeg")]
    state = tr.journal_state()
    assert [state[f"subject0{s}_eeg"]["status"] for s in range(1, 6)] == [
        "done", "done", "failed", "done", "done"]
    assert state["subject03_eeg"]["stacked_error"] == "RuntimeError: group [3] failed"
    serial = _records(tr.cfg.metrics_path)
    assert {k for r in serial for k in r} == {"accuracy", "weighted_f1", "confusion", "subject",
                                              "modality"}
    assert tr.pending_tasks() == []


def test_aggregate_is_the_mean_and_std_of_the_latest_rows(tmp_path, no_orbax):
    kw = dict(subjects=(1, 2, 4, 5), modalities=("eeg", "audio"))
    jr, tr = _runners(tmp_path, **kw)
    for r in (jr, tr):
        r.run(verbose=False)
        # a rerun of subject01_eeg: its latest row counts
        sweep._append_jsonl(r.cfg.metrics_path, {"subject": 1, "modality": "eeg",
                                                 "accuracy": 0.9, "weighted_f1": 0.8})
    got = tr.aggregate()
    assert got == jr.aggregate()
    acc = np.array([0.9, 0.2, 0.4, 0.5])
    assert got["eeg"] == pytest.approx({"n_subjects": 4, "mean_accuracy": np.mean(acc),
                                        "std_accuracy": np.std(acc),
                                        "mean_weighted_f1": np.mean([0.8, 0.1, 0.2, 0.25])},
                                       rel=1e-12)
    np.testing.assert_allclose(got["audio"]["mean_accuracy"], np.mean(acc[1:].tolist() + [0.1])
                               + 0.05)


def test_each_package_reads_the_others_npz(tmp_path, no_orbax):
    tree = {"params": {"conv.weight": torch.arange(6.0).reshape(2, 3),
                       "steps": torch.tensor(3)},
            "history": {"loss": np.array([0.5, 0.25], np.float32)}}
    ckpt.save_pytree(str(tmp_path / "t" / "a"), tree)
    jax_ckpt.save_pytree(str(tmp_path / "j" / "a"), {
        "params": {k: ckpt._leaf(v) for k, v in tree["params"].items()},
        "history": tree["history"]})
    for got in (jax_ckpt.load_pytree(str(tmp_path / "t" / "a")),
                ckpt.load_pytree(str(tmp_path / "j" / "a"))):
        np.testing.assert_array_equal(got["params"]["conv.weight"], np.arange(6.0).reshape(2, 3))
        assert got["params"]["steps"] == 3
        np.testing.assert_array_equal(got["history"]["loss"], tree["history"]["loss"])
    assert sorted(os.listdir(tmp_path / "t")) == ["a.npz"]  # no temporary left behind


def test_the_port_refuses_an_orbax_directory(tmp_path):
    pytest.importorskip("orbax.checkpoint")
    jax_ckpt.save_pytree(str(tmp_path / "o"), {"w": np.ones(3, np.float32)})
    assert os.path.isdir(tmp_path / "o")
    with pytest.raises(ValueError, match="Orbax"):
        ckpt.load_pytree(str(tmp_path / "o"))
    with pytest.raises(FileNotFoundError):
        ckpt.load_pytree(str(tmp_path / "absent"))


def _eegnet_trainer(lr=1e-2):
    """Tiny EEGNet (dropout, BatchNorm, max-norm) in a frozen then an
    unfrozen phase."""
    from eav_tpu_torch.models.eegnet import EEGNet
    from eav_tpu_torch.train.loop import Trainer

    cfg = FinetuneConfig(model="eegnet", batch_size=4, optimizer="adam", weight_decay=0.0,
                         phases=(PhaseConfig(2, lr, True), PhaseConfig(2, 1e-3, False)))
    model = EEGNet(nb_classes=5, chans=4, samples=64, kern_length=16, f1=4, d=2, f2=8)
    return Trainer(model, cfg, device="cpu")


def _eeg_split(rng):
    return (rng.normal(size=(10, 4, 64)).astype(np.float32), np.arange(10) % 5,
            rng.normal(size=(5, 4, 64)).astype(np.float32), np.arange(5))


def test_fit_resumed_after_phase_0_equals_an_uninterrupted_fit(tmp_path, rng):
    data = _eeg_split(rng)
    whole = _eegnet_trainer().fit(data, seed=3)
    d = str(tmp_path / "ckpt")
    first = _eegnet_trainer().fit(data, seed=3, checkpoint_dir=d)
    np.testing.assert_array_equal(first.outputs_test, whole.outputs_test)
    assert sorted(os.listdir(d)) == ["fingerprint.txt", "phase0.npz", "phase1.npz"]
    os.remove(os.path.join(d, "phase1.npz"))  # the fit stopped after phase 0
    resumed = _eegnet_trainer().fit(data, seed=3, checkpoint_dir=d)
    np.testing.assert_array_equal(resumed.outputs_test, whole.outputs_test)
    for k in whole.params:
        torch.testing.assert_close(resumed.params[k], whole.params[k], rtol=0, atol=0)
    for k in ("loss", "train_acc", "test_acc"):  # the history of the phase it ran
        np.testing.assert_array_equal(resumed.history[k], whole.history[k][2:])
    # every phase written: the restored model's result, nothing trained
    done = _eegnet_trainer().fit(data, seed=3, checkpoint_dir=d)
    np.testing.assert_array_equal(done.outputs_test, whole.outputs_test)
    assert np.isnan(done.history["loss"]).all()
    np.testing.assert_allclose(done.history["test_acc"], whole.history["test_acc"][-1:], rtol=1e-6)
    with pytest.raises(ValueError, match="another configuration"):
        _eegnet_trainer(lr=2e-2).fit(data, seed=3, checkpoint_dir=d)


def test_sweep_of_pipeline_tasks_with_prefetch(tmp_path, rng):
    """``ModalityPipelines.task_fn`` under the runner, with ``prefetch``:
    subject 1 and a link to it fit, subject 3 (no data) fails in its own
    record; the prefetched split is the one the task fits on, and every
    task's artifacts reload equal to the metrics' fit."""
    from test_torch_pipeline import _eeg_preset, _eeg_subject

    from eav_tpu_torch.train.pipeline import ModalityPipelines

    root = tmp_path / "EAV"
    _eeg_subject(root, rng)
    (root / "subject02" / "EEG").mkdir(parents=True)
    for suffix in ("eeg.mat", "eeg_label.mat"):
        os.symlink(root / "subject01" / "EEG" / f"subject01_{suffix}",
                   root / "subject02" / "EEG" / f"subject02_{suffix}")
    pipes = ModalityPipelines(str(root), presets={"eeg": _eeg_preset("eegnet")}, device="cpu")
    pipes.prefetch(2, "eeg")
    assert list(pipes._prefetched) == [("eeg", 2)]
    cfg = SweepConfig(subjects=(1, 2, 3), modalities=("eeg",), max_retries=1,
                      journal_path=str(tmp_path / "j.jsonl"), metrics_path=str(tmp_path / "m.jsonl"),
                      checkpoint_dir=str(tmp_path / "ckpt"))
    state = sweep.SweepRunner(cfg, pipes.task_fn).run(verbose=False, prefetch_fn=pipes.prefetch)
    assert [state[f"subject0{s}_eeg"]["status"] for s in (1, 2, 3)] == ["done", "done", "failed"]
    assert pipes._prefetched == {}  # every parked split was taken
    rows = sweep._read_jsonl(cfg.metrics_path)
    assert [r["subject"] for r in rows] == [1, 2]
    saved = ckpt.load_pytree(str(tmp_path / "ckpt" / "subject01_eeg"))
    direct = pipes.run_eeg(1, "eeg")
    assert direct.metrics["accuracy"] == rows[0]["accuracy"]
    for k, v in direct.artifacts["params"].items():
        np.testing.assert_array_equal(saved["params"][k], v.numpy())
