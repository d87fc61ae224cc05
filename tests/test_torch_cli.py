"""The port's CLI (``eav_tpu_torch/cli.py``), config overrides and profiling
helpers against the JAX package's: ``apply_overrides`` /
``parse_override_value`` / ``load_override_file`` on the cases of
``tests/test_cli.py``, ``_partition_stacked_chunks`` on those of
``tests/test_sweep.py``, the ``presets`` output and ``format_summary``, a
CPU ``cli run`` on the synthetic EEG tree of ``tests/test_cli.py`` against
JAX's ``main([...run...])`` (records field for field; archived logits to
rtol = atol = 1e-4, the EEGNet trajectory bound of
``tests/test_torch_train.py``), the refusals of ``run``, ``--profile`` and
``debug_nans``."""

import dataclasses
import json
import sys

import jax
import numpy as np
import pytest
import torch

from eav_tpu import cli as jax_cli
from eav_tpu.core import config as jax_config
from eav_tpu.train.pipeline import default_presets as jax_default_presets
from eav_tpu_torch import cli
from eav_tpu_torch.core import config
from eav_tpu_torch.ingest import mat5
from eav_tpu_torch.train.pipeline import default_presets

from test_torch_parallel import one_thread  # noqa: F401  (one intra-op thread a test)

# the EEG tree of tests/test_cli.py and its --set overrides
SHRINK = [
    "--set", "eeg.eeg.channels=4",
    "--set", "eeg.eeg.trial_seconds=8.0",
    "--set", "eeg.eeg.chunk_seconds=2.0",
    "--set", "eeg.split.h_idx=2",
    "--set", "eeg.finetune.phases.0.epochs=2",
    "--set", "eeg.finetune.model_kwargs.chans=4",
    "--set", "eeg.finetune.model_kwargs.samples=200",
    "--set", "eeg.finetune.model_kwargs.kern_length=16",
]
# what differs between two runs of the same tasks
VOLATILE = {"ts", "wall_clock_s", "fit_seconds", "samples_per_sec", "load_seconds",
            "archive_seconds"}


def _eeg_tree(root, subjects=(1,)):
    rng = np.random.default_rng(0)
    for s in subjects:
        sdir = root / f"subject{s:02d}" / "EEG"
        sdir.mkdir(parents=True)
        seg = rng.normal(size=(4000, 4, 20))  # 8 s at 500 Hz, 4 channels, 20 trials
        label = np.zeros((10, 20))
        label[np.asarray([1, 3, 5, 7, 9] * 4), np.arange(20)] = 1
        mat5.savemat(str(sdir / f"subject{s:02d}_eeg.mat"), {"seg": seg})
        mat5.savemat(str(sdir / f"subject{s:02d}_eeg_label.mat"), {"label": label})
    return root


def _records(path):
    with open(path) as f:
        return [{k: v for k, v in json.loads(line).items() if k not in VOLATILE} for line in f]


def _shared_fields(a, b):
    """``a`` and ``b`` (dataclasses, tuples, dicts) as plain trees over the
    fields both packages have."""
    if dataclasses.is_dataclass(a):
        a, b = dataclasses.asdict(a), dataclasses.asdict(b)
    if isinstance(a, dict) and isinstance(b, dict):
        keys = set(a) & set(b)
        return {k: _shared_fields(a[k], b[k])[0] for k in keys}, \
            {k: _shared_fields(a[k], b[k])[1] for k in keys}
    return a, b


OVERRIDES = [
    "audio.finetune.phases.0.epochs=2",
    "audio.finetune.phases.1.lr=1e-5",
    "eeg.split.h_idx=40",
    "eeg.eeg.band=(3, 50)",
    "eeg.finetune.model_kwargs.temporal_mode=conv",
    "vision.finetune.batch_size=64",
]


def test_apply_overrides_equals_jax():
    got = config.apply_overrides(default_presets(), OVERRIDES)
    want = jax_config.apply_overrides(jax_default_presets(), OVERRIDES)
    assert set(got) == set(want)
    for key in want:
        a, b = _shared_fields(got[key], want[key])
        assert a == b, key
    assert got["eeg"].eeg.band == (3, 50) and got["audio"].finetune.phases[1].lr == 1e-5
    assert default_presets()["audio"].finetune.phases[0].epochs == 10  # immutable replace
    for raw in ("true", "False", "none", "null", "fft", "5e-4", "(3, 50)", "[1, 2]", "{'a': 1}"):
        assert config.parse_override_value(raw) == jax_config.parse_override_value(raw), raw
    for bad, err, match in ((["bogus.finetune.batch_size=1"], KeyError, "unknown preset"),
                            (["eeg.finetune.batchsize=1"], KeyError, "has no field"),
                            (["eeg.finetune.batch_size"], ValueError, "path=value")):
        for mod, presets in ((config, default_presets()), (jax_config, jax_default_presets())):
            with pytest.raises(err, match=match):
                mod.apply_overrides(presets, bad)


@pytest.mark.parametrize("fmt", ["yaml", "json_without_pyyaml"])
def test_override_file_equals_jax(tmp_path, monkeypatch, fmt):
    """A nested file read as YAML, and (PyYAML blocked, as on the card's
    machine) as JSON: the same flat overrides and presets as JAX's."""
    path = tmp_path / "sweep.cfg"
    path.write_text('{"audio": {"finetune": {"phases": {"0": {"epochs": 3, "lr": "1e-3"}}}},'
                    ' "eeg": {"split": {"h_idx": 40}}}')
    if fmt != "yaml":
        monkeypatch.setitem(sys.modules, "yaml", None)
    flat = config.load_override_file(str(path))
    assert flat == jax_config.load_override_file(str(path))
    got = config.apply_overrides(default_presets(), flat)
    assert got["audio"].finetune.phases[0].lr == 1e-3  # the string parsed
    assert got["eeg"].split.h_idx == 40
    want = jax_config.apply_overrides(jax_default_presets(), flat)
    assert _shared_fields(got["audio"], want["audio"])[0] == \
        _shared_fields(got["audio"], want["audio"])[1]
    path.write_text("[1, 2]")
    with pytest.raises(ValueError, match="mapping"):
        config.load_override_file(str(path))


@pytest.mark.parametrize("stacked,pending,n_workers", [
    ([("eeg", 4)], {"eeg": list(range(1, 11))}, 8),
    ([("eeg", 4)], {"eeg": list(range(1, 11))}, 2),
    ([("eeg", 4), ("audio_scnn", 8)], {"eeg": [1, 2], "audio_scnn": [1, 2]}, 8),
    ([], {}, 8),
], ids=["spread", "wrap", "two_families", "none"])
def test_partition_stacked_chunks_equals_jax(stacked, pending, n_workers):
    got = cli._partition_stacked_chunks(stacked, pending, n_workers)
    assert got == jax_cli._partition_stacked_chunks(stacked, pending, n_workers)


def test_parse_subjects_presets_and_format_summary_equal_jax(capsys):
    for spec in ("1-3,7,10-11", "42", "1-42"):
        assert cli._parse_subjects(spec) == jax_cli._parse_subjects(spec)
    agg = {"eeg": {"n_subjects": 42, "mean_accuracy": 0.367, "std_accuracy": 0.05,
                   "mean_weighted_f1": 0.341},
           "audio": {"n_subjects": 3, "mean_accuracy": 0.5, "std_accuracy": 0.0,
                     "mean_weighted_f1": None}}
    assert cli.format_summary(agg) == jax_cli.format_summary(agg)
    assert cli.main(["presets"]) == 0
    got = capsys.readouterr().out.splitlines()
    assert jax_cli.main(["presets"]) == 0
    want = capsys.readouterr().out.splitlines()
    assert got[: len(want)] == want  # every JAX preset line, as JAX prints it
    listed = {line.split()[0] for line in got[len(want) + 2:]}
    assert listed == set(default_presets())


def test_aggregate_command_equals_jax(tmp_path, capsys):
    with open(tmp_path / "metrics.jsonl", "w") as f:
        for s, acc in ((1, 0.4), (2, 0.5)):
            f.write(json.dumps({"subject": s, "modality": "eeg", "accuracy": acc,
                                "weighted_f1": acc - 0.05}) + "\n")
        f.write(json.dumps({"event": "farm_summary", "n_tasks": 2}) + "\n")
    (tmp_path / "journal.jsonl").touch()
    assert cli.main(["aggregate", "--out", str(tmp_path)]) == 0
    got = capsys.readouterr().out
    assert jax_cli.main(["aggregate", "--out", str(tmp_path)]) == 0
    assert got == capsys.readouterr().out and "45.0%" in got


def _jax_eegnet_init(seed):
    """The EEGNet weights JAX's trainer draws at ``seed`` for the shrunk
    preset (``JitTrainer.fit``: the second half of the seed key's split),
    in the port's names."""
    from eav_tpu.models.eegnet import EEGNet as JaxEEGNet
    from eav_tpu_torch.models.bridge import eegnet_params_from_jax

    mj = JaxEEGNet(chans=4, samples=200, kern_length=16, dropout_rate=0.0,
                   temporal_mode="conv")
    k_init = jax.random.split(jax.random.PRNGKey(seed))[1]
    v = mj.init({"params": k_init, "dropout": k_init}, np.zeros((1, 4, 200), np.float32),
                train=False)
    v = jax.tree.map(np.asarray, v)
    return eegnet_params_from_jax(v["params"], v["batch_stats"])


def test_cli_run_cpu_matches_jax(tmp_path, monkeypatch):
    """``run --device cpu`` and JAX's ``run`` on the same tree and overrides
    (dropout 0, in-order batches, the direct temporal conv in both): the
    journal and metrics rows have JAX's fields and values, and the archived
    logits agree, the port started from the weights JAX draws."""
    from eav_tpu_torch.train import loop

    root = _eeg_tree(tmp_path / "EAV")
    same = [*SHRINK, "--set", "eeg.finetune.model_kwargs.dropout_rate=0.0",
            "--set", "eeg.finetune.shuffle=false",
            "--set", "eeg.finetune.model_kwargs.temporal_mode=conv"]
    args = ["run", "--data-root", str(root), "--subjects", "1", "--modalities", "eeg", *same]
    assert jax_cli.main([*args, "--out", str(tmp_path / "jax")]) == 0
    fit = loop.Trainer.fit
    monkeypatch.setattr(loop.Trainer, "fit", lambda self, data, seed=None, **kw: fit(
        self, data, seed, init_params=_jax_eegnet_init(seed)))
    assert cli.main([*args, "--out", str(tmp_path / "torch"), "--device", "cpu"]) == 0
    for name in ("journal.jsonl", "metrics.jsonl"):
        got, want = _records(tmp_path / "torch" / name), _records(tmp_path / "jax" / name)
        assert [set(r) for r in got] == [set(r) for r in want], name
        for g, w in zip(got, want):
            for k in w:
                if k in ("accuracy", "weighted_f1", "final_train_acc"):
                    assert g[k] == pytest.approx(w[k], abs=1e-4), k
                else:
                    assert g[k] == w[k], k
    for split, n in (("train", 10), ("test", 70)):
        got = np.load(tmp_path / "torch" / "logits" / f"s01_eeg_{split}.npy")
        assert got.shape == (n, 5)
        np.testing.assert_allclose(got, np.load(tmp_path / "jax" / "logits" /
                                                f"s01_eeg_{split}.npy"), rtol=1e-4, atol=1e-4)


def test_run_refusals(tmp_path, monkeypatch):
    """``run`` takes the card unless told otherwise; ``--data-parallel``
    beside ``--chip-parallel`` (JAX's message), more ``--data-parallel``
    ranks or ``--chip-parallel`` workers than cards, and an unknown
    override field all stop it before any fit."""
    root = _eeg_tree(tmp_path / "EAV")
    base = ["run", "--data-root", str(root), "--subjects", "1", "--modalities", "eeg",
            "--out", str(tmp_path / "out"), *SHRINK]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        cli.main(base)
    with pytest.raises(SystemExit, match="--chip-parallel and --data-parallel are mutually"):
        cli.main([*base, "--device", "cpu", "--data-parallel", "2", "--chip-parallel", "1"])
    with pytest.raises(KeyError, match="has no field"):
        cli.main([*base, "--device", "cpu", "--set", "eeg.split.no_such_field=1"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="only 1 CUDA devices"):
        cli.main([*base, "--chip-parallel", "2"])
    with pytest.raises(SystemExit, match="--data-parallel 2 requested but only 1 devices"):
        cli.main([*base, "--data-parallel", "2"])
    with pytest.raises(SystemExit, match="rank r the card cuda:r"):
        cli.main([*base, "--data-parallel", "2", "--device", "cuda:0"])
    assert not (tmp_path / "out" / "journal.jsonl").exists()


def test_cli_profile_writes_a_trace(tmp_path):
    root = _eeg_tree(tmp_path / "EAV")
    logdir = tmp_path / "trace"
    assert cli.main(["run", "--data-root", str(root), "--subjects", "1", "--modalities", "eeg",
                     "--out", str(tmp_path / "out"), "--device", "cpu", "--profile",
                     str(logdir), *SHRINK, "--set", "eeg.finetune.phases.0.epochs=1"]) == 0
    traces = list(logdir.glob("trace-*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("conv2d" in e.get("name", "") for e in events)
    spans = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"sweep.task", "fit.epoch", "trainer.train_step", "trainer.evaluate"} <= spans


def test_debug_nans_raises_and_restores():
    """A NaN from a module's forward and one from a backward both raise
    ``FloatingPointError``; the hook and the anomaly mode are gone after."""
    from eav_tpu_torch.utils.profiling import debug_nans, fence

    before = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
    lin = torch.nn.Linear(3, 2)
    bad = torch.tensor([[float("nan"), 1.0, 2.0]])
    with pytest.raises(FloatingPointError, match="Linear.forward"):
        with debug_nans():
            lin(bad)
    w = torch.tensor([0.0, 1.0], requires_grad=True)
    with pytest.raises(FloatingPointError, match="nan values"):
        with debug_nans():
            (torch.sqrt(w) * 0).sum().backward()  # 0 * inf in SqrtBackward
    assert (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled()) == before
    assert torch.isnan(lin(bad)).any()  # no hook left
    with debug_nans(False):
        lin(bad)
    fence({"a": lin(torch.ones(1, 3)), "b": [np.ones(2)]})
    fence({})
