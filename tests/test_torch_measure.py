"""The port's full-protocol measurement scripts on the CPU at tiny widths:
``eav_tpu_torch/scripts/measure_{audio,vision}_{flagship,repeats}.py``,
``probe_frozen_cache.py`` and ``farm_makespan.py``, against the JAX
package's scripts of the same names.

The JAX scripts assert a TPU and run their work in ``main``, so the JAX side
is their importable pieces (``make_audio_cache``, ``make_vision_cache``,
``load_walls``; loaded by path, their ``eav_tpu`` imports sit inside the
functions) and the keys of the dicts they print, read from their syntax
trees. The flagships run ``ast_tiny`` / ``vit_tiny`` widths at 1 frozen + 1
unfrozen epoch on caches of 400 trials; their warm subject's row must equal
a direct ``run_audio`` / ``run_vision`` at the same seed (and the audio
fit's archived test logits bit for bit), so the scripts measure the
production path.
"""

import ast
import collections
import importlib.util
import json
import os
import types

import numpy as np
import pytest

from eav_tpu_torch.scripts import farm_makespan as FM
from eav_tpu_torch.scripts import measure_audio_flagship as AF
from eav_tpu_torch.scripts import measure_audio_repeats as AR
from eav_tpu_torch.scripts import measure_vision_flagship as VF
from eav_tpu_torch.scripts import measure_vision_repeats as VR
from eav_tpu_torch.scripts import probe_frozen_cache as PF
from test_torch_parallel import one_thread  # noqa: F401  (one intra-op thread a test)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(hidden=32, layers=2, heads=2, mlp_dim=64)
AST_TINY = dict(TINY, max_frames=128)  # ast_tiny's widths
VIT_TINY = dict(TINY, image_size=32)  # vit_tiny's, at the cache's frame size
EPOCHS = (1, 1)
# the JAX scripts' keys the port drops: a TPU projection and the tunnel's A/B arm
DROPPED = {"v5e8_8way_minutes", "fence", "fence_chunks"}


def _jax_script(monkeypatch, tmp_path, name):
    """``scripts/<name>.py`` of the JAX package, loaded by path (its import
    sets a default compilation-cache variable, held to a scratch path)."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jax_cache"))
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_key_sets(name):
    """The key sets of the dict literals with constant keys in the JAX
    script ``scripts/<name>.py``, less the keys the port drops."""
    with open(os.path.join(REPO, "scripts", f"{name}.py")) as f:
        tree = ast.parse(f.read())
    return [frozenset(k.value for k in node.keys) - DROPPED for node in ast.walk(tree)
            if isinstance(node, ast.Dict) and node.keys
            and all(isinstance(k, ast.Constant) for k in node.keys)]


def _assert_keys_are_jaxs(lines, name, wrappers=()):
    """Each printed line (or the reading a one-key wrapper named in
    ``wrappers`` holds) has a JAX dict's keys plus the card's line."""
    want = _jax_key_sets(name)
    for line in lines:
        if len(line) == 1 and next(iter(line)) in wrappers:
            line = next(iter(line.values()))
        assert line.pop("device") == "cpu"
        assert frozenset(line) in want, sorted(line)


def _assert_same_files(got_dir, want_dir):
    names = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == names and names
    for n in names:
        with np.load(os.path.join(got_dir, n)) as g, np.load(os.path.join(want_dir, n)) as w:
            assert sorted(g.files) == sorted(w.files) == ["x", "y"]
            for k in w.files:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])
    assert os.stat(os.path.join(got_dir, names[0])).st_ino == os.stat(
        os.path.join(got_dir, names[-1])).st_ino  # a hard link


def test_caches_equal_the_jax_scripts(monkeypatch, tmp_path):
    """Same file names (the pipelines' keys) and the same arrays as the JAX
    scripts' ``make_audio_cache`` / ``make_vision_cache``."""
    from eav_tpu.train.pipeline import default_presets as jax_presets
    from eav_tpu_torch.train.pipeline import default_presets

    ja = _jax_script(monkeypatch, tmp_path, "measure_audio_flagship")
    jv = _jax_script(monkeypatch, tmp_path, "measure_vision_flagship")
    jp, tp = jax_presets(), default_presets()
    ja.make_audio_cache(str(tmp_path / "ja"), [1, 2], jp["audio"].audio, trials=10)
    AF.make_audio_cache(str(tmp_path / "ta"), [1, 2], tp["audio"].audio, trials=10)
    _assert_same_files(tmp_path / "ta", tmp_path / "ja")
    jv.make_vision_cache(str(tmp_path / "jv"), [1, 2], jp["vision"].vision, trials=10, size=32)
    VF.make_vision_cache(str(tmp_path / "tv"), [1, 2], tp["vision"].vision, trials=10, size=32)
    _assert_same_files(tmp_path / "tv", tmp_path / "jv")


def _archive(out, key, subject=2):
    return np.load(os.path.join(out, "logits", f"s{subject:02d}_{key}_test.npy"))


def test_audio_flagship_measures_run_audio(tmp_path, capsys):
    out = str(tmp_path / "measure")
    lines = AF.measure(out, "cpu", EPOCHS, frames=128, **AST_TINY)
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert printed == lines
    warm = lines[1]["audio_flagship_warm"]
    assert warm["epochs"] == 2 and warm["device"] == "cpu"
    assert lines[2]["serial_42_subjects_minutes"] == round(
        42 * lines[2]["warm_subject_seconds"] / 60, 3)
    direct_out = str(tmp_path / "direct")
    pipes = AF.flagship_pipelines(direct_out, "audio", "cpu", EPOCHS, **AST_TINY)
    AF.make_audio_cache(pipes.cache_dir, [2], pipes.presets["audio"].audio, frames=128)
    row = pipes.run_audio(2).metrics
    for k in ("accuracy", "epochs"):
        assert warm[k] == row[k], k
    np.testing.assert_array_equal(_archive(out, "audio"), _archive(direct_out, "audio"))
    _assert_keys_are_jaxs(lines, "measure_audio_flagship",
                          ("audio_flagship_cold", "audio_flagship_warm"))


def test_vision_flagship_measures_run_vision(tmp_path):
    out = str(tmp_path / "measure")
    lines = VF.measure(out, "cpu", EPOCHS, size=32, **VIT_TINY)
    assert [next(iter(line)) for line in lines[:3]] == [
        "vision_flagship_cold", "vision_flagship_warm", "vision_stacked2"]
    warm, stacked = lines[1]["vision_flagship_warm"], lines[2]["vision_stacked2"]
    assert warm["epochs"] == 2 and stacked["aggregate_samples_per_sec"] > 0
    direct_out = str(tmp_path / "direct")
    pipes = AF.flagship_pipelines(direct_out, "vision", "cpu", EPOCHS, **VIT_TINY)
    VF.make_vision_cache(pipes.cache_dir, [2], pipes.presets["vision"].vision, size=32)
    row = pipes.run_vision(2).metrics
    for k in ("accuracy", "epochs"):  # (the stacked pair rewrote the script's archives)
        assert warm[k] == row[k], k
    assert lines[3]["serial_42_subjects_minutes"] == round(
        42 * lines[3]["warm_subject_seconds"] / 60, 3)
    _assert_keys_are_jaxs(lines, "measure_vision_flagship",
                          ("vision_flagship_cold", "vision_flagship_warm", "vision_stacked2"))


@pytest.mark.parametrize("modality", ["audio", "vision"])
def test_flagship_minutes_come_from_the_printed_seconds(tmp_path, monkeypatch, modality):
    """The 42-subject minutes are 42 times the printed (rounded) warm
    seconds, JAX's rule: a warm wall of 0.84053 s prints 0.841 s and 0.589
    min, where the unrounded wall would give 0.588."""
    script = AF if modality == "audio" else VF
    stub = types.SimpleNamespace(metrics=collections.defaultdict(int))
    monkeypatch.setattr(script, "timed", lambda run, subject: (stub, 0.84053))
    if modality == "audio":
        lines = AF.measure(str(tmp_path), "cpu", EPOCHS, frames=128, **AST_TINY)
    else:
        lines = VF.measure(str(tmp_path), "cpu", EPOCHS, skip_stacked=True, size=32, **VIT_TINY)
    summary = lines[-1]
    assert summary["warm_subject_seconds"] == 0.841
    assert summary["serial_42_subjects_minutes"] == round(
        42 * summary["warm_subject_seconds"] / 60, 3) == 0.589


def test_stacked_pair_reads_out_of_memory(tmp_path, monkeypatch):
    """Running out of device memory in the stacked pair is a reading; any
    other error raises."""
    import torch

    pipes = AF.flagship_pipelines(str(tmp_path), "vision", "cpu", EPOCHS, **VIT_TINY)

    def oom(*a, **k):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(pipes, "run_stacked", oom)
    assert VF.stacked_pair(pipes, "cpu") == {"error": "OutOfMemoryError", "device": "cpu"}
    monkeypatch.setattr(pipes, "run_stacked", lambda *a: 1 / 0)
    with pytest.raises(ZeroDivisionError):
        VF.stacked_pair(pipes, "cpu")


@pytest.mark.parametrize("modality", ["audio", "vision"])
def test_repeats(tmp_path, modality):
    if modality == "audio":
        lines = AR.measure(str(tmp_path), 2, "cpu", EPOCHS, frames=128, **AST_TINY)
        name, metric = "measure_audio_repeats", "ast_subject_protocol_median"
    else:
        lines = VR.measure(str(tmp_path), 2, "cpu", EPOCHS, size=32, **VIT_TINY)
        name, metric = "measure_vision_repeats", "vit_subject_protocol_median"
    assert len(lines) == 4 and "cold_seconds" in lines[0]
    summary = lines[-1]
    assert summary["metric"] == metric
    assert summary["warm_walls_s"] == [line["warm_wall_s"] for line in lines[1:3]]
    assert summary["median_warm_s"] == float(np.median(summary["warm_walls_s"]))
    _assert_keys_are_jaxs(lines, name)


def test_frozen_probe_losses_equal_through_the_backbone():
    """The frozen epochs on cached features and through the frozen backbone
    give the same losses: the exactness ``_frozen_cache_ok`` claims."""
    lines = PF.probe("cpu", n_tr=40, n_te=20, size=32, epochs=2, **VIT_TINY)
    probes = [line["probe"] for line in lines[:-1]]
    assert probes == ["h2d_uint8_0.00GiB", "features_40_cold", "features_40_warm",
                      "features_20", "frozen_cached_2ep", "frozen_backbone_2ep",
                      "frozen_backbone_2ep", "frozen_cached_2ep"]
    losses = lines[-1]["frozen_losses"]
    assert len(losses["cached"]) == 2
    np.testing.assert_allclose(losses["cached"], losses["backbone"], rtol=1e-6, atol=0)


METRICS = [  # a handwritten sweep: a stacked EEG group of 3, two pairs of 2, serial tasks
    *({"subject": s, "modality": "eeg", "accuracy": 0.2, "group_size": 3,
       "wall_clock_s": 10.0} for s in (1, 2, 3)),
    *({"subject": s, "modality": "eeg_conformer", "accuracy": 0.2, "group_size": 2,
       "wall_clock_s": 4.5} for s in (1, 2, 3, 4)),
    *({"subject": s, "modality": m, "accuracy": 0.2, "wall_clock_s": w + s}
      for s in (1, 2, 3, 4) for m, w in (("audio", 3.0), ("vision", 8.0))),
    {"event": "farm_summary", "busy_s": [1.0]},
    {"subject": 4, "modality": "audio", "accuracy": None, "wall_clock_s": 99.0},
    *({"subject": s, "modality": "fusion", "accuracy": 0.2, "wall_clock_s": 1.0 + s / 10}
      for s in (1, 2, 3, 4)),
]


@pytest.fixture
def metrics_file(tmp_path):
    path = tmp_path / "metrics.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in METRICS))
    return str(path)


def test_load_walls_equals_jax(monkeypatch, tmp_path, metrics_file):
    jax_fm = _jax_script(monkeypatch, tmp_path, "farm_makespan")
    serial, groups, fusion = FM.load_walls(metrics_file)
    j_serial, j_groups, j_fusion = jax_fm.load_walls(metrics_file)
    assert serial == j_serial and fusion == j_fusion
    assert sorted(groups) == sorted(j_groups) == [9.0, 9.0, 30.0]


def test_replay_finishes_every_task(metrics_file):
    """Compare the table and the tasks done, never wall times."""
    lines = FM.project(metrics_file, workers=3, scale=0.001)
    assert lines[0]["tasks"] == 8 and lines[0]["stacked_seconds"] == 48.0
    proj = lines[1]
    assert proj["tasks_done"] == 8 and proj["n_workers"] == 3
    assert len(proj["per_worker_busy_min"]) == 3
    # the three groups are dealt round-robin to the three workers' setups
    assert sorted(proj["stacked_setup_min"]) == [0.15, 0.15, 0.5]
    assert "projection" in proj
