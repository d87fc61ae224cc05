"""The port's audio task end to end on the CPU, its metrics row against the
JAX package's, its independence from JAX, and its device rule."""

import os
import subprocess
import sys
from typing import NamedTuple

import numpy as np
import pytest
import torch

from eav_tpu.core.config import get_preset as jax_get_preset
from eav_tpu.ingest.wav import write_wav
from eav_tpu.train.pipeline import ModalityPipelines as JaxPipelines
from eav_tpu_torch.core.config import AudioPreprocConfig, FinetuneConfig, PhaseConfig, PresetConfig, SplitConfig
from eav_tpu_torch.train.pipeline import ModalityPipelines

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EMOTIONS = ["Neutral", "Sadness", "Anger", "Happiness", "Calmness"]


class _Result(NamedTuple):
    params: dict
    history: dict
    outputs_test: np.ndarray


def _tiny_preset():
    """AST-tiny standing in for AST-base, one frozen and one unfrozen epoch."""
    return PresetConfig(
        name="ast_tiny", description="", split=SplitConfig(h_idx=1),
        audio=AudioPreprocConfig(max_frames=128),
        finetune=FinetuneConfig(
            model="ast", batch_size=4, weight_decay=0.01,
            phases=(PhaseConfig(1, 5e-4, True), PhaseConfig(1, 5e-6, False)),
            model_kwargs=dict(hidden=32, layers=1, heads=2, mlp_dim=64, max_frames=128,
                              compute_dtype="bfloat16", stream_dtype="bfloat16",
                              attn_impl="auto"),
        ),
    )


def _subject(root, rng):
    adir = root / "subject01" / "Audio"
    adir.mkdir(parents=True)
    sr = 32000  # resampled to 16 kHz; two 5 s segments per file
    t = np.arange(10 * sr) / sr
    for i, emo in enumerate(EMOTIONS):
        x = 0.3 * np.sin(2 * np.pi * (200 + 100 * i) * t) + 0.01 * rng.normal(size=t.size)
        write_wav(str(adir / f"subject_01_Speaking_{i}_{emo}_.wav"), x, sr)


def test_finish_row_matches_jax(tmp_path, rng):
    """The same fit result gives the same metrics row in both packages."""
    result = _Result(
        params={},
        history={"loss": np.array([1.2, 0.9], np.float32),
                 "train_acc": np.array([0.4, 0.6], np.float32),
                 "test_acc": np.array([0.3, 0.5], np.float32)},
        outputs_test=rng.normal(size=(12, 5)).astype(np.float32),
    )
    te_y = rng.integers(0, 5, size=12).astype(np.int32)
    timing = dict(fit_seconds=2.5, n_train=28, load_seconds=0.25, archive_seconds=0.125)
    want = JaxPipelines(str(tmp_path))._finish(
        1, "audio", jax_get_preset("ast_finetune"), None, result, te_y, None, **timing).metrics
    got = ModalityPipelines(str(tmp_path), device="cpu")._finish(
        1, "audio", result, te_y, **timing).metrics
    assert got.keys() == want.keys()
    assert got["confusion"] == want["confusion"]
    for key in want:
        if key != "confusion":
            assert got[key] == pytest.approx(want[key], rel=1e-6), key


def test_run_audio_end_to_end(tmp_path, rng):
    root = tmp_path / "EAV"
    _subject(root, rng)
    pipes = ModalityPipelines(str(root), cache_dir=str(tmp_path / "cache"),
                              logits_dir=str(tmp_path / "logits"),
                              presets={"audio": _tiny_preset()}, device="cpu")
    res = pipes.run_audio(1)
    m = res.metrics
    assert set(m) == {"accuracy", "weighted_f1", "confusion", "final_train_acc", "epochs",
                      "fit_seconds", "samples_per_sec", "load_seconds", "archive_seconds"}
    assert m["epochs"] == 2 and np.asarray(m["confusion"]).sum() == 5  # 1 test segment x 5
    assert np.isfinite(res.artifacts["history"]["loss"]).all()
    assert sorted(os.listdir(tmp_path / "logits")) == ["s01_audio_test.npy", "s01_audio_train.npy"]
    assert np.load(tmp_path / "logits" / "s01_audio_test.npy").shape == (5, 5)
    # the fbank cache serves the second run, with the same data
    assert len(os.listdir(tmp_path / "cache")) == 1
    again = pipes.run_audio(1)
    assert again.metrics["accuracy"] == m["accuracy"]


_NO_JAX = r"""
import importlib, pkgutil, sys
BLOCKED = {"jax", "jaxlib", "flax", "optax", "eav_tpu"}

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
sys.path.insert(0, sys.argv[1])
import eav_tpu_torch
names = [m.name for m in pkgutil.walk_packages(eav_tpu_torch.__path__, "eav_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
assert not BLOCKED & {m.split(".")[0] for m in sys.modules}
print(len(names))
"""


def test_port_and_chip_smoke_import_without_jax():
    out = subprocess.run([sys.executable, "-c", _NO_JAX, REPO], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 15  # every module was imported


def test_entry_points_default_to_cuda_and_refuse_without_it(tmp_path, monkeypatch):
    from eav_tpu_torch.ingest.audio import DataLoadAudio, ast_frontend
    from eav_tpu_torch.models.ast import ast_tiny
    from eav_tpu_torch.train.loop import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        ModalityPipelines(str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        Trainer(ast_tiny(), _tiny_preset().finetune)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        DataLoadAudio(1, str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        ast_frontend(np.zeros((1, 16000), np.float32))
