"""The port's EEG, audio and vision tasks end to end on the CPU, their
metrics rows against the JAX package's, the port's independence from JAX, and
its device rule."""

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
from eav_tpu_torch.core.config import (
    AudioPreprocConfig,
    FinetuneConfig,
    PhaseConfig,
    PresetConfig,
    SplitConfig,
    VisionPreprocConfig,
)
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


def _vit_preset(vote_mode="mean"):
    """ViT-tiny on uint8 face crops standing in for ViT-base, one frozen and
    one unfrozen epoch, 5-frame trials."""
    return PresetConfig(
        name="vit_tiny", description="", split=SplitConfig(h_idx=1),
        vision=VisionPreprocConfig(max_frames=60, frames_per_sample=5, face_detection=True,
                                   face_image_size=24),
        finetune=FinetuneConfig(
            model="vit", batch_size=4, weight_decay=0.01, eval_batch_size=8,
            phases=(PhaseConfig(1, 5e-4, True), PhaseConfig(1, 5e-6, False)),
            vote_group=5, vote_mode=vote_mode,
            model_kwargs=dict(hidden=32, layers=1, heads=2, mlp_dim=64, image_size=32,
                              preprocess_uint8=True, compute_dtype="bfloat16",
                              stream_dtype="bfloat16"),
        ),
    )


def test_run_vision_end_to_end(tmp_path, monkeypatch):
    """Five cv2-written clips of 60 frames: 10 frames each at stride 6, two
    5-frame trials per clip, one trial per class trains and one tests."""
    cv2 = pytest.importorskip("cv2")
    monkeypatch.delenv("EAV_TPU_MTCNN_WEIGHTS", raising=False)
    vdir = tmp_path / "EAV" / "subject01" / "Video"
    vdir.mkdir(parents=True)
    for i, emo in enumerate(EMOTIONS):
        w = cv2.VideoWriter(str(vdir / f"subject_01_Speaking_{i}_{emo}_.mp4"),
                            cv2.VideoWriter_fourcc(*"mp4v"), 30, (40, 32))
        for f in range(60):
            w.write(np.full((32, 40, 3), (40 * i + 2 * f) % 256, np.uint8))
        w.release()
    pipes = ModalityPipelines(str(tmp_path / "EAV"), cache_dir=str(tmp_path / "cache"),
                              logits_dir=str(tmp_path / "logits"),
                              presets={"vision": _vit_preset()}, device="cpu")
    res = pipes.run_vision(1)
    m = res.metrics
    assert set(m) == {"accuracy", "weighted_f1", "confusion", "final_train_acc", "epochs",
                      "fit_seconds", "samples_per_sec", "load_seconds", "archive_seconds"}
    assert m["epochs"] == 2 and np.asarray(m["confusion"]).sum() == 5  # 5 test trials
    assert np.isfinite(res.artifacts["history"]["loss"]).all()
    assert m["samples_per_sec"] > 0  # over frames: 25 train frames an epoch
    logits = tmp_path / "logits"
    assert sorted(os.listdir(logits)) == ["s01_vision_test.npy", "s01_vision_train.npy"]
    assert np.load(logits / "s01_vision_test.npy").shape == (5, 5)  # trial-voted
    assert np.load(logits / "s01_vision_train.npy").shape == (5, 5)
    # the frame cache, under the JAX package's key, serves the second run
    assert len(os.listdir(tmp_path / "cache")) == 1
    assert pipes.run_vision(1).metrics["accuracy"] == m["accuracy"]


@pytest.mark.parametrize("vote_mode", ["mean", "majority"])
def test_finish_vote_matches_jax(tmp_path, rng, vote_mode):
    """Frame logits voted per trial: the same metrics row in both packages."""
    import dataclasses

    result = _Result(
        params={},
        history={"loss": np.array([1.2], np.float32), "train_acc": np.array([0.4], np.float32),
                 "test_acc": np.array([0.3], np.float32)},
        outputs_test=rng.normal(size=(50, 5)).astype(np.float32),
    )
    te_y = np.repeat(rng.integers(0, 5, size=10), 5).astype(np.int32)
    jax_preset = jax_get_preset("vit_finetune")
    jax_preset = jax_preset.replace(finetune=dataclasses.replace(jax_preset.finetune,
                                                                 vote_mode=vote_mode))
    timing = dict(fit_seconds=2.5, n_train=75, load_seconds=0.25, archive_seconds=0.125)
    want = JaxPipelines(str(tmp_path / "j"), logits_dir=str(tmp_path / "j"))._finish(
        1, "vision", jax_preset, None, result, te_y, 5, **timing).metrics
    pipes = ModalityPipelines(str(tmp_path / "t"), logits_dir=str(tmp_path / "t"),
                              presets={"vision": _vit_preset(vote_mode)}, device="cpu")
    got = pipes._finish(1, "vision", result, te_y, vote_group=5, **timing).metrics
    assert got.keys() == want.keys()
    assert got["confusion"] == want["confusion"] and np.asarray(got["confusion"]).sum() == 10
    for key in want:
        if key != "confusion":
            assert got[key] == pytest.approx(want[key], rel=1e-6), key
    np.testing.assert_allclose(np.load(tmp_path / "t" / "s01_vision_test.npy"),
                               np.load(tmp_path / "j" / "s01_vision_test.npy"), rtol=1e-6)


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
print(" ".join(names))
"""


def test_port_and_chip_smoke_import_without_jax():
    out = subprocess.run([sys.executable, "-c", _NO_JAX, REPO], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    names = out.stdout.strip().splitlines()[-1].split()
    assert len(names) >= 40  # every module was imported
    assert {"eav_tpu_torch.parallel.subject", "eav_tpu_torch.models.fusion",
            "eav_tpu_torch.models.scnn_audio", "eav_tpu_torch.models.resnet_attn",
            "eav_tpu_torch.models.hf_import"} <= set(names)


def test_entry_points_default_to_cuda_and_refuse_without_it(tmp_path, monkeypatch):
    from eav_tpu_torch.ingest.audio import DataLoadAudio, ast_frontend, scnn_frontend
    from eav_tpu_torch.ingest.eeg import DataLoadEEG
    from eav_tpu_torch.ingest.video import DataLoadVision
    from eav_tpu_torch.ingest.vision import vit_pixel_values
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
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        scnn_frontend(np.zeros((1, 22050), np.float32))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        DataLoadVision(1, str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        vit_pixel_values(np.zeros((1, 8, 8, 3), np.uint8))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        ModalityPipelines(str(tmp_path), presets={"vision": _vit_preset()}).run_vision(1)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        DataLoadEEG(1, parent_directory=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        ModalityPipelines(str(tmp_path), presets={"eeg": _eeg_preset("eegnet")}).run_eeg(1)


def _eeg_preset(model):
    """The tiny EEGNet or a 2-layer conformer on 6 electrodes x 200 samples
    (8 s trials in 2 s chunks), two epochs: the first in train mode, the
    second in the sticky eval mode for EEGNet."""
    from eav_tpu_torch.core.config import EEGPreprocConfig

    kw = (dict(chans=6, samples=200, kern_length=16, f1=4, d=2, f2=8) if model == "eegnet"
          else dict(chans=6, samples=200, num_layers=2))
    return PresetConfig(
        name=model, description="", split=SplitConfig(h_idx=6),
        eeg=EEGPreprocConfig(channels=6, trial_seconds=8.0, chunk_seconds=2.0),
        finetune=FinetuneConfig(
            model=model, batch_size=8, optimizer="adam", weight_decay=0.0,
            phases=(PhaseConfig(2, 1e-3, False),), compat_softmax=True,
            compat_sticky_eval=model == "eegnet", model_kwargs=kw),
    )


def _eeg_subject(root, rng, trials=10):
    """A .mat subject, the EAV layout: (t, ch, tri) signal at 500 Hz and a
    (10, tri) one-hot whose listening rows 1, 3, 5, 7, 9 come in turn."""
    import scipy.io

    sdir = root / "subject01" / "EEG"
    sdir.mkdir(parents=True)
    scipy.io.savemat(str(sdir / "subject01_eeg.mat"), {"seg": rng.normal(size=(4000, 6, trials))})
    label = np.zeros((10, trials))
    label[(2 * np.arange(trials) + 1) % 10, np.arange(trials)] = 1
    scipy.io.savemat(str(sdir / "subject01_eeg_label.mat"), {"label": label})


@pytest.mark.parametrize("key,model", [("eeg", "eegnet"), ("eeg_conformer", "conformer_eeg")])
def test_run_eeg_end_to_end(tmp_path, rng, key, model):
    """40 chunks of 8 per class: 30 train, 10 test; the metrics row has the
    JAX package's keys and the cache file its name."""
    from eav_tpu.core.config import EEGPreprocConfig as JaxEEGPreprocConfig
    from eav_tpu.train.pipeline import _cfg_hash as jax_cfg_hash

    _eeg_subject(tmp_path / "EAV", rng)
    pipes = ModalityPipelines(str(tmp_path / "EAV"), cache_dir=str(tmp_path / "cache"),
                              logits_dir=str(tmp_path / "logits"),
                              presets={key: _eeg_preset(model)}, device="cpu")
    res = pipes.run_eeg(1, key)
    m = res.metrics
    assert set(m) == {"accuracy", "weighted_f1", "confusion", "final_train_acc", "epochs",
                      "fit_seconds", "samples_per_sec", "load_seconds", "archive_seconds"}
    assert m["epochs"] == 2 and np.asarray(m["confusion"]).sum() == 10
    assert np.isfinite(res.artifacts["history"]["loss"]).all()
    assert sorted(os.listdir(tmp_path / "logits")) == [f"s01_{key}_test.npy", f"s01_{key}_train.npy"]
    assert np.load(tmp_path / "logits" / f"s01_{key}_train.npy").shape == (30, 5)
    jax_key = jax_cfg_hash(JaxEEGPreprocConfig(channels=6, trial_seconds=8.0, chunk_seconds=2.0))
    assert os.listdir(tmp_path / "cache") == [f"s01_eeg_{jax_key}.npz"]
    assert pipes.run_eeg(1, key).metrics["accuracy"] == m["accuracy"]  # from the cache


def test_default_presets_and_models():
    """The EEG presets map to the JAX package's and build full-size models;
    the EEGNet preset takes the direct temporal convolution."""
    from eav_tpu.train.pipeline import default_presets as jax_default_presets
    from eav_tpu_torch.models.conformer_eeg import ConformerEEG
    from eav_tpu_torch.models.eegnet import EEGNet
    from eav_tpu_torch.train.pipeline import build_model, default_presets

    presets, jax_presets = default_presets(), jax_default_presets()
    for key in ("eeg", "eeg_conformer"):
        ft, jft = presets[key].finetune, jax_presets[key].finetune
        assert presets[key].name == jax_presets[key].name
        for field in ("model", "batch_size", "optimizer", "weight_decay", "compat_softmax",
                      "compat_sticky_eval", "seed", "shuffle"):
            assert getattr(ft, field) == getattr(jft, field), (key, field)
        assert [(p.epochs, p.lr, p.freeze) for p in ft.phases] == \
            [(p.epochs, p.lr, p.freeze) for p in jft.phases]
    eegnet = build_model(presets["eeg"])
    assert isinstance(eegnet, EEGNet) and eegnet.temporal_mode == "conv"
    assert isinstance(build_model(presets["eeg_conformer"]), ConformerEEG)


def test_load_eeg_falls_back_to_the_eeg_presets_config(tmp_path, rng):
    """A preset without an EEG config (``eeg_conformer`` here) preprocesses
    with the ``eeg`` preset's (a non-default one), as eav_tpu's load_eeg
    does: the same cache file and the same trials in both packages."""
    from eav_tpu.core.config import EEGPreprocConfig as JaxEEGPreprocConfig
    from eav_tpu.core.config import FinetuneConfig as JaxFinetuneConfig
    from eav_tpu.core.config import PhaseConfig as JaxPhaseConfig
    from eav_tpu.core.config import PresetConfig as JaxPresetConfig
    from eav_tpu.core.config import SplitConfig as JaxSplitConfig

    _eeg_subject(tmp_path / "EAV", rng)
    presets = {"eeg": _eeg_preset("eegnet"),
               "eeg_conformer": _eeg_preset("conformer_eeg").replace(eeg=None)}
    jax_ft = JaxFinetuneConfig(model="conformer_eeg", batch_size=8,
                               phases=(JaxPhaseConfig(2, 1e-3, False),))
    jax_eeg = JaxEEGPreprocConfig(channels=6, trial_seconds=8.0, chunk_seconds=2.0)
    jax_presets = {
        "eeg": JaxPresetConfig(name="eegnet", description="", split=JaxSplitConfig(h_idx=6),
                               eeg=jax_eeg, finetune=jax_ft),
        "eeg_conformer": JaxPresetConfig(name="conformer", description="",
                                         split=JaxSplitConfig(h_idx=6), finetune=jax_ft),
    }
    want_x, want_y = JaxPipelines(str(tmp_path / "EAV"), cache_dir=str(tmp_path / "jax"),
                                  presets=jax_presets).load_eeg(1, "eeg_conformer")
    got_x, got_y = ModalityPipelines(str(tmp_path / "EAV"), cache_dir=str(tmp_path / "torch"),
                                     presets=presets, device="cpu").load_eeg(1, "eeg_conformer")
    assert os.listdir(tmp_path / "torch") == os.listdir(tmp_path / "jax")
    assert got_x.shape == (40, 6, 200)
    np.testing.assert_array_equal(got_y, want_y)
    scale = float(np.abs(want_x).max())
    np.testing.assert_allclose(got_x, want_x, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("frontend", ["fbank", "scnn180"])
def test_audio_cache_key_matches_jax(frontend):
    """``AudioPreprocConfig`` is copied whole, so the audio cache key (the
    preset's config hash) is the JAX package's, for both frontends."""
    from eav_tpu.core.config import AudioPreprocConfig as JaxAudioPreprocConfig
    from eav_tpu.train.pipeline import _cfg_hash as jax_cfg_hash
    from eav_tpu_torch.train.pipeline import _cfg_hash

    preset = {"fbank": "ast_finetune", "scnn180": "scnn_audio"}[frontend]
    from eav_tpu_torch.core.config import get_preset

    assert _cfg_hash(get_preset(preset).audio) == jax_cfg_hash(jax_get_preset(preset).audio)
    assert get_preset(preset).audio.frontend == frontend
    kw = dict(frontend=frontend, max_frames=128, scnn_sr=16000)
    assert _cfg_hash(AudioPreprocConfig(**kw)) == jax_cfg_hash(JaxAudioPreprocConfig(**kw))


@pytest.mark.parametrize("key", ["eeg", "eeg_conformer", "audio", "audio_scnn", "vision",
                                 "vision_resnet", "fusion"])
def test_default_presets_hold_every_jax_key(key):
    """All seven modality keys, each with the JAX preset's name, trainer
    fields, phases and ingest configs (the same hashes), and a model the
    port builds; ``task_fn`` knows each key."""
    import dataclasses

    from eav_tpu.train.pipeline import _cfg_hash as jax_cfg_hash
    from eav_tpu.train.pipeline import default_presets as jax_default_presets
    from eav_tpu_torch.train.pipeline import _cfg_hash, build_model, default_presets

    presets, jax_presets = default_presets(), jax_default_presets()
    assert set(presets) == set(jax_presets)
    p, jp = presets[key], jax_presets[key]
    assert p.name == jp.name
    want = dataclasses.asdict(jp.finetune)
    for field, value in dataclasses.asdict(p.finetune).items():
        if field != "model_kwargs":  # EEGNet's temporal_mode is chosen on the H100
            assert value == want[field], (key, field)
    for part in ("eeg", "audio", "vision"):
        a, b = getattr(p, part), getattr(jp, part)
        assert (a is None) == (b is None) and (a is None or _cfg_hash(a) == jax_cfg_hash(b))
    if key == "fusion":
        return
    model = build_model(p) if key not in ("audio", "vision") else None
    names = {"eeg": "EEGNet", "eeg_conformer": "ConformerEEG", "audio_scnn": "SCNNAudio",
             "vision_resnet": "ResNetAttn"}
    if model is not None:
        assert type(model).__name__ == names[key]
