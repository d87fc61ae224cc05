"""The per-(subject, modality) tasks: ingest -> EAV split -> fine-tune ->
metrics, as ``eav_tpu/train/pipeline.py`` runs them for the ``ast_finetune``
(audio) and ``vit_finetune`` (vision) presets.

Preprocessed fbanks and decoded frame stacks are cached as ``.npz`` per
(subject, config hash) when a cache directory is given, under the JAX
package's keys, and read back through ``fast_npz_load``; logits are archived
per subject when a logits directory is given (the vision ones trial-voted).
The metrics row has the JAX package's keys.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from dataclasses import asdict
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from eav_tpu_torch.core import metrics as M
from eav_tpu_torch.core.config import (
    NUM_CLASSES,
    AudioPreprocConfig,
    PresetConfig,
    VisionPreprocConfig,
    get_preset,
    model_kwargs,
)
from eav_tpu_torch.core.device import resolve_device
from eav_tpu_torch.core.sweep import TaskResult
from eav_tpu_torch.ingest.split import eav_split
from eav_tpu_torch.train.loop import Trainer


def default_presets() -> Dict[str, PresetConfig]:
    """Modality key -> preset, for the modalities the port runs so far."""
    return {"audio": get_preset("ast_finetune"), "vision": get_preset("vit_finetune")}


def _cfg_hash(cfg) -> str:
    return hashlib.sha1(json.dumps(asdict(cfg), sort_keys=True, default=str).encode()).hexdigest()[:10]


def _cached(cache_dir: Optional[str], key: str,
            compute: Callable[[], Tuple[np.ndarray, np.ndarray]]):
    if cache_dir is None:
        return compute()
    path = os.path.join(cache_dir, key + ".npz")
    if os.path.exists(path):
        from eav_tpu_torch.ingest.npz import fast_npz_load

        z = fast_npz_load(path)
        return z["x"], z["y"]
    x, y = compute()
    os.makedirs(cache_dir, exist_ok=True)
    # write, then rename over the old file: a reader's mmap keeps the old inode
    tmp = path + f".{os.getpid()}.tmp.npz"
    try:
        np.savez(tmp, x=x, y=y)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return x, y


def build_model(preset: PresetConfig):
    """The model of a preset's finetune config."""
    name = preset.finetune.model
    if name == "ast":
        from eav_tpu_torch.models.ast import AST

        return AST(**model_kwargs(preset))
    if name == "vit":
        from eav_tpu_torch.models.vit import ViT

        return ViT(**model_kwargs(preset))
    raise KeyError(f"model {name!r} is not ported yet")


class ModalityPipelines:
    """Task functions bound to a data root, cache and logit directories, and
    a device (``"cuda"`` unless the caller passes another)."""

    def __init__(
        self,
        data_root: str,
        cache_dir: Optional[str] = None,
        logits_dir: Optional[str] = None,
        presets: Optional[Dict[str, PresetConfig]] = None,
        seed: int = 0,
        device="cuda",
    ):
        self.data_root = data_root
        self.cache_dir = cache_dir
        self.logits_dir = logits_dir
        self.seed = seed
        self.device = resolve_device(device)
        self.presets = presets or default_presets()
        self._trainers: Dict[str, Trainer] = {}  # one per preset, reused across subjects

    def _trainer(self, preset_key: str, preset: PresetConfig) -> Trainer:
        t = self._trainers.get(preset_key)
        if t is None:
            t = Trainer(build_model(preset), preset.finetune, device=self.device)
            self._trainers[preset_key] = t
        return t

    def load_audio(self, subject: int):
        """(fbanks (N, frames, mels), labels) of a subject's 5 s segments."""
        cfg = self.presets["audio"].audio or AudioPreprocConfig()

        def compute():
            from eav_tpu_torch.ingest.audio import DataLoadAudio, ast_frontend

            segs, y = DataLoadAudio(subject, self.data_root, cfg, device=self.device).process()
            return ast_frontend(segs, cfg, device=self.device), y

        return _cached(self.cache_dir, f"s{subject:02d}_aud_fbank_{_cfg_hash(cfg)}", compute)

    def load_vision(self, subject: int):
        """(frames (trials, frames, H, W, 3) uint8, labels) of a subject's
        Speaking clips."""
        cfg = self.presets["vision"].vision or VisionPreprocConfig()

        def compute():
            from eav_tpu_torch.ingest.video import DataLoadVision

            return DataLoadVision(subject, self.data_root, cfg, device=self.device).process()

        return _cached(self.cache_dir, f"s{subject:02d}_vis_{_cfg_hash(cfg)}", compute)

    def _save_logits(self, subject: int, modality: str, split: str, logits: np.ndarray):
        if self.logits_dir is None:
            return
        os.makedirs(self.logits_dir, exist_ok=True)
        path = os.path.join(self.logits_dir, f"s{subject:02d}_{modality}_{split}.npy")
        tmp = path + f".tmp.{os.getpid()}"  # readers never see a partial archive
        with open(tmp, "wb") as f:
            np.save(f, logits)
        os.replace(tmp, path)

    def _finish(self, subject, modality, result, te_y, vote_group: Optional[int] = None,
                fit_seconds: Optional[float] = None, n_train: Optional[int] = None,
                load_seconds: Optional[float] = None,
                archive_seconds: Optional[float] = None) -> TaskResult:
        """The metrics row (the JAX package's keys) and the test-logit
        archive. With ``vote_group`` the test rows are frames: they are voted
        per trial (the preset's ``vote_mode``) and the archive holds the
        trial-mean logits."""
        logits = result.outputs_test
        if vote_group:
            tl, pred = M.trial_vote(logits, vote_group)
            if self.presets[modality].finetune.vote_mode == "majority":
                pred = M.trial_majority_vote(logits, vote_group, NUM_CLASSES)
            te_y_trial = np.asarray(te_y).reshape(-1, vote_group)[:, 0]
            summary = M.classification_summary(te_y_trial, pred, NUM_CLASSES)
            self._save_logits(subject, modality, "test", tl.numpy())
        else:
            pred = np.argmax(logits, axis=-1)
            summary = M.classification_summary(np.asarray(te_y), pred, NUM_CLASSES)
            self._save_logits(subject, modality, "test", logits)
        epochs = int(len(result.history["test_acc"]))
        metrics = {
            "accuracy": summary["accuracy"],
            "weighted_f1": summary["weighted_f1"],
            "confusion": summary["confusion"],
            "final_train_acc": float(result.history["train_acc"][-1]),
            "epochs": epochs,
        }
        if fit_seconds and n_train:
            metrics["fit_seconds"] = round(fit_seconds, 3)
            metrics["samples_per_sec"] = round(epochs * n_train / fit_seconds, 2)
            metrics["load_seconds"] = round(load_seconds or 0.0, 3)
            metrics["archive_seconds"] = round(archive_seconds or 0.0, 3)
        return TaskResult(
            metrics=metrics, artifacts={"params": result.params, "history": result.history}
        )

    def _load_split_audio(self, subject: int):
        """(tr_x, tr_y, te_x, te_y): features as float32 tensors on the
        device (one host-to-device copy, shared by fit and the archive
        predict), labels as arrays."""
        split = self.presets["audio"].split
        x, y = self.load_audio(subject)
        tr_x, tr_y, te_x, te_y = eav_split(x, y, h_idx=split.h_idx, num_classes=split.num_classes)
        to_dev = lambda a: torch.as_tensor(a, dtype=torch.float32).to(self.device)  # noqa: E731
        return to_dev(tr_x), tr_y, to_dev(te_x), te_y

    def run_audio(self, subject: int) -> TaskResult:
        """The AST fine-tune of one subject (the ``audio`` preset)."""
        key = "audio"
        t0 = time.perf_counter()
        data = self._load_split_audio(subject)
        load_s = time.perf_counter() - t0
        trainer = self._trainer(key, self.presets[key])
        t0 = time.perf_counter()
        result = trainer.fit(data, seed=self.seed + subject)
        fit_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        if self.logits_dir is not None:
            self._save_logits(subject, key, "train", trainer.predict(data[0]))
        archive_s = time.perf_counter() - t0
        return self._finish(subject, key, result, data[3],
                            fit_seconds=fit_s, n_train=len(data[0]),
                            load_seconds=load_s, archive_seconds=archive_s)

    def _load_split_vision(self, subject: int):
        """(tr_f, tr_fy, te_f, te_fy, frames per trial): the split by trials,
        flattened to frames. uint8 frames go to the device once; the host
        preprocessing runs only for a model without ``preprocess_uint8``."""
        from eav_tpu_torch.ingest.vision import flatten_trials_to_frames, preprocess_frames

        preset = self.presets["vision"]
        x, y = self.load_vision(subject)  # (trials, frames, H, W, 3) uint8
        tr_x, tr_y, te_x, te_y = eav_split(x, y, h_idx=preset.split.h_idx,
                                           num_classes=preset.split.num_classes)
        fps = x.shape[1]
        tr_f, tr_fy = flatten_trials_to_frames(tr_x, tr_y)
        te_f, te_fy = flatten_trials_to_frames(te_x, te_y)
        kw = preset.finetune.model_kwargs or {}
        if not kw.get("preprocess_uint8"):
            size = kw.get("image_size", 224)
            tr_f = preprocess_frames(tr_f, size=size, device=self.device)
            te_f = preprocess_frames(te_f, size=size, device=self.device)
        to_dev = lambda a: torch.as_tensor(a).to(self.device)  # noqa: E731
        return to_dev(tr_f), tr_fy, to_dev(te_f), te_fy, fps

    def run_vision(self, subject: int) -> TaskResult:
        """The ViT fine-tune of one subject (the ``vision`` preset), scored
        by the per-trial vote over its frames."""
        key = "vision"
        t0 = time.perf_counter()
        tr_f, tr_fy, te_f, te_fy, fps = self._load_split_vision(subject)
        load_s = time.perf_counter() - t0
        trainer = self._trainer(key, self.presets[key])
        t0 = time.perf_counter()
        result = trainer.fit((tr_f, tr_fy, te_f, te_fy), seed=self.seed + subject)
        fit_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        if self.logits_dir is not None:
            tr_logits = trainer.predict(tr_f)
            self._save_logits(subject, key, "train", M.trial_vote(tr_logits, fps)[0].numpy())
        archive_s = time.perf_counter() - t0
        return self._finish(subject, key, result, te_fy, vote_group=fps,
                            fit_seconds=fit_s, n_train=len(tr_f),
                            load_seconds=load_s, archive_seconds=archive_s)
