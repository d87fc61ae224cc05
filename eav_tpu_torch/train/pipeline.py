"""The per-(subject, modality) tasks: ingest -> EAV split -> fine-tune ->
metrics, as ``eav_tpu/train/pipeline.py`` runs them for every preset: the
``eegnet_subject`` and ``conformer_eeg`` (EEG), ``ast_finetune`` and
``scnn_audio`` (audio), ``vit_finetune`` and ``resnet_vision`` (vision) and
``fusion_sweep`` (late fusion of the archived logits); ``run_stacked`` fits a
group of subjects of one modality as one stacked program
(``parallel/subject.py``). AST, ViT and ResNetAttn fits start from a local
checkpoint when ``EAV_TPU_AST_CKPT`` / ``EAV_TPU_VIT_CKPT`` (HF directories)
or ``EAV_TPU_RESNET_CKPT`` (a torchvision ``resnet50`` state-dict file) is
set (``_pretrained_params``).

Preprocessed EEG trials, audio features and decoded frame stacks are cached as
``.npz`` per (subject, config hash) when a cache directory is given, under
the JAX package's keys, and read back through ``fast_npz_load``; logits are
archived per subject when a logits directory is given (the vision ones
trial-voted). The metrics row has the JAX package's keys. The fits run
under torch's deterministic mode when the pipelines are built with
``deterministic=True`` (``core/device.py``). ``task_fn`` is the sweep's
task (``core/sweep.SweepRunner``), and ``prefetch`` loads the next task's
split while the current one fits.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from dataclasses import asdict
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from eav_tpu_torch.core import metrics as M
from eav_tpu_torch.core.config import (
    NUM_CLASSES,
    AudioPreprocConfig,
    EEGPreprocConfig,
    PresetConfig,
    VisionPreprocConfig,
    get_preset,
    model_kwargs,
)
from eav_tpu_torch.core.device import resolve_device
from eav_tpu_torch.core.optim import HEAD_REGEX
from eav_tpu_torch.core.sweep import TaskResult
from eav_tpu_torch.ingest.split import eav_split
from eav_tpu_torch.train.loop import Trainer, TrainResult, writes_files


def default_presets() -> Dict[str, PresetConfig]:
    """The modality key -> preset map the sweep runs by default."""
    return {
        "eeg": get_preset("eegnet_subject"),
        "eeg_conformer": get_preset("conformer_eeg"),
        "audio": get_preset("ast_finetune"),
        "audio_scnn": get_preset("scnn_audio"),
        "vision": get_preset("vit_finetune"),
        "vision_resnet": get_preset("resnet_vision"),
        "fusion": get_preset("fusion_sweep"),
    }


# the variable that points each pretrainable model at its local checkpoint
CKPT_ENV = {"ast": "EAV_TPU_AST_CKPT", "vit": "EAV_TPU_VIT_CKPT",
            "resnet_attn": "EAV_TPU_RESNET_CKPT"}


def _pretrained_params(model_name: str, num_labels: int = NUM_CLASSES,
                       cache: Optional[dict] = None) -> Optional[Dict[str, torch.Tensor]]:
    """The pretrained weights of ``model_name`` as a possibly partial state
    dict for ``Trainer.fit(init_params=...)``, or None when its variable
    (``CKPT_ENV``) is unset or empty:

    - ``ast`` / ``vit``: an HF checkpoint directory (`Transformer_Audio.py:22-24`,
      `Transformer_Vision.py:28-30`), every weight, the classifier swapped for
      ``num_labels`` outputs (``models/hf_import.py``);
    - ``resnet_attn``: a torchvision ``resnet50`` state-dict file
      (`CNN_Vision.py:32`): the ``backbone.*`` weights and BatchNorm stats
      only, so that the attention and the head start fresh, as the
      reference's new layers do.

    A set variable that names no checkpoint raises ``FileNotFoundError``:
    nothing falls back to random weights (the JAX package returns None for a
    path that does not exist). With ``cache``, the converted weights are kept
    there per (model, labels, path), so a sweep reads a checkpoint once."""
    env = CKPT_ENV.get(model_name)
    path = os.environ.get(env, "") if env else ""
    if not path:
        return None
    key = (model_name, num_labels, path)
    if cache is not None and key in cache:
        return cache[key]
    if model_name == "resnet_attn":
        if not os.path.isfile(path):
            raise FileNotFoundError(f"{env}={path!r} is not a file")
        from eav_tpu_torch.models.resnet_attn import convert_torchvision_resnet50

        out = convert_torchvision_resnet50(torch.load(path, map_location="cpu", weights_only=True))
    else:
        from eav_tpu_torch.models import hf_import

        sd = hf_import.load_state_dict_from_dir(path)
        convert = (hf_import.convert_ast_state_dict if model_name == "ast"
                   else hf_import.convert_vit_state_dict)
        out = convert(sd, num_labels=num_labels)
    if cache is not None:
        cache[key] = out
    return out


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


def build_model(preset: PresetConfig, **overrides):
    """The model of a preset's finetune config; ``overrides`` replace its
    model kwargs."""
    name = preset.finetune.model
    kwargs = {**model_kwargs(preset), **overrides}
    if name == "eegnet":
        from eav_tpu_torch.models.eegnet import EEGNet

        return EEGNet(**kwargs)
    if name == "conformer_eeg":
        from eav_tpu_torch.models.conformer_eeg import ConformerEEG

        return ConformerEEG(**kwargs)
    if name == "scnn_audio":
        from eav_tpu_torch.models.scnn_audio import SCNNAudio

        return SCNNAudio(**kwargs)
    if name == "ast":
        from eav_tpu_torch.models.ast import AST

        return AST(**kwargs)
    if name == "vit":
        from eav_tpu_torch.models.vit import ViT

        return ViT(**kwargs)
    if name == "resnet_attn":
        from eav_tpu_torch.models.resnet_attn import ResNetAttn

        return ResNetAttn(**kwargs)
    if name == "fusion":
        from eav_tpu_torch.models.fusion import FusionHead

        return FusionHead(**kwargs)
    raise KeyError(f"unknown model {name!r}")


class ModalityPipelines:
    """Task functions bound to a data root, cache and logit directories, and
    a device (``"cuda"`` unless the caller passes another); ``deterministic``
    runs every fit under torch's deterministic mode.

    ``mesh`` (``parallel/mesh.py``, a ``data`` axis): the vision fine-tunes
    run data-parallel over it (``Trainer.fit(mesh=)``), as the JAX
    package's do; every other task runs whole on each rank. In a process
    group only rank 0 writes archives (the train split's logits are
    predicted there alone)."""

    def __init__(
        self,
        data_root: str,
        cache_dir: Optional[str] = None,
        logits_dir: Optional[str] = None,
        presets: Optional[Dict[str, PresetConfig]] = None,
        seed: int = 0,
        device="cuda",
        deterministic: bool = False,
        mesh=None,
    ):
        self.data_root = data_root
        self.mesh = mesh
        self.cache_dir = cache_dir
        self.logits_dir = logits_dir
        self.seed = seed
        self.device = resolve_device(device)
        self.deterministic = deterministic
        self.presets = presets or default_presets()
        self._trainers: Dict[str, Trainer] = {}  # one per preset, reused across subjects
        self._pretrained: dict = {}  # converted checkpoints (_pretrained_params)
        # (modality, subject) -> a split on the device parked by ``prefetch``
        self._prefetched: Dict[Tuple[str, int], Any] = {}
        self._prefetch_lock = threading.Lock()

    def _trainer(self, preset_key: str, preset: PresetConfig) -> Trainer:
        """One trainer per preset; a model that freezes another set than the
        head (ResNetAttn: the backbone) gives its own ``HEAD_REGEX``."""
        t = self._trainers.get(preset_key)
        if t is None:
            model = build_model(preset)
            t = Trainer(model, preset.finetune, getattr(model, "HEAD_REGEX", HEAD_REGEX),
                        device=self.device, deterministic=self.deterministic)
            self._trainers[preset_key] = t
        return t

    def load_eeg(self, subject: int, preset_key: str = "eeg"):
        """(trials (N, ch, samples), labels) of a subject's EEG, preprocessed
        on the pipelines' device. A preset without an EEG config takes the
        ``eeg`` preset's, as the JAX package does."""
        preset = self.presets.get(preset_key) or self.presets["eeg"]
        cfg = preset.eeg or (self.presets["eeg"].eeg or EEGPreprocConfig())

        def compute():
            from eav_tpu_torch.ingest.eeg import DataLoadEEG

            return DataLoadEEG(subject, cfg, self.data_root, device=self.device).prepare_data()

        return _cached(self.cache_dir, f"s{subject:02d}_eeg_{_cfg_hash(cfg)}", compute)

    def load_audio(self, subject: int, frontend: str = "fbank"):
        """(features, labels) of a subject's 5 s segments: fbanks (N, frames,
        mels) of 16 kHz segments (``frontend='fbank'``, the ``audio``
        preset's config), or the (N, 180) SCNN features of 22.05 kHz ones
        (``'scnn180'``, the ``audio_scnn`` preset's)."""
        cfg = self.presets["audio" if frontend == "fbank" else "audio_scnn"].audio
        cfg = cfg or AudioPreprocConfig()

        def compute():
            from eav_tpu_torch.ingest.audio import DataLoadAudio, ast_frontend, scnn_frontend

            loader = DataLoadAudio(subject, self.data_root, cfg, device=self.device)
            if frontend == "fbank":
                segs, y = loader.process(target_sr=cfg.target_sr)
                return ast_frontend(segs, cfg, device=self.device), y
            segs, y = loader.process(target_sr=cfg.scnn_sr)
            return scnn_frontend(segs, cfg, device=self.device), y

        return _cached(self.cache_dir, f"s{subject:02d}_aud_{frontend}_{_cfg_hash(cfg)}", compute)

    def load_vision(self, subject: int, preset_key: str = "vision"):
        """(frames (trials, frames, H, W, 3) uint8, labels) of a subject's
        Speaking clips, under the ``preset_key`` preset's vision config."""
        cfg = self.presets[preset_key].vision or VisionPreprocConfig()

        def compute():
            from eav_tpu_torch.ingest.video import DataLoadVision

            return DataLoadVision(subject, self.data_root, cfg, device=self.device).process()

        return _cached(self.cache_dir, f"s{subject:02d}_vis_{_cfg_hash(cfg)}", compute)

    def _archives(self) -> bool:
        """Whether this process writes logit archives."""
        return self.logits_dir is not None and writes_files()

    def _save_logits(self, subject: int, modality: str, split: str, logits: np.ndarray):
        if not self._archives():
            return
        os.makedirs(self.logits_dir, exist_ok=True)
        path = os.path.join(self.logits_dir, f"s{subject:02d}_{modality}_{split}.npy")
        tmp = path + f".tmp.{os.getpid()}"  # readers never see a partial archive
        with open(tmp, "wb") as f:
            np.save(f, logits)
        os.replace(tmp, path)

    def _score(self, subject: int, modality: str, logits: np.ndarray, te_y,
               vote_group: Optional[int] = None) -> dict:
        """Accuracy, weighted F1 and confusion of the test logits, which are
        archived. With ``vote_group`` the test rows are frames: they are voted
        per trial (the preset's ``vote_mode``) and the archive holds the
        trial-mean logits."""
        if vote_group:
            tl, pred = M.trial_vote(logits, vote_group)
            if self.presets[modality].finetune.vote_mode == "majority":
                pred = M.trial_majority_vote(logits, vote_group, NUM_CLASSES)
            te_y_trial = np.asarray(te_y).reshape(-1, vote_group)[:, 0]
            self._save_logits(subject, modality, "test", tl.numpy())
            return M.classification_summary(te_y_trial, pred, NUM_CLASSES)
        self._save_logits(subject, modality, "test", logits)
        return M.classification_summary(np.asarray(te_y), np.argmax(logits, axis=-1), NUM_CLASSES)

    def _finish(self, subject, modality, result, te_y, vote_group: Optional[int] = None,
                fit_seconds: Optional[float] = None, n_train: Optional[int] = None,
                load_seconds: Optional[float] = None,
                archive_seconds: Optional[float] = None) -> TaskResult:
        """The metrics row (the JAX package's keys) and the test-logit
        archive (``_score``)."""
        summary = self._score(subject, modality, result.outputs_test, te_y, vote_group)
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

    def _to_device(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32).to(self.device)

    def _load_split_eeg(self, subject: int, preset_key: str):
        """(tr_x, tr_y, te_x, te_y): trials as float32 tensors on the device,
        labels as arrays."""
        split = self.presets[preset_key].split
        x, y = self.load_eeg(subject, preset_key)
        tr_x, tr_y, te_x, te_y = eav_split(x, y, h_idx=split.h_idx, num_classes=split.num_classes)
        return self._to_device(tr_x), tr_y, self._to_device(te_x), te_y

    def _run(self, subject: int, key: str, data,
             init_params: Optional[Dict[str, torch.Tensor]] = None
             ) -> Tuple[TrainResult, float, float]:
        """Fit the ``key`` preset's model on ``data`` = (tr_x, tr_y, te_x,
        te_y) from ``init_params`` (overlaid on the seeded init) and archive
        its train logits -> (result, fit seconds, archive seconds)."""
        trainer = self._trainer(key, self.presets[key])
        t0 = time.perf_counter()
        result = trainer.fit(data, seed=self.seed + subject, init_params=init_params)
        fit_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        if self._archives():
            self._save_logits(subject, key, "train", trainer.predict(data[0]))
        archive_s = time.perf_counter() - t0
        return result, fit_s, archive_s

    def run_eeg(self, subject: int, preset_key: str = "eeg") -> TaskResult:
        """The EEG fit of one subject: EEGNet (``eeg``, the default) or the
        conformer (``eeg_conformer``)."""
        t0 = time.perf_counter()
        data = self._take_or_load(subject, preset_key,
                                  lambda: self._load_split_eeg(subject, preset_key))
        load_s = time.perf_counter() - t0
        result, fit_s, archive_s = self._run(subject, preset_key, data)
        return self._finish(subject, preset_key, result, data[3],
                            fit_seconds=fit_s, n_train=len(data[0]),
                            load_seconds=load_s, archive_seconds=archive_s)

    def _load_split_audio(self, subject: int, key: str, frontend: str):
        """(tr_x, tr_y, te_x, te_y): features as float32 tensors on the
        device (one host-to-device copy, shared by fit and the archive
        predict), labels as arrays."""
        split = self.presets[key].split
        x, y = self.load_audio(subject, frontend)
        tr_x, tr_y, te_x, te_y = eav_split(x, y, h_idx=split.h_idx, num_classes=split.num_classes)
        return self._to_device(tr_x), tr_y, self._to_device(te_x), te_y

    def run_audio(self, subject: int, frontend: str = "fbank") -> TaskResult:
        """The audio fit of one subject: the AST fine-tune on fbanks (the
        ``audio`` preset, the default) or the SCNN on the 180-d features
        (``frontend='scnn180'``, the ``audio_scnn`` preset)."""
        key = "audio" if frontend == "fbank" else "audio_scnn"
        t0 = time.perf_counter()
        data = self._take_or_load(subject, key,
                                  lambda: self._load_split_audio(subject, key, frontend))
        load_s = time.perf_counter() - t0
        init = _pretrained_params(self.presets[key].finetune.model, NUM_CLASSES, self._pretrained)
        result, fit_s, archive_s = self._run(subject, key, data, init)
        return self._finish(subject, key, result, data[3],
                            fit_seconds=fit_s, n_train=len(data[0]),
                            load_seconds=load_s, archive_seconds=archive_s)

    def _load_split_vision(self, subject: int, preset_key: str):
        """(tr_f, tr_fy, te_f, te_fy, frames per trial): the split by trials,
        flattened to frames. uint8 frames go to the device once; a model
        without ``preprocess_uint8`` (ResNetAttn) gets them resized to its
        ``image_size`` and normalized as float32 by ``preprocess_frames``."""
        from eav_tpu_torch.ingest.vision import flatten_trials_to_frames, preprocess_frames

        preset = self.presets[preset_key]
        x, y = self.load_vision(subject, preset_key)  # (trials, frames, H, W, 3) uint8
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

    def run_vision(self, subject: int, preset_key: str = "vision") -> TaskResult:
        """The vision fine-tune of one subject, scored by the per-trial vote
        over its frames: ViT (the ``vision`` preset, the default) or
        ResNetAttn (``vision_resnet``); data-parallel over the pipelines'
        ``mesh`` when they have one."""
        key = preset_key
        t0 = time.perf_counter()
        tr_f, tr_fy, te_f, te_fy, fps = self._take_or_load(
            subject, key, lambda: self._load_split_vision(subject, key))
        load_s = time.perf_counter() - t0
        init = _pretrained_params(self.presets[key].finetune.model, NUM_CLASSES, self._pretrained)
        trainer = self._trainer(key, self.presets[key])
        t0 = time.perf_counter()
        result = trainer.fit((tr_f, tr_fy, te_f, te_fy), seed=self.seed + subject,
                             init_params=init, mesh=self.mesh)
        fit_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        if self._archives():
            tr_logits = trainer.predict(tr_f)
            self._save_logits(subject, key, "train", M.trial_vote(tr_logits, fps)[0].numpy())
        archive_s = time.perf_counter() - t0
        return self._finish(subject, key, result, te_fy, vote_group=fps,
                            fit_seconds=fit_s, n_train=len(tr_f),
                            load_seconds=load_s, archive_seconds=archive_s)

    # the split loader of each modality, and its arguments after the subject
    _PREFETCH_LOADERS = {
        "eeg": ("_load_split_eeg", ("eeg",)),
        "eeg_conformer": ("_load_split_eeg", ("eeg_conformer",)),
        "audio": ("_load_split_audio", ("audio", "fbank")),
        "audio_scnn": ("_load_split_audio", ("audio_scnn", "scnn180")),
        "vision": ("_load_split_vision", ("vision",)),
        "vision_resnet": ("_load_split_vision", ("vision_resnet",)),
    }

    def prefetch(self, subject: int, modality: str) -> None:
        """Load a coming task's split onto the device and park it for its
        ``run_*`` to take. The sweep runner calls this on a thread while the
        previous task fits. Best-effort: a failure is printed, and the task
        loads inline and journals its own error."""
        spec = self._PREFETCH_LOADERS.get(modality)
        if spec is None:  # fusion: its load is a few small arrays
            return
        try:
            data = getattr(self, spec[0])(subject, *spec[1])
        except Exception as e:  # noqa: BLE001 — best-effort by design
            print(f"[prefetch] subject{subject:02d} {modality} failed ({e}); "
                  "task will load inline")
            return
        with self._prefetch_lock:
            self._prefetched[(modality, subject)] = data
            # the runner keeps at most two parked (the running task's, racing
            # its take, and the next one); anything older is a task that
            # failed before it took its split: evict the oldest
            while len(self._prefetched) > 2:
                self._prefetched.pop(next(iter(self._prefetched)))

    def _take_or_load(self, subject: int, modality: str, loader):
        with self._prefetch_lock:
            data = self._prefetched.pop((modality, subject), None)
        return loader() if data is None else data

    def _stack_splits(self, subjects: Sequence[int], modality: str):
        """The EAV splits of ``subjects`` stacked on a subject axis (vision:
        flattened to frames) -> ((tr_x, tr_y, te_x, te_y) as arrays, frames
        per trial or None)."""
        from eav_tpu_torch.ingest.vision import flatten_trials_to_frames, preprocess_frames

        preset = self.presets[modality]
        loaders = {
            "eeg": lambda s: self.load_eeg(s, "eeg"),
            "eeg_conformer": lambda s: self.load_eeg(s, "eeg_conformer"),
            "audio": lambda s: self.load_audio(s, "fbank"),
            "audio_scnn": lambda s: self.load_audio(s, "scnn180"),
            "vision": lambda s: self.load_vision(s, "vision"),
            "vision_resnet": lambda s: self.load_vision(s, "vision_resnet"),
        }
        vote_group, splits = None, []
        for s in subjects:
            x, y = loaders[modality](s)
            sp = eav_split(x, y, h_idx=preset.split.h_idx, num_classes=preset.split.num_classes)
            if modality in ("vision", "vision_resnet"):
                vote_group = int(x.shape[1])  # frames per trial
                (tr_f, tr_fy), (te_f, te_fy) = (flatten_trials_to_frames(sp[0], sp[1]),
                                                flatten_trials_to_frames(sp[2], sp[3]))
                kw = preset.finetune.model_kwargs or {}
                if not kw.get("preprocess_uint8"):
                    size = kw.get("image_size", 224)
                    tr_f = preprocess_frames(tr_f, size=size, device=self.device)
                    te_f = preprocess_frames(te_f, size=size, device=self.device)
                sp = (tr_f, tr_fy, te_f, te_fy)
            splits.append(tuple(np.asarray(a) for a in sp))
        shapes = {sp[0].shape for sp in splits}
        if len(shapes) != 1:
            raise ValueError(f"subjects have inconsistent split shapes: {shapes}")
        return tuple(np.stack([sp[i] for sp in splits]) for i in range(4)), vote_group

    def run_stacked(self, subjects: Sequence[int], modality: str = "eeg") -> Dict[int, TaskResult]:
        """The fits of ``subjects`` of one modality as one stacked program
        (``parallel/subject.py``), each at the seed its serial fit takes, with
        the serial metrics rows plus ``group_size``; ``fit_seconds`` and
        ``load_seconds`` are the group's, ``samples_per_sec`` the group's
        aggregate. Both splits' logits are archived for every subject (the
        vision ones trial-voted), so fusion can follow.

        A stacked transformer resolves ``'auto'`` attention to ``'math'``
        and recomputes its attention sublayer in the backward (remat
        ``'none'`` becomes ``'attn'``), as the JAX package's stacked
        programs do; an explicit ``'flash'`` stays, and K1-K3 serve the
        whole stack in one launch a layer (their vmap rule,
        ``ops/attention.py``). A pretrained checkpoint
        (``_pretrained_params``) is the init of every subject, as in the
        serial fits."""
        from eav_tpu_torch.parallel.subject import SubjectParallelTrainer

        if modality not in ("eeg", "eeg_conformer", "audio", "audio_scnn", "vision",
                            "vision_resnet"):
            raise KeyError(f"run_stacked does not support modality {modality!r}")
        preset = self.presets[modality]
        t0 = time.perf_counter()
        stack, vote_group = self._stack_splits(subjects, modality)
        load_s = time.perf_counter() - t0
        overrides = {}
        if preset.finetune.model in ("ast", "vit"):
            kw = preset.finetune.model_kwargs or {}
            if kw.get("attn_impl", "math") == "auto":
                overrides["attn_impl"] = "math"
            if kw.get("remat", "none") == "none":
                overrides["remat"] = "attn"
        model = build_model(preset, **overrides)
        trainer = SubjectParallelTrainer(model, preset.finetune,
                                         getattr(model, "HEAD_REGEX", HEAD_REGEX),
                                         device=self.device, deterministic=self.deterministic)
        init = _pretrained_params(preset.finetune.model, NUM_CLASSES, self._pretrained)
        if init is not None:
            init = {k: v.expand(len(subjects), *v.shape) for k, v in init.items()}
        t0 = time.perf_counter()
        stacked = trainer.fit_stacked(stack, seeds=[self.seed + s for s in subjects],
                                      init_params=init)
        fit_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        tr_logits = trainer.predict(stack[0], stacked.params) if self._archives() else None
        predict_s = time.perf_counter() - t0
        epochs = int(stacked.history["test_acc"].shape[1])
        n_train = int(stack[0].shape[1])
        out: Dict[int, TaskResult] = {}
        for i, s in enumerate(subjects):
            t0 = time.perf_counter()
            summary = self._score(s, modality, stacked.outputs_test[i], stack[3][i], vote_group)
            if tr_logits is not None:
                tl = tr_logits[i]
                self._save_logits(s, modality, "train",
                                  M.trial_vote(tl, vote_group)[0].numpy() if vote_group else tl)
            out[s] = TaskResult(
                metrics={
                    "accuracy": summary["accuracy"],
                    "weighted_f1": summary["weighted_f1"],
                    "confusion": summary["confusion"],
                    "final_train_acc": float(stacked.history["train_acc"][i, -1]),
                    "epochs": epochs,
                    "fit_seconds": round(fit_s, 3),
                    "group_size": len(subjects),
                    "samples_per_sec": round(len(subjects) * epochs * n_train / fit_s, 2),
                    "load_seconds": round(load_s, 3),
                    # the group's train-split predict, shared, plus this subject's saves
                    "archive_seconds": round(predict_s + time.perf_counter() - t0, 3),
                },
                artifacts={"params": {k: v[i] for k, v in stacked.params.items()},
                           "history": {k: v[i] for k, v in stacked.history.items()}},
            )
        return out

    def run_eeg_stacked(self, subjects: Sequence[int]) -> Dict[int, TaskResult]:
        return self.run_stacked(subjects, "eeg")

    def run_fusion(self, subject: int, strict: bool = True,
                   mods: Tuple[str, ...] = ("eeg", "audio", "vision")) -> TaskResult:
        """Late fusion over the archived per-trial logits of ``mods``
        (BASELINE.json config 5). ``strict`` requires equal, class-divisible
        row counts across modalities: truncating would misalign the
        per-class blocks the labels are rebuilt from. With ``strict=False``
        the labels cover the common prefix."""
        if self.logits_dir is None:
            raise ValueError("run_fusion requires logits_dir (archived per-trial logits)")

        def load(split):
            parts = [np.load(os.path.join(self.logits_dir, f"s{subject:02d}_{m}_{split}.npy"))
                     for m in mods]
            lens = {m: len(p) for m, p in zip(mods, parts)}
            n = min(lens.values())
            if strict and (len(set(lens.values())) != 1 or n % NUM_CLASSES != 0):
                raise ValueError(
                    f"modality logit counts misaligned for subject {subject}: {lens} "
                    "(per-class blocks would not line up; re-archive logits)")
            n -= n % NUM_CLASSES
            return np.stack([p[:n] for p in parts], axis=1).astype(np.float32)

        tr, te = load("train"), load("test")
        # labels follow eav_split's layout: per-class blocks in class order
        tr_y = np.repeat(np.arange(NUM_CLASSES), tr.shape[0] // NUM_CLASSES)
        te_y = np.repeat(np.arange(NUM_CLASSES), te.shape[0] // NUM_CLASSES)
        result = self._fusion_trainer(tr.shape[1]).fit((tr, tr_y, te, te_y),
                                                      seed=self.seed + subject)
        summary = M.classification_summary(te_y, np.argmax(result.outputs_test, -1), NUM_CLASSES)
        return TaskResult(metrics={"accuracy": summary["accuracy"],
                                   "weighted_f1": summary["weighted_f1"]},
                          artifacts={"params": result.params})

    def _fusion_trainer(self, n_mods: int) -> Trainer:
        """The fusion head's trainer for ``n_mods`` modalities, one per count."""
        key = f"fusion#{n_mods}"
        t = self._trainers.get(key)
        if t is None:
            preset = self.presets["fusion"]
            t = Trainer(build_model(preset, num_modalities=n_mods), preset.finetune,
                        device=self.device, deterministic=self.deterministic)
            self._trainers[key] = t
        return t

    def task_fn(self, subject: int, modality: str) -> TaskResult:
        """One sweep task: the serial fit of ``modality`` for ``subject``."""
        if modality in ("eeg", "eeg_conformer"):
            return self.run_eeg(subject, modality)
        if modality == "audio":
            return self.run_audio(subject, "fbank")
        if modality == "audio_scnn":
            return self.run_audio(subject, "scnn180")
        if modality in ("vision", "vision_resnet"):
            return self.run_vision(subject, modality)
        if modality == "fusion":
            return self.run_fusion(subject)
        raise KeyError(f"unknown modality {modality!r}")
