"""Dataclass configs and the ``ast_finetune`` and ``vit_finetune`` presets.

A copy of the parts of ``eav_tpu/core/config.py`` that the audio and vision
fine-tunes need: the same field names and defaults, without the fields of
model families the port does not run yet. ``VisionPreprocConfig`` is copied
whole, so its hash (the vision cache key) equals the JAX package's.
``model_kwargs`` maps the presets' dtype names to torch dtypes.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import torch

# Canonical EAV label map (reference `Dataload_audio.py:58-64`).
EMOTION_TO_INDEX: Dict[str, int] = {
    "Neutral": 0,
    "Sadness": 1,
    "Anger": 2,
    "Happiness": 3,
    "Calmness": 4,
}
NUM_CLASSES = 5


@dataclass(frozen=True)
class SplitConfig:
    """Class-stratified in-temporal-order split: per class the first
    ``h_idx`` samples train, the rest test (reference `EAV_datasplit.py:26-40`)."""

    h_idx: int = 56
    num_classes: int = NUM_CLASSES


@dataclass(frozen=True)
class AudioPreprocConfig:
    """Audio ingest: .wav -> 5 s / 16 kHz segments -> AST fbank (128 mel
    bins x 1024 frames, normalized by the AudioSet corpus statistics)."""

    target_sr: int = 16000
    segment_seconds: float = 5.0
    num_mel_bins: int = 128
    max_frames: int = 1024
    norm_mean: float = -4.2677393
    norm_std: float = 4.5689974


@dataclass(frozen=True)
class VisionPreprocConfig:
    """Vision ingest: .mp4 -> (400, 25, H, W, 3) uint8 frame stacks.

    Mirrors reference `Dataload_vision.py:42-94`: Speaking clips only, every
    6th frame of the first 600 (100 frames / 20 s clip), grouped 25 frames =
    5 s per sample; face crop to 56x56 (``face_detection``), else resize to
    ``image_size``. The MTCNN fields serve the face detector (ROADMAP slice 6).
    """

    frame_stride: int = 6
    max_frames: int = 600
    frames_per_sample: int = 25
    image_size: int = 224
    face_detection: bool = False
    face_image_size: int = 56
    face_prob_threshold: float = 0.3
    mtcnn_thresholds: Tuple[float, float, float] = (0.6, 0.7, 0.7)
    mtcnn_factor: float = 0.709
    mtcnn_min_face_size: int = 20


@dataclass(frozen=True)
class PhaseConfig:
    """One phase of the freeze->unfreeze protocol (`Dataload_audio.py:113-114`)."""

    epochs: int
    lr: float
    freeze: bool


@dataclass(frozen=True)
class FinetuneConfig:
    """Trainer hyper-parameters (AdamW; the optimizer of the AST preset).

    ``shuffle=False`` batches in order every epoch (the trajectory parity
    tests use it); ``cache_frozen_features`` runs a frozen phase on cached
    backbone features when that is the same math (train/loop.py)."""

    model: str
    batch_size: int
    phases: Tuple[PhaseConfig, ...]
    weight_decay: float = 1e-5
    eval_batch_size: Optional[int] = None
    # Per-trial aggregation for per-frame models (`Transformer_Vision.py:170-188`):
    # vote over this many consecutive test rows. None = per-sample scoring.
    vote_group: Optional[int] = None
    # 'mean' = mean-logit vote (`Transformer_Vision.py:178-180`);
    # 'majority' = per-frame argmax + mode (the Keras video notebook).
    vote_mode: str = "mean"
    seed: int = 0
    shuffle: bool = True
    cache_frozen_features: bool = True
    model_kwargs: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        if self.eval_batch_size is None:
            object.__setattr__(self, "eval_batch_size", self.batch_size)


@dataclass(frozen=True)
class PresetConfig:
    name: str
    description: str
    split: SplitConfig
    finetune: FinetuneConfig
    audio: Optional[AudioPreprocConfig] = None
    vision: Optional[VisionPreprocConfig] = None

    def replace(self, **kw) -> "PresetConfig":
        return dataclasses.replace(self, **kw)


def _ast_finetune() -> FinetuneConfig:
    # Reference `Dataload_audio.py:110-114`: AdamW, bs 8, 10 epochs at 5e-4
    # frozen, then 15 at 5e-6 unfrozen, one optimizer across phases; torch's
    # default weight decay 0.01 (`Transformer_Audio.py:30`). bf16 compute and
    # residual stream, flash attention on the GPU ('auto').
    return FinetuneConfig(
        model="ast",
        batch_size=8,
        weight_decay=0.01,
        phases=(
            PhaseConfig(epochs=10, lr=5e-4, freeze=True),
            PhaseConfig(epochs=15, lr=5e-6, freeze=False),
        ),
        eval_batch_size=64,
        model_kwargs={
            "compute_dtype": "bfloat16",
            "attn_impl": "auto",
            "stream_dtype": "bfloat16",
        },
    )


def _vit_finetune() -> FinetuneConfig:
    # Reference `Dataload_vision.py:140-141`: bs 128, 10 epochs at 5e-4 frozen,
    # then 5 at 5e-6 unfrozen; trial vote = mean logits over 25 frames
    # (`Transformer_Vision.py:178-180`); torch's default weight decay 0.01
    # (`Transformer_Vision.py:36`). Eval at twice the train batch. Raw uint8
    # frames go to the device and the model resizes and normalizes them; bf16
    # compute and residual stream; attention stays plain ('math'), as the JAX
    # preset keeps XLA attention at 197 tokens.
    return FinetuneConfig(
        model="vit",
        batch_size=128,
        weight_decay=0.01,
        phases=(
            PhaseConfig(epochs=10, lr=5e-4, freeze=True),
            PhaseConfig(epochs=5, lr=5e-6, freeze=False),
        ),
        eval_batch_size=256,
        vote_group=25,
        model_kwargs={"preprocess_uint8": True, "compute_dtype": "bfloat16",
                      "stream_dtype": "bfloat16"},
    )


PRESETS: Dict[str, PresetConfig] = {
    "ast_finetune": PresetConfig(
        name="ast_finetune",
        description="AST-audioset fine-tune per subject (freeze 10ep -> unfreeze 15ep, bs=8)",
        split=SplitConfig(),
        audio=AudioPreprocConfig(),
        finetune=_ast_finetune(),
    ),
    "vit_finetune": PresetConfig(
        name="vit_finetune",
        description="Vision ViT fine-tune on face frames, per-trial mean-logit vote",
        split=SplitConfig(),
        vision=VisionPreprocConfig(face_detection=True),
        finetune=_vit_finetune(),
    ),
}


def get_preset(name: str) -> PresetConfig:
    try:
        return PRESETS[name]
    except KeyError:
        raise KeyError(f"unknown preset {name!r}; available: {sorted(PRESETS)}") from None


def torch_dtype(name) -> Optional[torch.dtype]:
    """'bfloat16' -> torch.bfloat16; None and torch dtypes pass through."""
    if name is None or isinstance(name, torch.dtype):
        return name
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"not a torch dtype name: {name!r}")
    return dtype


def model_kwargs(preset: PresetConfig) -> dict:
    """The preset's model kwargs with dtype names mapped to torch dtypes
    (``eav_tpu/train/pipeline.py:84-93`` does the same for jnp)."""
    kw = dict(preset.finetune.model_kwargs or {})
    for key in ("compute_dtype", "stream_dtype"):
        if key in kw:
            kw[key] = torch_dtype(kw[key])
    return kw
