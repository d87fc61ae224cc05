"""Dataclass configs and the presets of the JAX package: ``eegnet_subject``,
``scnn_audio``, ``ast_finetune``, ``vit_finetune``, ``fusion_sweep``,
``conformer_eeg`` and ``resnet_vision``; and the port's own
``lfm2_moe_finetune`` (after them in ``PRESETS``).

A copy of ``eav_tpu/core/config.py``'s dataclasses and presets, with the same
field names and defaults. ``EEGPreprocConfig``, ``AudioPreprocConfig`` and
``VisionPreprocConfig`` are copied whole, so their hashes (the cache keys)
equal the JAX package's. ``model_kwargs`` maps the presets' dtype names to
torch dtypes. ``apply_overrides`` and ``load_override_file`` are the CLI's
``--set`` / ``--config`` field overrides, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple

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
NUM_SUBJECTS = 42

# One-hot rows of the label .mat that correspond to the *listening* tasks kept
# by the EEG pipeline (reference `Dataload_eeg.py:33`).
EEG_SELECTED_CLASSES: Tuple[int, ...] = (1, 3, 5, 7, 9)


@dataclass(frozen=True)
class SplitConfig:
    """Class-stratified in-temporal-order split: per class the first
    ``h_idx`` samples train, the rest test (reference `EAV_datasplit.py:26-40`)."""

    h_idx: int = 56
    num_classes: int = NUM_CLASSES


@dataclass(frozen=True)
class EEGPreprocConfig:
    """EEG ingest: .mat -> (400, 30, 500) trials.

    Mirrors reference `Dataload_eeg.py:85-152`: polyphase downsample
    500->100 Hz on the F-order-flattened continuous signal, order-5 Butterworth
    SOS bandpass per channel, 20 s trials split into 4 x 5 s chunks (F-order),
    keep listening classes only.
    """

    fs_orig: int = 500
    fs_target: int = 100
    band: Tuple[float, float] = (0.5, 45.0)
    butter_order: int = 5
    channels: int = 30
    trial_seconds: float = 20.0
    chunk_seconds: float = 5.0
    selected_classes: Tuple[int, ...] = EEG_SELECTED_CLASSES
    # The Keras notebook pipeline filters at the ORIGINAL rate before
    # downsampling (`CNN_EEG_tf.py` commented block / `EEG_nb.ipynb` cell4,
    # band [3, 50]), the torch pipeline downsamples first
    # (`Dataload_eeg.py:156-158`) — SURVEY.md C8 order discrepancy.
    filter_before_downsample: bool = False

    @property
    def chunks_per_trial(self) -> int:
        return int(round(self.trial_seconds / self.chunk_seconds))

    @property
    def samples_per_chunk(self) -> int:
        return int(round(self.chunk_seconds * self.fs_target))


@dataclass(frozen=True)
class AudioPreprocConfig:
    """Audio ingest: .wav -> 5 s / 16 kHz segments, then one of two frontends.

    - ``frontend='fbank'``: AST 128-bin x 1024-frame Kaldi-style log-mel fbank
      normalized by the AudioSet corpus stats (reference
      `Pre_trained_models/ast-finetuned-audioset/preprocessor_config.json`).
    - ``frontend='scnn180'``: the notebook's 180-d vector (40 MFCC + 12 chroma
      + 128 mel means over a 5 s segment at 22.05 kHz; reference
      `CNN_tensorflow/CNN_audio_emotion_recognition.ipynb` extract_feature).
    """

    target_sr: int = 16000
    segment_seconds: float = 5.0
    frontend: str = "fbank"
    # AST fbank (Kaldi-compatible)
    num_mel_bins: int = 128
    max_frames: int = 1024
    frame_length_ms: float = 25.0
    frame_shift_ms: float = 10.0
    norm_mean: float = -4.2677393
    norm_std: float = 4.5689974
    # SCNN 180-d frontend (librosa conventions)
    scnn_sr: int = 22050
    n_mfcc: int = 40
    n_chroma: int = 12
    n_mels: int = 128
    n_fft: int = 2048
    hop_length: int = 512

    @property
    def segment_samples(self) -> int:
        return int(round(self.segment_seconds * self.target_sr))


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
    """Trainer hyper-parameters.

    ``optimizer`` 'adamw' decays weights by ``weight_decay``, 'adam' does not
    (core/optim.py). ``compat_softmax`` takes the cross-entropy of
    softmax(logits), the reference's double softmax (`EEGNet_tor.py:44,66`
    + `:81`). ``compat_sticky_eval`` trains a phase's first epoch in train
    mode and every later one in eval mode (dropout off, BatchNorm reading and
    not updating its running stats), as the reference's ``Trainer_uni``
    leaves the module after its first ``validate()`` (`EEGNet_tor.py:96-135`).
    ``shuffle=False`` batches in order every epoch (the trajectory parity
    tests use it); ``cache_frozen_features`` runs a frozen phase on cached
    backbone features when that is the same math (train/loop.py).
    ``compat_batch_mean_acc`` logs the mean of per-batch accuracies, the
    reference vision trainers' metric (`Transformer_Vision.py:106-124`,
    `CNN_Vision.py:128-157`), where a partial last batch weighs as a whole
    one; ``l1_reg`` / ``l2_reg`` add the Keras SCNN's l1_l2 penalties on
    every kernel (train/loop.py ``kernel_penalty``). No preset sets these
    three."""

    model: str
    batch_size: int
    phases: Tuple[PhaseConfig, ...]
    optimizer: str = "adamw"  # 'adamw' | 'adam'
    weight_decay: float = 1e-5
    eval_batch_size: Optional[int] = None
    # Per-trial aggregation for per-frame models (`Transformer_Vision.py:170-188`):
    # vote over this many consecutive test rows. None = per-sample scoring.
    vote_group: Optional[int] = None
    # 'mean' = mean-logit vote (`Transformer_Vision.py:178-180`);
    # 'majority' = per-frame argmax + mode (the Keras video notebook).
    vote_mode: str = "mean"
    seed: int = 0
    compat_softmax: bool = False
    compat_sticky_eval: bool = False
    shuffle: bool = True
    # keep every epoch's test logits (the reference's ActivationSaver,
    # `CNN_audio.py:48-72`): ``TrainResult.epoch_logits``
    keep_epoch_logits: bool = False
    compat_batch_mean_acc: bool = False
    l1_reg: float = 0.0
    l2_reg: float = 0.0
    cache_frozen_features: bool = True
    model_kwargs: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        if self.eval_batch_size is None:
            object.__setattr__(self, "eval_batch_size", self.batch_size)


@dataclass(frozen=True)
class SweepConfig:
    """The 42-subject x modality sweep (``core/sweep.SweepRunner``)."""

    subjects: Tuple[int, ...] = tuple(range(1, NUM_SUBJECTS + 1))
    modalities: Tuple[str, ...] = ("eeg", "audio", "vision")
    data_root: str = "./Datasets/EAV"
    cache_dir: str = "./cache"
    journal_path: str = "./sweep_journal.jsonl"
    metrics_path: str = "./metrics.jsonl"
    checkpoint_dir: Optional[str] = None
    resume: bool = True
    max_retries: int = 1


@dataclass(frozen=True)
class PresetConfig:
    name: str
    description: str
    split: SplitConfig
    finetune: FinetuneConfig
    eeg: Optional[EEGPreprocConfig] = None
    audio: Optional[AudioPreprocConfig] = None
    vision: Optional[VisionPreprocConfig] = None
    sweep: Optional[SweepConfig] = None

    def replace(self, **kw) -> "PresetConfig":
        return dataclasses.replace(self, **kw)


def _scnn_finetune() -> FinetuneConfig:
    # Reference `CNN_torch/CNN_audio.py:89` (Adam 1e-3) / notebook (100 ep, bs 64).
    return FinetuneConfig(
        model="scnn_audio",
        batch_size=64,
        optimizer="adam",
        weight_decay=0.0,
        phases=(PhaseConfig(epochs=100, lr=1e-3, freeze=False),),
    )


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


def _lfm2_moe_finetune() -> FinetuneConfig:
    # LFM2-MoE as EAV's classifier over token rows: AdamW with decay 0.01,
    # batch 4 and evaluation batch 8 (a row is 8,192 tokens), an unfrozen
    # fine-tune at 1e-5 after a frozen head phase as AST's; bf16 compute and
    # residual stream, causal attention through the flash kernels.
    return FinetuneConfig(
        model="lfm2_moe",
        batch_size=4,
        weight_decay=0.01,
        phases=(
            PhaseConfig(epochs=2, lr=5e-4, freeze=True),
            PhaseConfig(epochs=3, lr=1e-5, freeze=False),
        ),
        eval_batch_size=8,
        model_kwargs={"compute_dtype": "bfloat16", "stream_dtype": "bfloat16"},
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


def _eegnet_finetune() -> FinetuneConfig:
    # Reference `Dataload_eeg.py:250-256`: Adam lr=1e-5, bs=32, 200 epochs,
    # no freeze protocol (trained from scratch); the double softmax and
    # Trainer_uni's sticky eval mode of the published trajectory. The
    # temporal conv is the direct convolution: chip_smoke.py times and
    # profiles the step in both temporal modes on the card; the FFT takes
    # less device time, but the step is host-bound and its wall time the
    # same in both (PERF.md sections 5-6).
    return FinetuneConfig(
        model="eegnet",
        batch_size=32,
        optimizer="adam",
        weight_decay=0.0,
        phases=(PhaseConfig(epochs=200, lr=1e-5, freeze=False),),
        compat_softmax=True,
        compat_sticky_eval=True,
        model_kwargs={"temporal_mode": "conv"},
    )


def _conformer_finetune() -> FinetuneConfig:
    # Reference `Transformer_EEG.py:239-247`: Adam 1e-3, bs 32, 485 epochs,
    # post-step fc renorm maxnorm=0.5 (the model's maxnorm_rules).
    return FinetuneConfig(
        model="conformer_eeg",
        batch_size=32,
        optimizer="adam",
        weight_decay=0.0,
        phases=(PhaseConfig(epochs=485, lr=1e-3, freeze=False),),
        compat_softmax=True,
    )


def _fusion_finetune() -> FinetuneConfig:
    # Late fusion of the per-subject models' archived logits
    # (models/fusion.py); the reference only names it in a dead import
    # (`CNN_torch/EEGNet_tor.py:4`).
    return FinetuneConfig(
        model="fusion",
        batch_size=32,
        optimizer="adamw",
        weight_decay=1e-4,
        phases=(PhaseConfig(epochs=100, lr=1e-3, freeze=False),),
    )


PRESETS: Dict[str, PresetConfig] = {
    # BASELINE.json config 1
    "eegnet_subject": PresetConfig(
        name="eegnet_subject",
        description="EEGNet on one subject's EEG (.mat, 200 trials x 30ch x 10k), CPU-runnable",
        split=SplitConfig(),
        eeg=EEGPreprocConfig(),
        finetune=_eegnet_finetune(),
    ),
    # BASELINE.json config 2
    "scnn_audio": PresetConfig(
        name="scnn_audio",
        description="Audio SCNN: wav -> 180-d librosa-style features -> Conv1D",
        split=SplitConfig(),
        audio=AudioPreprocConfig(frontend="scnn180"),
        finetune=_scnn_finetune(),
    ),
    # BASELINE.json config 3
    "ast_finetune": PresetConfig(
        name="ast_finetune",
        description="AST-audioset fine-tune per subject (freeze 10ep -> unfreeze 15ep, bs=8)",
        split=SplitConfig(),
        audio=AudioPreprocConfig(frontend="fbank"),
        finetune=_ast_finetune(),
    ),
    # BASELINE.json config 4
    "vit_finetune": PresetConfig(
        name="vit_finetune",
        description="Vision ViT fine-tune on face frames, per-trial mean-logit vote",
        split=SplitConfig(),
        vision=VisionPreprocConfig(face_detection=True),
        finetune=_vit_finetune(),
    ),
    # BASELINE.json config 5
    "fusion_sweep": PresetConfig(
        name="fusion_sweep",
        description="Tri-modal EEG+AST+ViT fusion, full 42-subject sweep",
        split=SplitConfig(),
        eeg=EEGPreprocConfig(),
        audio=AudioPreprocConfig(),
        vision=VisionPreprocConfig(face_detection=True),
        finetune=_fusion_finetune(),
        sweep=SweepConfig(),
    ),
    "conformer_eeg": PresetConfig(
        name="conformer_eeg",
        description="ShallowConvNet+Transformer EEG hybrid (Transformer_EEG.py)",
        split=SplitConfig(),
        eeg=EEGPreprocConfig(),
        finetune=_conformer_finetune(),
    ),
    "resnet_vision": PresetConfig(
        name="resnet_vision",
        description="ResNet50+channel-attention video baseline (CNN_Vision.py), "
        "3+3 epoch freeze protocol, mean-logit trial vote",
        split=SplitConfig(),
        vision=VisionPreprocConfig(face_detection=True),
        finetune=FinetuneConfig(
            model="resnet_attn",
            batch_size=32,
            optimizer="adamw",
            weight_decay=0.01,  # torch AdamW default (`CNN_Vision.py:86`)
            phases=(
                PhaseConfig(epochs=3, lr=5e-4, freeze=True),
                PhaseConfig(epochs=3, lr=5e-6, freeze=False),
            ),
            vote_group=25,
        ),
    ),
    "lfm2_moe_finetune": PresetConfig(
        name="lfm2_moe_finetune",
        description="LFM2-MoE (gated short conv + causal GQA + 64-expert MoE) as the "
        "classifier of token rows",
        split=SplitConfig(),
        finetune=_lfm2_moe_finetune(),
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


# -----------------------------------------------------------------------------
# Field-level overrides (the CLI's --set / --config)
# -----------------------------------------------------------------------------


def parse_override_value(s: str) -> Any:
    """Literal-eval the value when possible ('5e-4' -> 0.0005, '(3, 50)' ->
    tuple, 'true'/'True' -> bool, 'none'/'null' -> None), else keep the raw
    string."""
    import ast

    if s.lower() in ("true", "false"):
        return s.lower() == "true"
    if s.lower() in ("none", "null"):
        return None
    try:
        return ast.literal_eval(s)
    except (ValueError, SyntaxError):
        return s


def _set_path(obj: Any, parts: Sequence[str], value: Any) -> Any:
    """Immutable deep-set along a dotted path through frozen dataclasses,
    tuples/lists (integer components) and dicts."""
    if not parts:
        return value
    head, rest = parts[0], parts[1:]
    if dataclasses.is_dataclass(obj):
        names = {f.name for f in dataclasses.fields(obj)}
        if head not in names:
            raise KeyError(
                f"{type(obj).__name__} has no field {head!r}; available: {sorted(names)}")
        return dataclasses.replace(obj, **{head: _set_path(getattr(obj, head), rest, value)})
    if isinstance(obj, (tuple, list)):
        items = list(obj)
        idx = int(head)
        items[idx] = _set_path(items[idx], rest, value)
        return type(obj)(items) if isinstance(obj, tuple) else items
    if isinstance(obj, dict):
        out = dict(obj)
        out[head] = _set_path(obj.get(head), rest, value) if rest else value
        return out
    raise KeyError(f"cannot descend into {type(obj).__name__} at {head!r}")


def override_preset(preset: PresetConfig, path: str, value: Any) -> PresetConfig:
    """One override, e.g. ``override_preset(p, 'finetune.phases.0.lr', 1e-4)``."""
    return _set_path(preset, path.split("."), value)


def apply_overrides(presets: Dict[str, PresetConfig], overrides) -> Dict[str, PresetConfig]:
    """Apply ``modality.field.path=value`` overrides to a preset dict, e.g.
    ``audio.finetune.phases.0.epochs=2`` or ``eeg.split.h_idx=40``; the
    first component selects the preset key. ``overrides``: ``path=value``
    strings (``--set``) or a ``{path: value}`` mapping
    (``load_override_file``). String values are parsed as ``--set`` values
    are (YAML reads '1e-3' as a string)."""
    if isinstance(overrides, dict):
        items = list(overrides.items())
    else:
        items = []
        for ov in overrides:
            if "=" not in ov:
                raise ValueError(f"override {ov!r} is not of the form path=value")
            path, _, raw = ov.partition("=")
            items.append((path.strip(), parse_override_value(raw.strip())))
    out = dict(presets)
    for path, value in items:
        if isinstance(value, str):
            value = parse_override_value(value)
        parts = str(path).split(".")
        if parts[0] not in out:
            raise KeyError(f"unknown preset key {parts[0]!r}; available: {sorted(out)}")
        out[parts[0]] = _set_path(out[parts[0]], parts[1:], value)
    return out


def _flatten_override_tree(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    flat: Dict[str, Any] = {}
    for k, v in tree.items():
        p = f"{prefix}.{k}" if prefix else f"{k}"
        if isinstance(v, dict):
            flat.update(_flatten_override_tree(v, p))
        else:
            flat[p] = v
    return flat


def load_override_file(path: str) -> Dict[str, Any]:
    """A YAML override file (JSON where PyYAML is not installed) as flat
    ``path -> value`` pairs, e.g. ``{"audio": {"finetune": {"phases": {"0":
    {"epochs": 2}}}}}`` -> ``{"audio.finetune.phases.0.epochs": 2}``."""
    import json

    with open(path) as f:
        text = f.read()
    try:
        import yaml  # type: ignore
    except ImportError:
        tree = json.loads(text)
    else:
        tree = yaml.safe_load(text)
    if not isinstance(tree, dict):
        raise ValueError(f"override file {path} must contain a mapping")
    return _flatten_override_tree(tree)
