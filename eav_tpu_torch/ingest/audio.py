"""Audio ingest: .wav -> 5 s segments + labels, and the batched frontends (the
AST fbank and the SCNN's 180-d feature).

Behaviour of the reference ``DataLoadAudio`` (`Dataload_audio.py:10-78`), as
``eav_tpu/ingest/audio.py`` implements it: per subject, list the Audio dir,
parse the emotion from filename token 4, decode, resample to the target rate,
cut 5 s segments (4 per 20 s file), map labels {Neutral:0, Sadness:1, Anger:2,
Happiness:3, Calmness:4}. A subject's wavs are decoded by the native
library's threaded queue (``ingest/native.WavPrefetcher``; the pure-Python
RIFF reader on a host without a C++ compiler) and kept in dataset order;
resampling and the frontends run on the loader's device.
"""

from __future__ import annotations

import math
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from eav_tpu_torch.core.config import EMOTION_TO_INDEX, AudioPreprocConfig
from eav_tpu_torch.core.device import resolve_device
from eav_tpu_torch.ingest import native
from eav_tpu_torch.ingest.wav import read_wav
from eav_tpu_torch.ops.signal import resample_poly
from eav_tpu_torch.ops.spectral import ast_features, scnn180_features


def emotion_from_filename(name: str) -> str:
    """Token 4 of the underscore-split basename (`Dataload_audio.py:31`)."""
    return os.path.basename(name).split("_")[4].split(".")[0]


def segment_waveform(wave: np.ndarray, segment_samples: int) -> np.ndarray:
    """(T,) -> (n_segments, segment_samples), floor division
    (`Dataload_audio.py:49-55`)."""
    n = len(wave) // segment_samples
    return wave[: n * segment_samples].reshape(n, segment_samples)


class DataLoadAudio:
    """``process() -> (feature, label_indexes)`` with feature =
    (n_segments, segment_samples) raw float32 waveforms."""

    def __init__(
        self,
        subject: int = 1,
        parent_directory: str = "./Datasets/EAV",
        config: AudioPreprocConfig = AudioPreprocConfig(),
        device="cuda",
    ):
        self.subject = subject
        self.parent_directory = parent_directory
        self.cfg = config
        self.device = resolve_device(device)

    def data_files(self) -> Tuple[List[str], List[str]]:
        path = os.path.join(self.parent_directory, f"subject{self.subject:02d}", "Audio")
        files, emotions = [], []
        for name in sorted(os.listdir(path)):
            if not name.endswith(".wav"):
                continue
            files.append(os.path.join(path, name))
            emotions.append(emotion_from_filename(name))
        return files, emotions

    def _resample(self, waves: List[np.ndarray], sr: int, target_sr: int) -> List[np.ndarray]:
        g = math.gcd(target_sr, sr)
        up, down = target_sr // g, sr // g
        if len({len(w) for w in waves}) == 1:  # one batched call
            x = torch.as_tensor(np.stack(waves), device=self.device)
            return list(resample_poly(x, up, down).cpu().numpy())
        return [
            resample_poly(torch.as_tensor(w, device=self.device), up, down).cpu().numpy()
            for w in waves
        ]

    def process(self, target_sr: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Segments at ``target_sr`` (default the config's ``target_sr``;
        the SCNN frontend takes ``scnn_sr``)."""
        target_sr = target_sr or self.cfg.target_sr
        files, emotions = self.data_files()
        if files and native.available():  # the native threaded queue
            with native.WavPrefetcher(n_threads=4) as pf:
                for f in files:
                    pf.submit(f)
                decoded = {path: (wave, sr) for path, wave, sr in pf}
            pairs = [decoded[f] for f in files]  # back in dataset order
        else:
            pairs = [read_wav(f) for f in files]
        waves = [w[0] for w, _ in pairs]
        srs = [sr for _, sr in pairs]
        # resample per sample-rate group, then restore the ORIGINAL file
        # order: the split depends on the dataset's temporal order
        resampled = {}
        for sr in sorted(set(srs)):
            idxs = [i for i, r in enumerate(srs) if r == sr]
            group = [waves[i] for i in idxs]
            if sr != target_sr:
                group = self._resample(group, sr, target_sr)
            for i, w in zip(idxs, group):
                resampled[i] = w
        seg_len = int(round(self.cfg.segment_seconds * target_sr))
        segs, labels = [], []
        for i, e in enumerate(emotions):
            s = segment_waveform(np.asarray(resampled[i]), seg_len)
            segs.append(s)
            labels.extend([EMOTION_TO_INDEX[e]] * len(s))
        feature = np.concatenate(segs, axis=0).astype(np.float32)
        return feature, np.asarray(labels, np.int32)


def ast_frontend(
    segments: np.ndarray,
    cfg: AudioPreprocConfig = AudioPreprocConfig(),
    device="cuda",
) -> np.ndarray:
    """(N, 80000) raw 16 kHz -> (N, max_frames, num_mel_bins) normalized
    fbanks, 64 segments at a time on ``device`` (replaces
    `Transformer_Audio.py:38-42`)."""
    dev = resolve_device(device)
    outs = []
    for i in range(0, len(segments), 64):
        x = torch.as_tensor(np.asarray(segments[i : i + 64], np.float32), device=dev)
        outs.append(
            ast_features(
                x,
                mean=cfg.norm_mean,
                std=cfg.norm_std,
                num_mel_bins=cfg.num_mel_bins,
                max_frames=cfg.max_frames,
                sampling_rate=cfg.target_sr,
            ).cpu().numpy()
        )
    return np.concatenate(outs, axis=0)


def scnn_frontend(
    segments: np.ndarray,
    cfg: AudioPreprocConfig = AudioPreprocConfig(),
    device="cuda",
    batch: int = 64,
) -> np.ndarray:
    """(N, T) segments at ``cfg.scnn_sr`` -> (N, 180) float32 notebook
    features (`CNN_audio_emotion_recognition.ipynb` extract_feature),
    ``batch`` segments at a time on ``device``. As in the JAX package, only
    ``scnn_sr`` is read from ``cfg``: the feature's widths are the
    notebook's."""
    dev = resolve_device(device)
    outs = []
    for i in range(0, len(segments), batch):
        x = torch.as_tensor(np.asarray(segments[i : i + batch], np.float32), device=dev)
        outs.append(scnn180_features(x, sr=cfg.scnn_sr).cpu().numpy())
    return np.concatenate(outs, axis=0)
