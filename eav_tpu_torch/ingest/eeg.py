"""EEG ingest: .mat -> (400, 30, 500) float trials + (400,) int labels.

The reference ``DataLoadEEG`` (`Dataload_eeg.py:35-160`) as
``eav_tpu/ingest/eeg.py`` implements it, with the DSP on the loader's device:

  load .mat (10000, 30, 200) --transpose--> (30, 10000, 200)
    -> flatten trials per channel (MATLAB F-order semantics)
    -> polyphase resample 500 -> 100 Hz         (one strided conv1d)
    -> order-5 Butterworth [0.5, 45] bandpass   (blocked linear recurrences)
    -> split 20 s trials into 4 x 5 s chunks (F-order semantics)
    -> keep listening classes, labels -> 0..4

The F-order reshapes (SURVEY.md §7.3's parity hazard) are explicit C-order
permutes. Labels are remapped to their position in ``selected_classes``, as
the reference's Keras path and its published pickles have them (its torch
path leaves the raw one-hot rows {1,3,5,7,9}, `Dataload_eeg.py:152`).
The .mat files are read by the native library (``ingest/native.py``; the
pure-Python ``mat5`` reader on a host without a C++ compiler), which
tries ``seg1`` before ``seg``, as the JAX package does.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from eav_tpu_torch.core.config import EEGPreprocConfig
from eav_tpu_torch.core.device import resolve_device
from eav_tpu_torch.ingest import mat5, native
from eav_tpu_torch.ops.signal import bandpass_sos, resample_poly


def flatten_trials(x: torch.Tensor) -> torch.Tensor:
    """(ch, t, tri) -> (ch, t*tri) with MATLAB F-order semantics: per channel,
    trials concatenated along time (out[c, t + T*r] = x[c, t, r]).
    Reference `Dataload_eeg.py:94`."""
    ch, t, tri = x.shape
    return x.permute(0, 2, 1).reshape(ch, tri * t)


def unflatten_trials(x: torch.Tensor, t: int) -> torch.Tensor:
    """(ch, t*tri) -> (ch, t, tri); inverse of :func:`flatten_trials`."""
    ch, n = x.shape
    return x.reshape(ch, n // t, t).permute(0, 2, 1)


def chunk_trials(x: torch.Tensor, chunk_len: int) -> torch.Tensor:
    """(ch, t, tri) -> (ch, chunk_len, n_chunks*tri) with F-order semantics:
    out[c, u, k + n_chunks*r] = x[c, u + chunk_len*k, r]
    (reference `Dataload_eeg.py:133-136`, 20 s -> 4 x 5 s)."""
    ch, t, tri = x.shape
    k = t // chunk_len
    return x.reshape(ch, k, chunk_len, tri).permute(0, 2, 3, 1).reshape(ch, chunk_len, tri * k)


def preprocess_eeg(seg: torch.Tensor, cfg: EEGPreprocConfig = EEGPreprocConfig()) -> torch.Tensor:
    """Downsample + bandpass + chunk on ``seg``'s device. ``seg``: (ch,
    t_orig, trials) continuous 500 Hz data. Returns (ch, samples_per_chunk,
    trials*chunks).

    ``cfg.filter_before_downsample`` selects the Keras-notebook order
    (bandpass at fs_orig, then resample) instead of the torch pipeline's
    (resample, then bandpass at fs_target)."""
    ch, t, tri = seg.shape
    down = cfg.fs_orig // cfg.fs_target
    lo, hi = cfg.band
    flat = flatten_trials(seg)
    if cfg.filter_before_downsample:
        flat = bandpass_sos(flat, lo, hi, float(cfg.fs_orig), cfg.butter_order)
        flat = resample_poly(flat, 1, down)
    else:
        flat = resample_poly(flat, 1, down)
        # the reference re-flattens for the bandpass (`Dataload_eeg.py:110`);
        # flatten/unflatten round-trip exactly, so filter the flat stream
        flat = bandpass_sos(flat, lo, hi, float(cfg.fs_target), cfg.butter_order)
    return chunk_trials(unflatten_trials(flat, t // down), cfg.samples_per_chunk)


def select_classes(data: np.ndarray, onehot: np.ndarray,
                   selected: Tuple[int, ...]) -> Tuple[np.ndarray, np.ndarray]:
    """Keep columns whose one-hot argmax row is in ``selected``; remap labels
    to positions 0..len(selected)-1. ``data``: (ch, t, cols); ``onehot``:
    (rows, cols) already repeated to match cols.
    Returns (trials, ch, t) and (trials,) int labels."""
    row = np.argmax(np.asarray(onehot), axis=0)
    mask = np.isin(row, selected)
    remap = {c: i for i, c in enumerate(selected)}
    labels = np.array([remap[r] for r in row[mask]], dtype=np.int32)
    return np.transpose(np.asarray(data)[:, :, mask], (2, 0, 1)), labels


def _native_signal(path: str) -> np.ndarray:
    """The ``seg1`` variable of a subject's .mat, else its ``seg`` (some
    subjects use 'seg1', `Dataload_eeg.py:71-74`). Any error but a missing
    variable raises at once."""
    for name in ("seg1", "seg"):
        try:
            return native.read_mat_var(path, name)
        except IOError as e:
            if "variable not found" not in str(e):
                raise
    raise KeyError(f"{path}: no 'seg'/'seg1' variable")


class DataLoadEEG:
    """Per-subject EEG loader with the reference's interface
    (`Dataload_eeg.py:154-160`): ``prepare_data() -> (x, y)`` as numpy, the
    DSP on ``device`` (``"cuda"`` unless the caller passes another) in
    ``dtype``."""

    def __init__(
        self,
        subject: int = 1,
        config: EEGPreprocConfig = EEGPreprocConfig(),
        parent_directory: str = "./Datasets/EAV",
        dtype: torch.dtype = torch.float32,
        device="cuda",
    ):
        self.subject = subject
        self.cfg = config
        self.parent_directory = parent_directory
        self.dtype = dtype
        self.device = resolve_device(device)

    def _paths(self) -> Tuple[str, str]:
        s = f"subject{self.subject:02d}"
        folder = os.path.join(self.parent_directory, s, "EEG")
        return os.path.join(folder, f"{s}_eeg.mat"), os.path.join(folder, f"{s}_eeg_label.mat")

    def load_mat(self) -> Tuple[np.ndarray, np.ndarray]:
        """(seg (ch, t, tri), one-hot label (rows, tri)) from the subject's
        two .mat files."""
        eeg_path, label_path = self._paths()
        if native.available():
            cnt = _native_signal(eeg_path)
            label = native.read_mat_var(label_path, "label")
        else:
            mat = mat5.loadmat(eeg_path)
            cnt = mat.get("seg1", mat.get("seg"))
            if cnt is None:
                raise KeyError(f"{eeg_path}: no 'seg'/'seg1' variable")
            label = mat5.loadmat(label_path)["label"]
        # (t, ch, tri) -> (ch, t, tri)  (`Dataload_eeg.py:82`)
        return np.transpose(cnt, (1, 0, 2)), label

    def prepare_data(self) -> Tuple[np.ndarray, np.ndarray]:
        seg, label = self.load_mat()
        return self.prepare_from_arrays(seg, label)

    def prepare_from_arrays(self, seg: np.ndarray, label: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(ch, t, tri) raw 500 Hz + (rows, tri) one-hot -> (trials, ch, t')
        + labels."""
        cfg = self.cfg
        x = torch.as_tensor(np.ascontiguousarray(seg)).to(self.device, self.dtype)
        processed = preprocess_eeg(x, cfg).cpu().numpy()
        onehot_rep = np.repeat(np.asarray(label), cfg.chunks_per_trial, axis=1)
        return select_classes(processed, onehot_rep, cfg.selected_classes)
