"""Deterministic class-stratified train/test split (reference ``EAVDataSplit``,
`EAV_datasplit.py:7-58`), a copy of ``eav_tpu/ingest/split.py`` (numpy only).

Samples are grouped by class preserving dataset order (temporal order for
EAV); the first ``h_idx`` of each class train, the rest test.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def split_indices(
    y: np.ndarray, h_idx: int = 56, num_classes: int = 5
) -> Tuple[np.ndarray, np.ndarray]:
    """(train_idx, test_idx) into ``y``: each the concatenation over classes
    0..num_classes-1 of that class's in-order indices (`EAV_datasplit.py:29-32`)."""
    y = np.asarray(y).reshape(-1)
    train_parts, test_parts = [], []
    for c in range(num_classes):
        cls_idx = np.flatnonzero(y == c)
        train_parts.append(cls_idx[:h_idx])
        test_parts.append(cls_idx[h_idx:])
    return np.concatenate(train_parts), np.concatenate(test_parts)


def eav_split(
    x: np.ndarray,
    y: np.ndarray,
    h_idx: int = 56,
    num_classes: int = 5,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(x, y) -> (tr_x, tr_y, te_x, te_y); features squeezed on the way out
    as the reference does (`EAV_datasplit.py:35-36`)."""
    x = np.asarray(x)
    y = np.asarray(y).reshape(-1)
    tr_idx, te_idx = split_indices(y, h_idx=h_idx, num_classes=num_classes)
    return np.squeeze(x[tr_idx]), y[tr_idx], np.squeeze(x[te_idx]), y[te_idx]
