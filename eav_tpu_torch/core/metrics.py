"""Classification metrics (sklearn conventions), on tensors or arrays.

Ports ``eav_tpu/core/metrics.py``: confusion matrix, accuracy, weighted F1
(sklearn ``f1_score(average='weighted')`` with zero_division=0), the summary
row the pipelines write, and the per-trial votes of the per-frame models.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _flat(y) -> torch.Tensor:
    return torch.as_tensor(y).reshape(-1).long()


def confusion_matrix(y_true, y_pred, num_classes: int) -> torch.Tensor:
    """(num_classes, num_classes) counts, rows = true, cols = pred."""
    idx = _flat(y_true) * num_classes + _flat(y_pred)
    counts = torch.bincount(idx, minlength=num_classes * num_classes)
    return counts.reshape(num_classes, num_classes)


def accuracy(y_true, y_pred) -> torch.Tensor:
    return (_flat(y_true) == _flat(y_pred)).float().mean()


def f1_scores_from_confusion(cm) -> torch.Tensor:
    """Per-class F1; zero where undefined."""
    cm = torch.as_tensor(cm).float()
    tp = torch.diag(cm)
    fp = cm.sum(dim=0) - tp
    fn = cm.sum(dim=1) - tp
    denom = 2 * tp + fp + fn
    return torch.where(denom > 0, 2 * tp / denom.clamp_min(1.0), torch.zeros_like(tp))


def weighted_f1(y_true, y_pred, num_classes: int) -> torch.Tensor:
    cm = confusion_matrix(y_true, y_pred, num_classes)
    support = cm.float().sum(dim=1)
    total = support.sum()
    if total <= 0:
        return torch.zeros(())
    return (f1_scores_from_confusion(cm) * support).sum() / total


def classification_summary(y_true, y_pred, num_classes: int) -> dict:
    """Host-side summary (Python scalars) for the metrics row."""
    return {
        "accuracy": float(accuracy(y_true, y_pred)),
        "weighted_f1": float(weighted_f1(y_true, y_pred, num_classes)),
        "confusion": confusion_matrix(y_true, y_pred, num_classes).tolist(),
    }


def _trial_blocks(logits, group: int) -> torch.Tensor:
    """(n, c) -> (n // group, group, c); a partial last trial is dropped."""
    logits = torch.as_tensor(logits)
    trials = logits.shape[0] // group
    return logits[: trials * group].reshape(trials, group, logits.shape[1])


def trial_vote(logits, group: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean logits over ``group`` consecutive rows, then argmax (reference
    `Transformer_Vision.py:178-180`) -> (trial_logits, trial_pred)."""
    tl = _trial_blocks(logits, group).mean(dim=1)
    return tl, tl.argmax(dim=-1)


def trial_majority_vote(logits, group: int, num_classes: int) -> torch.Tensor:
    """Per-trial mode of the per-frame argmax (the Keras video notebook's
    ``scipy.stats.mode``); ties go to the smallest class -> (trials,)."""
    frame_pred = _trial_blocks(logits, group).argmax(dim=-1)
    counts = torch.nn.functional.one_hot(frame_pred, num_classes).sum(dim=1)
    return counts.argmax(dim=-1)  # the first maximal count: the smallest class
