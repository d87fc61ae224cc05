"""Classification metrics (sklearn conventions), on tensors or arrays.

Ports ``eav_tpu/core/metrics.py``: confusion matrix, accuracy, weighted F1
(sklearn ``f1_score(average='weighted')`` with zero_division=0) and the
summary row the pipelines write.
"""

from __future__ import annotations

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
