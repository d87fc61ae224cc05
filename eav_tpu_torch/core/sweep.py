"""The result record of one (subject, modality) task, as in
``eav_tpu/core/sweep.py``. The journaled sweep runner is not ported yet."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional


@dataclass
class TaskResult:
    metrics: Dict[str, Any]
    artifacts: Optional[Dict[str, Any]] = None  # e.g. params to checkpoint
