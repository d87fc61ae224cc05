"""Device selection for the port's entry points.

Entry points take ``device="cuda"`` by default and run on the CPU only when
the caller passes ``device="cpu"``. A CUDA request on a host without a GPU
raises: nothing falls back to the CPU on its own.

:func:`deterministic_algorithms` is the trainers' deterministic mode.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested (the default) but no CUDA GPU is "
            "available; pass device='cpu' to run on the CPU"
        )
    return dev


@contextlib.contextmanager
def deterministic_algorithms(on: bool = True) -> Iterator[None]:
    """With ``on``, the block runs under ``torch.use_deterministic_algorithms
    (True)``, and the process's earlier setting is restored on exit. An op
    without a deterministic CUDA kernel then raises (no ``warn_only``).
    cuBLAS is deterministic only with ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` (or
    ``:16:8``) in the environment before the process's first cuBLAS call;
    without it, torch raises at the first product on the card."""
    if not on:
        yield
        return
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])
