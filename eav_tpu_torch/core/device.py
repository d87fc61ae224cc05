"""Device selection for the port's entry points.

Entry points take ``device="cuda"`` by default and run on the CPU only when
the caller passes ``device="cpu"``. A CUDA request on a host without a GPU
raises: nothing falls back to the CPU on its own.

:func:`deterministic_algorithms` is the trainers' deterministic mode.
"""

from __future__ import annotations

import contextlib
import threading
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


# ``torch.use_deterministic_algorithms`` is one flag for the whole process,
# while the farm's workers fit on threads of their own: the flag is set by
# the first holder to enter and restored by the last to leave.
_mode_lock = threading.Lock()
_mode_holders = 0
_mode_before = (False, False)


@contextlib.contextmanager
def deterministic_algorithms(on: bool = True) -> Iterator[None]:
    """With ``on``, the block runs under ``torch.use_deterministic_algorithms
    (True)``. Blocks may nest and overlap across threads: the first to enter
    sets the mode, and the process's earlier setting comes back only when
    the last one leaves, so one thread's fit never turns the mode off under
    another's. An op without a deterministic CUDA kernel then raises (no
    ``warn_only``). cuBLAS is deterministic only with
    ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` (or ``:16:8``) in the environment
    before the process's first cuBLAS call; without it, torch raises at the
    first product on the card."""
    global _mode_holders, _mode_before
    if not on:
        yield
        return
    with _mode_lock:
        if _mode_holders == 0:
            _mode_before = (torch.are_deterministic_algorithms_enabled(),
                            torch.is_deterministic_algorithms_warn_only_enabled())
            torch.use_deterministic_algorithms(True)
        _mode_holders += 1
    try:
        yield
    finally:
        with _mode_lock:
            _mode_holders -= 1
            if _mode_holders == 0:
                torch.use_deterministic_algorithms(_mode_before[0], warn_only=_mode_before[1])
