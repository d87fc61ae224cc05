"""Device selection for the port's entry points.

Entry points take ``device="cuda"`` by default and run on the CPU only when
the caller passes ``device="cpu"``. A CUDA request on a host without a GPU
raises: nothing falls back to the CPU on its own.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested (the default) but no CUDA GPU is "
            "available; pass device='cpu' to run on the CPU"
        )
    return dev
