"""Vision preprocessing: frames -> ViT pixel values, batched on a device, as
``eav_tpu/ingest/vision.py``: the ViTImageProcessor recipe of the
`facial_emotions_image_detection` checkpoint (antialiased bilinear resize to
224, rescale 1/255, normalize mean/std 0.5) over a whole frame batch at once.
"""

from __future__ import annotations

import numpy as np
import torch

from eav_tpu_torch.core.device import resolve_device
from eav_tpu_torch.ops.image import pixel_values


def vit_pixel_values(frames, size: int = 224, device="cuda") -> torch.Tensor:
    """(N, H, W, 3) uint8/float -> (N, size, size, 3) float32 normalized, on
    ``device`` (the frames travel in their own dtype)."""
    return pixel_values(torch.as_tensor(np.asarray(frames)).to(resolve_device(device)), size)


def preprocess_frames(frames: np.ndarray, size: int = 224, batch: int = 512,
                      device="cuda") -> np.ndarray:
    """Host arrays in and out, ``batch`` frames at a time on ``device``:
    (N, H, W, 3) uint8 -> (N, size, size, 3) float32."""
    dev = resolve_device(device)
    outs = [vit_pixel_values(frames[i : i + batch], size, dev).cpu().numpy()
            for i in range(0, len(frames), batch)]
    return np.concatenate(outs, axis=0)


def flatten_trials_to_frames(x: np.ndarray, y: np.ndarray):
    """(trials, frames, H, W, 3), (trials,) -> per-frame samples with labels
    repeated (reference `Transformer_Vision.py:46-48`)."""
    t, f = x.shape[:2]
    return x.reshape((t * f,) + x.shape[2:]), np.repeat(np.asarray(y), f)
