"""The ViT preprocessing of the JAX package: ``jax.image.resize(...,
"bilinear", antialias=True)`` to the model's size, then (x / 255 - 0.5) / 0.5.

JAX resizes each axis by a weight matrix (``scale_and_translate`` with the
triangle kernel): output pixel j samples input position (j + 0.5) / scale -
0.5; when downsampling the triangle is widened by 1 / scale (the antialias
filter), and each output's weights are renormalized to sum to one, which also
handles the edges. ``F.interpolate(antialias=True)`` differs from it when
downsampling, so the port builds the same matrices and applies them as two
small products.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=32)
def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) float32 weights of the antialiased bilinear resize
    of one axis (jax/_src/image/scale.py ``compute_weight_mat``, translation 0)."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(out_size, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float64)[:, None]) / kernel_scale
    w = np.maximum(0.0, 1.0 - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(np.float32)


def resize_bilinear(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(N, H, W, C) float -> (N, height, width, C), antialiased when
    downsampling; an axis whose size already matches is left as it is."""
    _, h, w, _ = x.shape
    if h != height:
        wh = torch.as_tensor(resize_weights(h, height), device=x.device, dtype=x.dtype)
        x = torch.einsum("nhwc,hi->niwc", x, wh)
    if w != width:
        ww = torch.as_tensor(resize_weights(w, width), device=x.device, dtype=x.dtype)
        x = torch.einsum("nhwc,wj->nhjc", x, ww)
    return x


def pixel_values(x: torch.Tensor, size: int) -> torch.Tensor:
    """Raw (N, H, W, 3) frames (uint8, or float in 0..255) -> the
    ViTImageProcessor recipe: (N, size, size, 3) float32, resized, rescaled
    by 1/255 and normalized with mean = std = 0.5."""
    x = x.float()
    if x.shape[1:3] != (size, size):
        x = resize_bilinear(x, size, size)
    return (x / 255.0 - 0.5) / 0.5
