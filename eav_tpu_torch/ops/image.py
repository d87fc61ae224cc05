"""The ViT preprocessing of the JAX package: ``jax.image.resize(...,
"bilinear", antialias=True)`` to the model's size, then (x / 255 - 0.5) / 0.5.

JAX resizes each axis by a weight matrix (``scale_and_translate`` with the
triangle kernel): output pixel j samples input position (j + 0.5) / scale -
0.5; when downsampling the triangle is widened by 1 / scale (the antialias
filter), and each output's weights are renormalized to sum to one, which also
handles the edges. ``F.interpolate(antialias=True)`` differs from it when
downsampling, so the port builds the same matrices and applies them as two
small products.

``resize_linear_u8`` is the other resize of the package: cv2's uint8
INTER_LINEAR, which the JAX package calls for its center crops, in numpy.
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


@functools.lru_cache(maxsize=None)
def _weights_on(in_size: int, out_size: int, device: torch.device,
                dtype: torch.dtype) -> torch.Tensor:
    """``resize_weights`` copied to ``device`` once and kept: a forward
    captured into a CUDA graph (``train/loop.Trainer.train_step``) may not
    copy from pageable host memory, and its replays read these tensors, so
    none is ever evicted (one a pair of sizes, device and type). The copy is
    waited for before the tensor is shared: another thread may read it on
    another stream."""
    w = torch.as_tensor(resize_weights(in_size, out_size), device=device, dtype=dtype)
    if w.is_cuda:
        torch.cuda.current_stream(device).synchronize()
    return w


def resize_bilinear(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(N, H, W, C) float -> (N, height, width, C), antialiased when
    downsampling; an axis whose size already matches is left as it is."""
    _, h, w, _ = x.shape
    if h != height:
        x = torch.einsum("nhwc,hi->niwc", x, _weights_on(h, height, x.device, x.dtype))
    if w != width:
        x = torch.einsum("nhwc,wj->nhjc", x, _weights_on(w, width, x.device, x.dtype))
    return x


def pixel_values(x: torch.Tensor, size: int) -> torch.Tensor:
    """Raw (N, H, W, 3) frames (uint8, or float in 0..255) -> the
    ViTImageProcessor recipe: (N, size, size, 3) float32, resized, rescaled
    by 1/255 and normalized with mean = std = 0.5."""
    x = x.float()
    if x.shape[1:3] != (size, size):
        x = resize_bilinear(x, size, size)
    return (x / 255.0 - 0.5) / 0.5


# cv2's fixed-point INTER_LINEAR: weights in units of 1 / 2048
_COEF_SCALE = 2048


@functools.lru_cache(maxsize=32)
def _linear_taps(in_size: int, out_size: int, clamp_weights: bool):
    """cv2's taps of one axis: source indices (out_size,) x 2 and integer
    weights (out_size,) x 2 summing to 2048. Output ``d`` samples
    ``(d + 0.5) * in / out - 0.5`` in float32. Along x (``clamp_weights``) a
    sample left of the first pixel or right of the last takes that pixel
    whole; along y the weights stay as computed and the two rows are clamped
    into the image, so an edge row's weights are split over one row."""
    f = ((np.arange(out_size) + 0.5) * (in_size / out_size) - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    if clamp_weights:
        lo, hi = s < 0, s >= in_size - 1
        f[lo | hi] = 0.0
        s = np.where(lo, 0, np.where(hi, in_size - 1, s))
    w1 = np.rint(f * np.float32(_COEF_SCALE)).astype(np.int32)
    w0 = np.rint((np.float32(1.0) - f) * np.float32(_COEF_SCALE)).astype(np.int32)
    taps = (np.clip(s, 0, in_size - 1), np.clip(s + 1, 0, in_size - 1), w0, w1)
    for t in taps:  # cached: shared by every caller
        t.setflags(write=False)
    return taps


def resize_linear_u8(frames: np.ndarray, height: int, width: int) -> np.ndarray:
    """(N, H, W, C) uint8 -> (N, height, width, C) uint8, equal bit for bit to
    ``cv2.resize(frame, (width, height))`` (INTER_LINEAR) frame by frame,
    without cv2. cv2 interpolates rows in int32 with 11-bit weights, then
    combines two rows as its vector code does: each row's sum shifted right
    by 4, times the row weight, the high 16 bits kept, and the total rounded
    off by 2 bits. (An exact 2x downscale, which cv2 hands to INTER_AREA,
    gives the same numbers.)"""
    _, h, w, _ = frames.shape
    x0, x1, a0, a1 = _linear_taps(w, width, True)
    y0, y1, b0, b1 = _linear_taps(h, height, False)
    s = frames.astype(np.int32)
    rows = s[:, :, x0] * a0[:, None] + s[:, :, x1] * a1[:, None]  # (N, H, width, C)
    top = (b0[:, None, None] * (rows[:, y0] >> 4)) >> 16
    bottom = (b1[:, None, None] * (rows[:, y1] >> 4)) >> 16
    return np.clip((top + bottom + 2) >> 2, 0, 255).astype(np.uint8)
