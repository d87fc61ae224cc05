"""Polyphase resampling (``scipy.signal.resample_poly``) as one strided conv1d.

The filter design is tiny host numpy (scipy's ``firwin``, as
``eav_tpu/ops/signal.py`` does); the filtering runs on the signal's device.
Instead of zero-stuffing the input by ``up`` (which multiplies its length by
``up``, 160 for 44.1 -> 16 kHz), the filter is split into its ``up`` phases:
output ``up*a + b`` is the correlation of the input with phase ``b`` at input
offset ``a*down``, so all phases are the output channels of one conv1d with
stride ``down``.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=64)
def design_resample_fir(up: int, down: int) -> Tuple[np.ndarray, int]:
    """Kaiser-windowed lowpass FIR identical to resample_poly's default design
    (window=('kaiser', 5.0), 10*max_rate taps each side). Returns (taps
    scaled by ``up``, half_len)."""
    from scipy.signal import firwin

    max_rate = max(up, down)
    half_len = 10 * max_rate
    h = firwin(2 * half_len + 1, 1.0 / max_rate, window=("kaiser", 5.0))
    return np.asarray(h, dtype=np.float64) * up, half_len


@functools.lru_cache(maxsize=64)
def _polyphase_bank(up: int, down: int) -> Tuple[np.ndarray, int, int]:
    """(weights (up, 1, K), left pad, first kept output) for coprime up/down.

    With the delay-compensating zero pre-pad that scipy puts in front of the
    filter, the full upfirdn output is y[m] = sum_i h[m*down - i*up] x[i].
    For m = up*a + b write b*down = up*q_b + r_b; then
    y[m] = sum_l h[r_b + up*l] x[a*down + q_b - l], a correlation of the
    input (left-padded by L-1 zeros) with weights w_b[q_b + L-1 - l]."""
    h, half_len = design_resample_fir(up, down)
    n_pre_pad = (down - half_len % down) % down
    first = (half_len + n_pre_pad) // down
    h = np.concatenate([np.zeros(n_pre_pad), h])
    taps = -(-len(h) // up)  # L: most taps of any phase
    q = [b * down // up for b in range(up)]
    width = max(q) + taps
    w = np.zeros((up, 1, width))
    for b in range(up):
        r = b * down % up
        phase = h[r::up]
        w[b, 0, q[b] + taps - 1 - np.arange(len(phase))] = phase
    return w, taps - 1, first


def resample_poly(x: torch.Tensor, up: int, down: int) -> torch.Tensor:
    """``scipy.signal.resample_poly(x, up, down, axis=-1)`` with the default
    Kaiser design, on the tensor's device. Leading axes are batch."""
    if up == down:
        return x
    g = math.gcd(up, down)
    up, down = up // g, down // g
    w, pad, first = _polyphase_bank(up, down)
    n_in = x.shape[-1]
    n_out = -(-n_in * up // down)
    blocks = -(-(first + n_out) // up)  # outputs per phase
    width = w.shape[-1]
    dtype = torch.promote_types(x.dtype, torch.float32)
    xb = x.reshape(-1, 1, n_in).to(dtype)
    right = max(0, (blocks - 1) * down + width - (n_in + pad))
    xb = F.pad(xb, (pad, right))
    weight = torch.as_tensor(w, dtype=dtype, device=x.device)
    y = F.conv1d(xb, weight, stride=down)[..., :blocks]  # (N, up, blocks)
    y = y.transpose(1, 2).reshape(xb.shape[0], blocks * up)
    return y[:, first : first + n_out].reshape(x.shape[:-1] + (n_out,))
