"""Signal DSP on the signal's device: polyphase resampling
(``scipy.signal.resample_poly``) and SOS IIR filtering
(``scipy.signal.sosfilt``), as ``eav_tpu/ops/signal.py`` has them.

The filter designs are tiny host numpy (scipy's ``firwin`` and ``butter``, as
the JAX package does); the filtering runs on the signal's device.

- ``resample_poly``: instead of zero-stuffing the input by ``up`` (which
  multiplies its length by ``up``, 160 for 44.1 -> 16 kHz), the filter is
  split into its ``up`` phases: output ``up*a + b`` is the correlation of the
  input with phase ``b`` at input offset ``a*down``, so all phases are the
  output channels of one conv1d with stride ``down``.
- ``sosfilt``: each biquad is split on the host, in float64, into a direct
  feed-through plus first-order complex recurrences ``u[n] = p u[n-1] +
  c[n]`` with |p| < 1 (``_biquad_parfrac``, the JAX package's design). Each
  recurrence is solved in blocks of L samples, parallel over time: within a
  block u = T c + p^(i+1) carry with T[i, j] = p^(i-j) for i >= j, one
  complex matmul for all blocks at once; the blocks' carries obey the same
  recurrence with p^L and are solved by the same function, one level up.
  Every entry of T and every power of p is at most 1 in modulus, so float32
  stays as well conditioned as the JAX package's scalar pair scan; the
  ``cumsum(c p^-k) p^k`` shortcut would overflow. ``method='scan'`` is the
  sequential reference (scipy's operation order), and the path of a
  defective (double-pole) section.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=64)
def design_butter_sos(order: int, lo: float, hi: float, fs: float) -> np.ndarray:
    """Order-``order`` Butterworth bandpass as second-order sections: the
    reference's design call (`Dataload_eeg.py:113`)."""
    from scipy.signal import butter

    return np.asarray(butter(order, [lo, hi], btype="bandpass", fs=fs, output="sos"),
                      dtype=np.float64)


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


# -----------------------------------------------------------------------------
# SOS IIR filtering
# -----------------------------------------------------------------------------


def _biquad_parfrac(section: np.ndarray):
    """Host-side (float64) partial-fraction split of one biquad.

    H(w) = (b0 + b1 w + b2 w^2)/(1 + a1 w + a2 w^2), w = z^-1, with poles
    p1, p2 (roots of z^2 + a1 z + a2):
       H = C + A1/(1 - p1 w) + A2/(1 - p2 w),  C = b2/a2.
    Returns (C, [(p_i, A_i, scale_i)]) where scale is 2 for a conjugate pair
    represented by a single complex recurrence (y += scale * Re(u)), or None
    for a first-order, FIR or (near-)defective section, which takes the
    sequential path.
    """
    b0, b1, b2, _, a1, a2 = [float(v) for v in section]
    if abs(a2) < 1e-12:
        return None
    p1, p2 = np.roots([1.0, a1, a2])
    if abs(p1 - p2) < 1e-7 * max(1.0, abs(p1)):
        return None
    num = lambda w: b0 + b1 * w + b2 * w * w  # noqa: E731
    c = b2 / a2
    a1_res = num(1.0 / p1) / (1.0 - p2 / p1)
    if np.iscomplex(p1) and abs(p1.imag) > 1e-12:
        return c, [(complex(p1), complex(a1_res), 2.0)]
    a2_res = num(1.0 / p2) / (1.0 - p1 / p2)
    return c, [(complex(p1), complex(a1_res), 1.0), (complex(p2), complex(a2_res), 1.0)]


@functools.lru_cache(maxsize=256)
def _block_operator(p: complex, length: int) -> Tuple[np.ndarray, np.ndarray]:
    """(T, powers) in complex128: T[i, j] = p^(i-j) for i >= j, else 0, and
    powers[i] = p^(i+1), the weight of the carry at position i."""
    k = np.arange(length)
    lag = k[:, None] - k[None, :]
    t = np.where(lag >= 0, np.power(complex(p), np.maximum(lag, 0)), 0.0)
    return t.astype(np.complex128), np.power(complex(p), k + 1).astype(np.complex128)


def linear_recurrence(p: complex, c: torch.Tensor, block: int = 256) -> torch.Tensor:
    """u[n] = p u[n-1] + c[n], u[-1] = 0, along the last axis of complex
    ``c``, in blocks of ``block`` samples (the module docstring)."""
    t = c.shape[-1]
    length = min(block, t)
    nblocks = -(-t // length)
    pad = nblocks * length - t
    cb = F.pad(c, (0, pad)) if pad else c
    cb = cb.reshape(c.shape[:-1] + (nblocks, length))
    op, powers = _block_operator(complex(p), length)
    u = cb @ torch.as_tensor(op.T, dtype=c.dtype, device=c.device)  # zero carry in
    if nblocks > 1:
        # the true value at each block's end obeys s_b = p^L s_(b-1) + e_b
        ends = linear_recurrence(complex(p) ** length, u[..., -1], block)
        carry = F.pad(ends[..., :-1], (1, 0))  # the value entering block b
        u = u + carry[..., None] * torch.as_tensor(powers, dtype=c.dtype, device=c.device)
    u = u.reshape(c.shape[:-1] + (nblocks * length,))
    return u[..., :t] if pad else u


def _section_parallel(section: np.ndarray, x: torch.Tensor, block: int) -> torch.Tensor:
    dec = _biquad_parfrac(section)
    if dec is None:
        return _section_scan(section, x)
    feed, terms = dec
    cdtype = torch.complex128 if x.dtype == torch.float64 else torch.complex64
    xc = x.to(cdtype)
    y = feed * x
    for p, residue, scale in terms:
        y = y + scale * linear_recurrence(p, residue * xc, block).real
    return y


def _section_scan(section: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """Sequential reference: transposed direct form II, scipy's order."""
    b0, b1, b2, _, a1, a2 = [float(v) for v in section]
    z1 = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    z2 = torch.zeros_like(z1)
    out = []
    for xt in x.unbind(-1):
        yt = b0 * xt + z1
        z1 = b1 * xt - a1 * yt + z2
        z2 = b2 * xt - a2 * yt
        out.append(yt)
    return torch.stack(out, -1)


def sosfilt(sos, x: torch.Tensor, method: str = "parallel", block: int = 256) -> torch.Tensor:
    """``scipy.signal.sosfilt(sos, x, axis=-1)`` with zero initial state, on
    the tensor's device. ``sos`` is a host (n_sections, 6) array, split in
    float64; ``method`` 'parallel' (blocks of ``block`` samples) or 'scan'
    (sequential, the reference)."""
    if method not in ("parallel", "scan"):
        raise ValueError(f"unknown sosfilt method {method!r}")
    sos = np.asarray(sos, np.float64).reshape(-1, 6)
    y = x.to(torch.promote_types(x.dtype, torch.float32))
    for section in sos:
        y = _section_parallel(section, y, block) if method == "parallel" else _section_scan(section, y)
    return y


def bandpass_sos(x: torch.Tensor, lo: float, hi: float, fs: float, order: int = 5,
                 method: str = "parallel") -> torch.Tensor:
    """Butterworth bandpass along the last axis, all channels at once (the
    reference's per-channel loop, `Dataload_eeg.py:104-121`)."""
    return sosfilt(design_butter_sos(order, lo, hi, fs), x, method=method)
