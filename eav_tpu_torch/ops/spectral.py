"""The AST frontend: Kaldi-style log-mel fbank with HF ``ASTFeatureExtractor``
numerics, batched on the waveform's device.

The window and mel filter designs are tiny host numpy, the AST setting of
those in ``eav_tpu/ops/spectral.py``; the per-clip work (framing, DC
removal, pre-emphasis, windowing, rFFT, mel projection, log) runs in PyTorch.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

# -----------------------------------------------------------------------------
# Host-side designs
# -----------------------------------------------------------------------------


def hertz_to_mel(freq):
    """Kaldi's mel scale."""
    return 1127.0 * np.log(1.0 + np.asarray(freq, np.float64) / 700.0)


@functools.lru_cache(maxsize=32)
def mel_filter_bank(
    num_frequency_bins: int,
    num_mel_filters: int,
    min_frequency: float,
    max_frequency: float,
    sampling_rate: int,
) -> np.ndarray:
    """(num_frequency_bins, num_mel_filters) triangular filters on Kaldi's
    mel scale, triangles drawn in mel space, unnormalized: the filters that
    transformers.audio_utils.mel_filter_bank builds with ``norm=None,
    mel_scale='kaldi', triangularize_in_mel_space=True``, the AST setting."""
    mel_freqs = np.linspace(
        hertz_to_mel(min_frequency), hertz_to_mel(max_frequency), num_mel_filters + 2
    )
    fft_bin_width = sampling_rate / ((num_frequency_bins - 1) * 2)
    fft_freqs = hertz_to_mel(fft_bin_width * np.arange(num_frequency_bins))
    filter_diff = np.diff(mel_freqs)
    slopes = mel_freqs[None, :] - fft_freqs[:, None]
    down = -slopes[:, :-2] / filter_diff[:-1]
    up = slopes[:, 2:] / filter_diff[1:]
    return np.maximum(0.0, np.minimum(down, up))


@functools.lru_cache(maxsize=16)
def hann_window(length: int) -> np.ndarray:
    """The symmetric (non-periodic) Hann window."""
    return 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(length) / (length - 1))


# -----------------------------------------------------------------------------
# Device ops
# -----------------------------------------------------------------------------


def frame_signal(x: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """(..., T) -> (..., n_frames, frame_length), no centering (a view)."""
    return x.unfold(-1, frame_length, hop)


def ast_fbank(
    waveform: torch.Tensor,
    num_mel_bins: int = 128,
    max_frames: int = 1024,
    sampling_rate: int = 16000,
) -> torch.Tensor:
    """Kaldi-compatible log-mel fbank, HF ASTFeatureExtractor numerics:
    (..., T) -> (..., max_frames, num_mel_bins), un-normalized."""
    frame_length, hop, fft_length = 400, 160, 512
    preemph, mel_floor = 0.97, 1.192092955078125e-07
    frames = frame_signal(waveform, frame_length, hop)
    frames = frames - frames.mean(dim=-1, keepdim=True)  # remove_dc_offset
    frames = torch.cat(
        [frames[..., :1] * (1.0 - preemph), frames[..., 1:] - preemph * frames[..., :-1]],
        dim=-1,
    )
    window = torch.as_tensor(hann_window(frame_length), dtype=frames.dtype, device=frames.device)
    spec = torch.fft.rfft(frames * window, n=fft_length, dim=-1)
    power = spec.abs() ** 2
    fb = mel_filter_bank(
        num_frequency_bins=fft_length // 2 + 1,
        num_mel_filters=num_mel_bins,
        min_frequency=20.0,
        max_frequency=sampling_rate // 2,
        sampling_rate=sampling_rate,
    )
    fb = torch.as_tensor(fb, dtype=power.dtype, device=power.device)
    logmel = torch.log(torch.clamp(power @ fb, min=mel_floor))
    n = logmel.shape[-2]
    if n < max_frames:
        return F.pad(logmel, (0, 0, 0, max_frames - n))
    return logmel[..., :max_frames, :]


def ast_features(
    waveform: torch.Tensor,
    mean: float = -4.2677393,
    std: float = 4.5689974,
    **kw,
) -> torch.Tensor:
    """Full AST frontend incl. AudioSet normalization (x - mean) / (2*std)."""
    return (ast_fbank(waveform, **kw) - mean) / (2.0 * std)
