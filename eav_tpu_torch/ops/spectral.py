"""Spectral frontends in PyTorch: the Kaldi-style log-mel fbank (AST) and the
librosa-convention mel / MFCC / chroma of the SCNN's 180-d feature, as in
``eav_tpu/ops/spectral.py``.

The window, mel, chroma and DCT designs are tiny host numpy (cached); the
per-clip work (framing, windowing, rFFT, mel and chroma projections, the DCT,
the tuning estimate) runs batched on the waveform's device.

- ``ast_fbank`` has HF ``ASTFeatureExtractor``'s numerics (preemphasis 0.97,
  DC removal, symmetric Hann 400, hop 160, fft 512, Kaldi mel, floor
  1.19e-7, log, zero-pad to 1024 frames).
- mel / MFCC follow librosa (Slaney mel, power_to_db with top_db 80, DCT-II
  ortho); chroma follows ``librosa.feature.chroma_stft`` with its per-clip
  tuning estimate (``estimate_tuning_power``: piptrack + pitch_tuning), the
  tuned filter bank gathered from a table over the estimator's 0.01-bin grid.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

# -----------------------------------------------------------------------------
# Host-side designs
# -----------------------------------------------------------------------------


def hertz_to_mel(freq, mel_scale: str = "htk"):
    freq = np.asarray(freq, np.float64)
    if mel_scale == "htk":
        return 2595.0 * np.log10(1.0 + freq / 700.0)
    if mel_scale == "kaldi":
        return 1127.0 * np.log(1.0 + freq / 700.0)
    if mel_scale == "slaney":
        min_log_hertz, min_log_mel = 1000.0, 15.0
        logstep = 27.0 / np.log(6.4)
        mels = 3.0 * freq / 200.0
        return np.where(
            freq >= min_log_hertz,
            min_log_mel + np.log(np.maximum(freq, 1e-10) / min_log_hertz) * logstep,
            mels,
        )
    raise ValueError(mel_scale)


def mel_to_hertz(mels, mel_scale: str = "htk"):
    mels = np.asarray(mels, np.float64)
    if mel_scale == "htk":
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    if mel_scale == "kaldi":
        return 700.0 * (np.exp(mels / 1127.0) - 1.0)
    if mel_scale == "slaney":
        min_log_hertz, min_log_mel = 1000.0, 15.0
        logstep = np.log(6.4) / 27.0
        freq = 200.0 * mels / 3.0
        return np.where(
            mels >= min_log_mel,
            min_log_hertz * np.exp(logstep * (mels - min_log_mel)),
            freq,
        )
    raise ValueError(mel_scale)


@functools.lru_cache(maxsize=32)
def mel_filter_bank(
    num_frequency_bins: int,
    num_mel_filters: int,
    min_frequency: float,
    max_frequency: float,
    sampling_rate: int,
    norm: Optional[str] = None,
    mel_scale: str = "htk",
    triangularize_in_mel_space: bool = False,
) -> np.ndarray:
    """(num_frequency_bins, num_mel_filters) triangular filter matrix, as
    transformers.audio_utils.mel_filter_bank / librosa.filters.mel build it
    for the same arguments."""
    mel_min = hertz_to_mel(min_frequency, mel_scale)
    mel_max = hertz_to_mel(max_frequency, mel_scale)
    mel_freqs = np.linspace(mel_min, mel_max, num_mel_filters + 2)
    filter_freqs = mel_to_hertz(mel_freqs, mel_scale)
    if triangularize_in_mel_space:
        fft_bin_width = sampling_rate / ((num_frequency_bins - 1) * 2)
        fft_freqs = hertz_to_mel(fft_bin_width * np.arange(num_frequency_bins), mel_scale)
        filter_freqs = mel_freqs
    else:
        fft_freqs = np.linspace(0, sampling_rate // 2, num_frequency_bins)
    filter_diff = np.diff(filter_freqs)
    slopes = filter_freqs[None, :] - fft_freqs[:, None]
    down = -slopes[:, :-2] / filter_diff[:-1]
    up = slopes[:, 2:] / filter_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    if norm == "slaney":
        enorm = 2.0 / (filter_freqs[2 : num_mel_filters + 2] - filter_freqs[:num_mel_filters])
        fb = fb * enorm[None, :]
    return fb


@functools.lru_cache(maxsize=16)
def hann_window(length: int, periodic: bool = False) -> np.ndarray:
    """The symmetric Hann window, or the periodic one (librosa's STFT)."""
    if periodic:
        return 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(length) / length)
    return 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(length) / (length - 1))


@functools.lru_cache(maxsize=16)
def chroma_filter_bank(
    sampling_rate: int,
    n_fft: int,
    n_chroma: int = 12,
    tuning: float = 0.0,
    ctroct: float = 5.0,
    octwidth: float = 2.0,
    base_c: bool = True,
) -> np.ndarray:
    """librosa.filters.chroma at a fixed ``tuning``: (n_chroma, 1 + n_fft//2)."""
    frequencies = np.linspace(0, sampling_rate, n_fft, endpoint=False)[1:]
    a440 = 440.0 * 2.0 ** (tuning / n_chroma)
    frqbins = n_chroma * np.log2(frequencies / (a440 / 16))
    frqbins = np.concatenate(([frqbins[0] - 1.5 * n_chroma], frqbins))
    binwidthbins = np.concatenate((np.maximum(frqbins[1:] - frqbins[:-1], 1.0), [1.0]))
    D = np.subtract.outer(frqbins, np.arange(0, n_chroma, dtype="d")).T
    n_chroma2 = np.round(float(n_chroma) / 2)
    D = np.remainder(D + n_chroma2 + 10 * n_chroma, n_chroma) - n_chroma2
    wts = np.exp(-0.5 * (2 * D / np.tile(binwidthbins, (n_chroma, 1))) ** 2)
    wts = wts / np.maximum(np.sqrt(np.sum(wts**2, axis=0, keepdims=True)), 1e-10)  # L2 columns
    if octwidth is not None:
        wts *= np.tile(
            np.exp(-0.5 * (((frqbins / n_chroma - ctroct) / octwidth) ** 2)),
            (n_chroma, 1),
        )
    if base_c:
        wts = np.roll(wts, -3 * (n_chroma // 12), axis=0)
    return np.ascontiguousarray(wts[:, : int(1 + n_fft / 2)])


@functools.lru_cache(maxsize=8)
def _chroma_bank_table(
    sampling_rate: int, n_fft: int, n_chroma: int, resolution: float
) -> np.ndarray:
    """(n_grid, n_chroma, bins) chroma filter banks, one per value of the
    tuning grid ``linspace(-0.5, 0.5, ceil(1/resolution)+1)[:-1]`` (the left
    edges of ``estimate_tuning_power``'s histogram), so that a clip's tuned
    bank is a gather."""
    grid = np.linspace(-0.5, 0.5, int(np.ceil(1.0 / resolution)) + 1)[:-1]
    return np.stack(
        [chroma_filter_bank(sampling_rate, n_fft, n_chroma, tuning=t) for t in grid]
    )


@functools.lru_cache(maxsize=8)
def dct_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) DCT-II with the ortho norm, applied on the right."""
    k = np.arange(n_in)
    basis = np.cos(np.pi / n_in * (k[:, None] + 0.5) * np.arange(n_out)[None, :])
    scale = np.full((n_out,), np.sqrt(2.0 / n_in))
    scale[0] = np.sqrt(1.0 / n_in)
    return basis * scale[None, :]


def _on(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A host design on ``like``'s device in its (real) dtype."""
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


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
    window = _on(hann_window(frame_length), frames)
    spec = torch.fft.rfft(frames * window, n=fft_length, dim=-1)
    power = spec.abs() ** 2
    fb = mel_filter_bank(
        num_frequency_bins=fft_length // 2 + 1,
        num_mel_filters=num_mel_bins,
        min_frequency=20.0,
        max_frequency=sampling_rate // 2,
        sampling_rate=sampling_rate,
        norm=None,
        mel_scale="kaldi",
        triangularize_in_mel_space=True,
    )
    fb = _on(fb, power)
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


def stft_mag_sq(y: torch.Tensor, n_fft: int = 2048, hop: int = 512,
                center: bool = True) -> torch.Tensor:
    """librosa-style power STFT: (..., T) -> (..., frames, 1 + n_fft//2),
    reflect-padded by n_fft // 2 on both sides when ``center``."""
    if center:
        lead = y.shape[:-1]
        y = F.pad(y.reshape(-1, 1, y.shape[-1]), (n_fft // 2, n_fft // 2), mode="reflect")
        y = y.reshape(*lead, y.shape[-1])
    frames = frame_signal(y, n_fft, hop)
    spec = torch.fft.rfft(frames * _on(hann_window(n_fft, periodic=True), frames), dim=-1)
    return spec.abs() ** 2


def _mel_bank(power: torch.Tensor, sr: int, n_fft: int, n_mels: int) -> torch.Tensor:
    return _on(mel_filter_bank(n_fft // 2 + 1, n_mels, 0.0, sr / 2.0, sr,
                               norm="slaney", mel_scale="slaney"), power)


def mel_spectrogram(y: torch.Tensor, sr: int = 22050, n_fft: int = 2048, hop: int = 512,
                    n_mels: int = 128) -> torch.Tensor:
    """librosa.feature.melspectrogram: (..., frames, n_mels)."""
    power = stft_mag_sq(y, n_fft, hop)
    return power @ _mel_bank(power, sr, n_fft, n_mels)


def power_to_db(S: torch.Tensor, top_db: Optional[float] = 80.0,
                amin: float = 1e-10) -> torch.Tensor:
    """librosa.power_to_db with ref 1.0; the top_db clip is relative to each
    clip's maximum over the last two axes."""
    log_spec = 10.0 * torch.log10(torch.clamp(S, min=amin))
    if top_db is not None:
        mx = log_spec.amax(dim=(-2, -1), keepdim=True)
        log_spec = torch.maximum(log_spec, mx - top_db)
    return log_spec


def _mfcc_of_mel(mel: torch.Tensor, n_mfcc: int) -> torch.Tensor:
    S_db = power_to_db(mel)
    return S_db @ _on(dct_matrix(S_db.shape[-1], n_mfcc), S_db)


def mfcc(y: torch.Tensor, sr: int = 22050, n_mfcc: int = 40, n_fft: int = 2048,
         hop: int = 512) -> torch.Tensor:
    """librosa.feature.mfcc: (..., frames, n_mfcc)."""
    return _mfcc_of_mel(mel_spectrogram(y, sr, n_fft, hop), n_mfcc)


def estimate_tuning_power(
    power: torch.Tensor,
    sr: int,
    n_fft: int,
    bins_per_octave: int = 12,
    fmin: float = 150.0,
    fmax: float = 4000.0,
    threshold: float = 0.1,
    resolution: float = 0.01,
) -> torch.Tensor:
    """librosa ``estimate_tuning`` on a power spectrogram, batched.

    (..., frames, bins) -> (...,) int64 index into the tuning grid
    ``linspace(-0.5, 0.5, ceil(1/resolution)+1)`` (tuning in fractional
    chroma bins = -0.5 + idx * resolution), librosa's piptrack ->
    pitch_tuning pipeline:

    - parabolic interpolation of spectral peaks (local maxima over bins above
      ``threshold * frame_max``, within [fmin, min(fmax, sr/2)));
    - keep candidates with magnitude >= the median candidate magnitude;
    - histogram of pitch residuals ``mod(bpo * log2(f/(A440/16)), 1)`` folded
      to [-0.5, 0.5) (numpy's bins: ``searchsorted(side='right') - 1``,
      clipped, over float64 edges); the first densest bin is the tuning, and
      a clip without candidates gets tuning 0.
    """
    S = power
    dt = S.dtype
    Sm1, S0, Sp1 = S[..., :-2], S[..., 1:-1], S[..., 2:]
    avg = 0.5 * (Sp1 - Sm1)
    denom = 2.0 * S0 - Sp1 - Sm1
    shift = avg / (denom + (denom.abs() < torch.finfo(dt).tiny).to(dt))
    avg, shift = F.pad(avg, (1, 1)), F.pad(shift, (1, 1))
    dskew = 0.5 * avg * shift
    n_bins = S.shape[-1]
    fft_freqs = np.arange(n_bins) * sr / n_fft
    freq_mask = torch.as_tensor((fmin <= fft_freqs) & (fft_freqs < min(fmax, sr / 2.0)),
                                device=S.device)
    ref = threshold * S.amax(dim=-1, keepdim=True)
    Sm = S * (S > ref).to(dt)
    left = torch.cat([Sm[..., :1], Sm[..., :-1]], dim=-1)  # edge-padded neighbours
    right = torch.cat([Sm[..., 1:], Sm[..., -1:]], dim=-1)
    cand = freq_mask & (Sm > left) & (Sm >= right)
    bins = torch.arange(n_bins, device=S.device)
    pitches = torch.where(cand, (bins + shift) * (sr / n_fft), torch.zeros((), dtype=dt,
                                                                          device=S.device))
    mags = torch.where(cand, S + dskew, torch.zeros((), dtype=dt, device=S.device))
    batch = S.shape[:-2]
    pitches, mags = pitches.reshape(*batch, -1), mags.reshape(*batch, -1)
    mask = pitches > 0
    # the median of the candidates' magnitudes: sort with +inf fill
    n = mask.sum(dim=-1, keepdim=True)
    sorted_mags = torch.sort(torch.where(mask, mags, torch.full((), math.inf, dtype=dt,
                                                                device=S.device)), dim=-1).values
    lo = torch.gather(sorted_mags, -1, torch.clamp((n - 1) // 2, min=0))
    hi = torch.gather(sorted_mags, -1, n // 2)
    median = torch.where(n > 0, 0.5 * (lo + hi), torch.zeros((), dtype=dt, device=S.device))
    keep = mask & (mags >= median)
    # pitch residuals; log2 as log(x) / log(2), the JAX package's lowering
    f = torch.where(mask, pitches, torch.ones((), dtype=dt, device=S.device)) * (16.0 / 440.0)
    residual = torch.remainder(bins_per_octave * (torch.log(f) / math.log(2.0)), 1.0)
    residual = torch.where(residual >= 0.5, residual - 1.0, residual)
    n_grid = int(np.ceil(1.0 / resolution))
    edges = torch.as_tensor(np.linspace(-0.5, 0.5, n_grid + 1), device=S.device)
    bucket = torch.searchsorted(edges, residual.double().contiguous(), right=True) - 1
    bucket = bucket.clamp(0, n_grid - 1)
    flat = bucket.reshape(-1, bucket.shape[-1])
    counts = torch.zeros(flat.shape[0], n_grid, dtype=torch.int64, device=S.device)
    counts.scatter_add_(1, flat, keep.reshape(flat.shape).to(torch.int64))
    idx = counts.argmax(dim=-1).reshape(batch)
    return torch.where(n[..., 0] > 0, idx, torch.full_like(idx, n_grid // 2))


def _chroma_of_power(power: torch.Tensor, sr: int, n_fft: int, n_chroma: int,
                     tuning: Optional[float]) -> torch.Tensor:
    if tuning is not None:
        raw = power @ _on(chroma_filter_bank(sr, n_fft, n_chroma, tuning), power).T
    else:
        table = _on(_chroma_bank_table(sr, n_fft, n_chroma, 0.01), power)
        idx = estimate_tuning_power(power, sr, n_fft, bins_per_octave=n_chroma)
        raw = torch.einsum("...fb,...cb->...fc", power, table[idx])
    mx = raw.abs().amax(dim=-1, keepdim=True)
    return raw / torch.clamp(mx, min=1e-10)


def chroma_stft(y: torch.Tensor, sr: int = 22050, n_chroma: int = 12, n_fft: int = 2048,
                hop: int = 512, tuning: Optional[float] = None) -> torch.Tensor:
    """librosa.feature.chroma_stft: (..., frames, n_chroma), each frame
    divided by its largest entry. ``tuning=None`` (librosa's default)
    estimates each clip's tuning (``estimate_tuning_power``); a float pins it."""
    return _chroma_of_power(stft_mag_sq(y, n_fft, hop), sr, n_fft, n_chroma, tuning)


def scnn180_features(y: torch.Tensor, sr: int = 22050, n_mfcc: int = 40, n_chroma: int = 12,
                     n_mels: int = 128, n_fft: int = 2048, hop: int = 512) -> torch.Tensor:
    """The audio notebook's handcrafted vector (`CNN_audio_emotion_recognition.ipynb`
    extract_feature): per clip, the mean over frames of MFCC(40) ++ chroma(12)
    ++ mel(128): (..., T) -> (..., 180). The three share one power STFT (the
    same n_fft and hop), which the JAX package computes three times."""
    power = stft_mag_sq(y, n_fft, hop)
    mel = power @ _mel_bank(power, sr, n_fft, n_mels)
    m = _mfcc_of_mel(mel, n_mfcc).mean(dim=-2)
    c = _chroma_of_power(power, sr, n_fft, n_chroma, None).mean(dim=-2)
    return torch.cat([m, c, mel.mean(dim=-2)], dim=-1)
