"""Dependency-free RIFF/WAVE reader (+ PCM16 writer for tests and synthetic data).

A copy of ``eav_tpu/ingest/wav.py`` (numpy only). Supports PCM 8/16/24/32-bit
and IEEE float32/64, any channel count; integer PCM is scaled by
2**(bits-1), as torchaudio.load does.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

_PCM = 1
_IEEE_FLOAT = 3
_EXTENSIBLE = 0xFFFE


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Return (waveform (channels, samples) float32 in [-1, 1], sample_rate).

    Matches torchaudio.load conventions: integer PCM scaled by 2**(bits-1).
    """
    with open(path, "rb") as f:
        riff, _size, wave = struct.unpack("<4sI4s", f.read(12))
        if riff != b"RIFF" or wave != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        fmt = None
        data = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            chunk_id, chunk_size = struct.unpack("<4sI", hdr)
            payload = f.read(chunk_size)
            if chunk_size % 2:  # chunks are word-aligned
                f.read(1)
            if chunk_id == b"fmt ":
                fmt = payload
            elif chunk_id == b"data":
                data = payload
        if fmt is None or data is None:
            raise ValueError(f"{path}: missing fmt/data chunk")
    audio_format, channels, sample_rate, _br, _ba, bits = struct.unpack(
        "<HHIIHH", fmt[:16]
    )
    if audio_format == _EXTENSIBLE:
        sub_format = struct.unpack("<H", fmt[24:26])[0]
        audio_format = sub_format
    if audio_format == _IEEE_FLOAT:
        dtype = np.float32 if bits == 32 else np.float64
        x = np.frombuffer(data, dtype=dtype).astype(np.float32)
    elif audio_format == _PCM:
        if bits == 16:
            x = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(data, dtype="<i4").astype(np.float32) / 2147483648.0
        elif bits == 8:
            x = (np.frombuffer(data, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 24:
            raw = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
            ints = (
                raw[:, 0].astype(np.int32)
                | (raw[:, 1].astype(np.int32) << 8)
                | (raw[:, 2].astype(np.int32) << 16)
            )
            ints = np.where(ints >= 1 << 23, ints - (1 << 24), ints)
            x = ints.astype(np.float32) / float(1 << 23)
        else:
            raise ValueError(f"{path}: unsupported PCM bit depth {bits}")
    else:
        raise ValueError(f"{path}: unsupported WAV format {audio_format}")
    n = (len(x) // channels) * channels
    return x[:n].reshape(-1, channels).T.copy(), int(sample_rate)


def write_wav(path: str, waveform: np.ndarray, sample_rate: int) -> None:
    """PCM16 writer for tests/synthetic data. ``waveform``: (channels, samples)
    or (samples,) float in [-1, 1]."""
    waveform = np.atleast_2d(np.asarray(waveform))
    channels, _ = waveform.shape
    pcm = np.clip(np.round(waveform.T * 32767.0), -32768, 32767).astype("<i2")
    data = pcm.tobytes()
    byte_rate = sample_rate * channels * 2
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE")
        f.write(
            b"fmt " + struct.pack("<IHHIIHH", 16, 1, channels, sample_rate, byte_rate, channels * 2, 16)
        )
        f.write(b"data" + struct.pack("<I", len(data)) + data)
