"""Pre-sweep data-root validation (the ``verify-data`` CLI subcommand), the
port of ``eav_tpu/ingest/verify.py``.

The reference's data contract is implicit — subject folders with
``EEG/subjectNN_eeg{,_label}.mat`` (`Dataload_eeg.py:64-78`), 100 Speaking
wavs (`README.md:26-27`, `Dataload_audio.py:26-35`) and Speaking mp4 clips
(`README.md:18-19`, `Dataload_vision.py:102-109`) — and it is enforced only
by crashing mid-run. This module walks a data root BEFORE a multi-hour sweep
and checks every layout/shape/label invariant the ingest layer depends on:

- EEG: both .mat files present, a ``seg``/``seg1`` variable (the per-subject
  naming quirk, `Dataload_eeg.py:71-74`) with dims (t, ch, trials) matching
  the preset (500 Hz x trial_seconds, cfg.channels), a ``label`` one-hot of
  matching trial count with exactly one hot row per trial in [0, 10).
- Audio: .wav files whose names carry a parseable known emotion token
  (`Dataload_audio.py:31`), RIFF headers decodable, durations ~20 s at a
  consistent sample rate (mixed rates across files are legal — the loader
  resamples per group — but flagged as info).
- Video: Speaking .mp4 clips with parseable emotion tokens
  (`Dataload_vision.py:107`); the first clip of each subject is probe-decoded
  one frame deep so codec problems surface here, not 2 hours into the sweep.

Shape checks PEEK at headers (incremental zlib for compressed .mat elements,
fmt-chunk-only WAV reads) — verifying 42 subjects costs seconds, not a full
ingest pass. The video probe decodes through ``ingest/video.py``'s
``decode_strided_frames`` (the native libav decoder, else cv2): on a machine
with neither every probe is a decode error in the report, so run with
``probe_video=False`` (``verify-data --no-probe``) there.
"""

from __future__ import annotations

import io
import os
import struct
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from eav_tpu_torch.core.config import EMOTION_TO_INDEX

_MI_COMPRESSED = 15
_MI_MATRIX = 14

KNOWN_EMOTIONS = tuple(EMOTION_TO_INDEX)


# -- cheap header peeks -------------------------------------------------------


def _peek_element_header(tag: bytes):
    """(mi_type, nbytes, header_len) from an 8-byte element tag."""
    mi_type, nbytes = struct.unpack("<II", tag[:8])
    if mi_type >> 16:  # small element
        return mi_type & 0xFFFF, mi_type >> 16, 4
    return mi_type, nbytes, 8


def _matrix_name_dims(raw: bytes) -> Tuple[str, Tuple[int, ...]]:
    """Name + dims of a miMATRIX payload prefix (flags/dims/name only)."""
    buf = io.BytesIO(raw)

    def elem():
        tag = buf.read(8)
        mi, n, hlen = _peek_element_header(tag)
        if hlen == 4:
            return mi, tag[4 : 4 + n]
        data = buf.read(n)
        buf.read((-n) % 8)
        return mi, data

    _, _flags = elem()
    _, dims_raw = elem()
    dims = tuple(int(d) for d in np.frombuffer(dims_raw, dtype=np.int32))
    _, name_raw = elem()
    return name_raw.rstrip(b"\x00").decode("latin1"), dims


def peek_mat_vars(path: str) -> Dict[str, Tuple[int, ...]]:
    """{var_name: dims} from a MATLAB v5 file WITHOUT materializing data.

    Compressed elements are inflated incrementally — only the first ~1 KiB of
    each element (flags + dims + name) is ever decompressed."""
    out: Dict[str, Tuple[int, ...]] = {}
    with open(path, "rb") as f:
        header = f.read(128)
        if len(header) < 128:
            raise ValueError(f"{path}: truncated .mat header")
        _version, endian = struct.unpack("<HH", header[124:128])
        if endian != 0x4D49:
            raise NotImplementedError(f"{path}: big-endian .mat not supported")
        while True:
            tag = f.read(8)
            if len(tag) < 8:
                break
            mi_type, nbytes, hlen = _peek_element_header(tag)
            if hlen == 4:  # small element, payload inside the tag
                continue
            if mi_type == _MI_COMPRESSED:
                d = zlib.decompressobj()
                inflated = b""
                remaining = nbytes
                while len(inflated) < 1024 and remaining > 0:
                    chunk = f.read(min(4096, remaining))
                    if not chunk:
                        break
                    remaining -= len(chunk)
                    inflated += d.decompress(chunk, 4096)
                f.seek(remaining + ((-nbytes) % 8), os.SEEK_CUR)
                if len(inflated) >= 16:
                    imi, _n, ihlen = _peek_element_header(inflated[:8])
                    if imi == _MI_MATRIX:
                        name, dims = _matrix_name_dims(inflated[ihlen:])
                        out[name] = dims
            elif mi_type == _MI_MATRIX:
                prefix = f.read(min(nbytes, 1024))
                f.seek(nbytes - len(prefix) + ((-nbytes) % 8), os.SEEK_CUR)
                name, dims = _matrix_name_dims(prefix)
                out[name] = dims
            else:
                f.seek(nbytes + ((-nbytes) % 8), os.SEEK_CUR)
    return out


def peek_mp4_boxes(path: str) -> List[str]:
    """Top-level ISO-BMFF box walk: size/type headers only, payloads seeked
    over — validating a 100-clip archive costs milliseconds, no decode.
    Returns the top-level box-type list; raises ValueError on a malformed
    container (truncated tree, box overrunning the file, garbage type)."""
    boxes: List[str] = []
    fsize = os.path.getsize(path)
    with open(path, "rb") as f:
        off = 0
        while off < fsize:
            hdr = f.read(8)
            if len(hdr) < 8:
                raise ValueError(f"truncated box header at offset {off}")
            size, btype = struct.unpack(">I4s", hdr)
            hlen = 8
            if size == 1:  # 64-bit largesize
                big = f.read(8)
                if len(big) < 8:
                    raise ValueError(f"truncated largesize at offset {off}")
                size = struct.unpack(">Q", big)[0]
                hlen = 16
            elif size == 0:  # box extends to EOF
                size = fsize - off
            if size < hlen or off + size > fsize:
                raise ValueError(
                    f"box {btype!r} at offset {off} has size {size}, "
                    f"overrunning the {fsize}-byte file"
                )
            if not all(0x20 <= b < 0x7F for b in btype):
                raise ValueError(f"non-printable box type {btype!r} at offset {off}")
            boxes.append(btype.decode("ascii"))
            off += size
            f.seek(off)
    if "moov" not in boxes:
        raise ValueError(f"no moov box (unfinalized or corrupt container): {boxes}")
    if not {"mdat", "moof"} & set(boxes):
        raise ValueError(f"no media-data box (mdat/moof): {boxes}")
    return boxes


def peek_wav(path: str) -> Tuple[int, int, int]:
    """(channels, sample_rate, n_frames) from the RIFF header only (the data
    chunk is seek-skipped, never read)."""
    with open(path, "rb") as f:
        riff, _size, wave = struct.unpack("<4sI4s", f.read(12))
        if riff != b"RIFF" or wave != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        channels = sample_rate = bits = None
        data_size = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            chunk_id, chunk_size = struct.unpack("<4sI", hdr)
            if chunk_id == b"fmt ":
                payload = f.read(chunk_size)
                _fmt, channels, sample_rate, _br, _ba, bits = struct.unpack(
                    "<HHIIHH", payload[:16]
                )
            else:
                if chunk_id == b"data":
                    data_size = chunk_size
                f.seek(chunk_size + (chunk_size % 2), os.SEEK_CUR)
                continue
            if chunk_size % 2:
                f.read(1)
        if channels is None or data_size is None:
            raise ValueError(f"{path}: missing fmt/data chunk")
        n_frames = data_size // (channels * max(bits // 8, 1))
        return channels, sample_rate, n_frames


# -- per-subject checks -------------------------------------------------------


@dataclass
class SubjectReport:
    subject: int
    errors: List[str] = field(default_factory=list)
    warnings: List[str] = field(default_factory=list)
    info: Dict[str, object] = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.errors


def _emotion_token(name: str) -> Optional[str]:
    parts = os.path.basename(name).split("_")
    if len(parts) < 5:
        return None
    return parts[4].split(".")[0]


def verify_subject(
    data_root: str,
    subject: int,
    modalities=("eeg", "audio", "vision"),
    eeg_channels: int = 30,
    trial_seconds: float = 20.0,
    raw_sr: int = 500,
    probe_video: bool = True,
    deep: bool = False,
) -> SubjectReport:
    rep = SubjectReport(subject)
    s = f"subject{subject:02d}"
    sdir = os.path.join(data_root, s)
    if not os.path.isdir(sdir):
        rep.errors.append(f"missing subject folder {sdir}")
        return rep

    if any(m.startswith("eeg") for m in modalities):
        _verify_eeg(rep, sdir, s, eeg_channels, int(trial_seconds * raw_sr))
    if any(m.startswith("audio") for m in modalities):
        _verify_audio(rep, sdir, trial_seconds)
    if any(m.startswith("vision") for m in modalities):
        _verify_video(rep, sdir, probe_video, deep=deep)
    # cross-modality count check against the 200-interaction contract
    # (`README.md:18-27`: 200 clips = 100 Listening + 100 Speaking, and one
    # Speaking wav per Speaking clip)
    n_wav, n_speaking = rep.info.get("n_wav"), rep.info.get("n_speaking")
    if n_wav is not None and n_speaking is not None and n_wav != n_speaking:
        rep.warnings.append(
            f"{sdir}: {n_wav} wavs vs {n_speaking} Speaking clips — the "
            f"200-interaction contract pairs one Speaking wav per Speaking "
            f"clip; the fusion alignment assumption may not hold"
        )
    return rep


def _verify_eeg(rep, sdir, s, channels, t_expected):
    folder = os.path.join(sdir, "EEG")
    eeg_path = os.path.join(folder, f"{s}_eeg.mat")
    label_path = os.path.join(folder, f"{s}_eeg_label.mat")
    for p in (eeg_path, label_path):
        if not os.path.isfile(p):
            rep.errors.append(f"missing {p}")
    if rep.errors:
        return
    try:
        dims = peek_mat_vars(eeg_path)
    except Exception as e:  # noqa: BLE001 — report, don't crash the walk
        rep.errors.append(f"{eeg_path}: unreadable ({e})")
        return
    var = "seg1" if "seg1" in dims else ("seg" if "seg" in dims else None)
    if var is None:
        rep.errors.append(f"{eeg_path}: no 'seg'/'seg1' variable (found {list(dims)})")
        return
    rep.info["eeg_var"] = var
    shape = dims[var]
    rep.info["eeg_shape"] = shape
    if len(shape) != 3:
        rep.errors.append(f"{eeg_path}: '{var}' is {len(shape)}-D, expected (t, ch, trials)")
        return
    t, ch, tri = shape
    if ch != channels:
        rep.errors.append(f"{eeg_path}: {ch} channels, preset expects {channels}")
    if t != t_expected:
        rep.errors.append(
            f"{eeg_path}: {t} time points/trial, preset expects {t_expected} "
            f"(trial_seconds x 500 Hz)"
        )
    if tri != 200:
        rep.warnings.append(f"{eeg_path}: {tri} trials (reference subjects have 200)")
    # labels are small (10 x trials) — full load + one-hot validation
    try:
        from eav_tpu_torch.ingest import mat5

        label = mat5.loadmat(label_path).get("label")
    except Exception as e:  # noqa: BLE001
        rep.errors.append(f"{label_path}: unreadable ({e})")
        return
    if label is None:
        rep.errors.append(f"{label_path}: no 'label' variable")
        return
    if label.ndim != 2 or label.shape[0] != 10:
        rep.errors.append(f"{label_path}: label shape {label.shape}, expected (10, trials)")
        return
    if label.shape[1] != tri:
        rep.errors.append(
            f"{label_path}: {label.shape[1]} label columns vs {tri} seg trials"
        )
    hot = (label != 0).sum(axis=0)
    if not np.all(hot == 1):
        rep.errors.append(
            f"{label_path}: {(hot != 1).sum()} trials are not one-hot"
        )
    else:
        rep.info["eeg_class_counts"] = np.bincount(
            np.argmax(label, axis=0), minlength=10
        ).tolist()


def _verify_audio(rep, sdir, trial_seconds):
    folder = os.path.join(sdir, "Audio")
    if not os.path.isdir(folder):
        rep.errors.append(f"missing {folder}")
        return
    wavs = sorted(f for f in os.listdir(folder) if f.endswith(".wav"))
    rep.info["n_wav"] = len(wavs)
    if not wavs:
        rep.errors.append(f"{folder}: no .wav files")
        return
    if len(wavs) != 100:
        rep.warnings.append(f"{folder}: {len(wavs)} wavs (reference subjects have 100)")
    srs, bad_tokens = set(), []
    for name in wavs:
        emo = _emotion_token(name)
        if emo not in KNOWN_EMOTIONS:
            bad_tokens.append(name)
            continue
        try:
            _ch, sr, n = peek_wav(os.path.join(folder, name))
        except Exception as e:  # noqa: BLE001
            rep.errors.append(f"{folder}/{name}: unreadable ({e})")
            continue
        srs.add(sr)
        dur = n / sr
        if abs(dur - trial_seconds) > 1.0:
            rep.warnings.append(
                f"{folder}/{name}: {dur:.1f} s (expected ~{trial_seconds:.0f} s)"
            )
    if bad_tokens:
        rep.errors.append(
            f"{folder}: {len(bad_tokens)} filenames without a parseable emotion "
            f"token (e.g. {bad_tokens[0]}) — `Dataload_audio.py:31` splits on "
            f"'_' and reads token 4"
        )
    rep.info["audio_sample_rates"] = sorted(srs)
    if len(srs) > 1:
        rep.info["audio_mixed_rates"] = True  # legal; loader resamples per group


def _verify_video(rep, sdir, probe, deep: bool = False):
    folder = os.path.join(sdir, "Video")
    if not os.path.isdir(folder):
        rep.errors.append(f"missing {folder}")
        return
    mp4s = sorted(f for f in os.listdir(folder) if f.endswith(".mp4"))
    speaking = [f for f in mp4s if "Speaking" in f]
    rep.info["n_mp4"] = len(mp4s)
    rep.info["n_speaking"] = len(speaking)
    if not speaking:
        rep.errors.append(f"{folder}: no Speaking .mp4 clips")
        return
    if len(speaking) != 100:
        rep.warnings.append(
            f"{folder}: {len(speaking)} Speaking clips (reference subjects have 100)"
        )
    if len(mp4s) != 200:
        rep.warnings.append(
            f"{folder}: {len(mp4s)} clips total (the 200-interaction contract "
            f"is 100 Listening + 100 Speaking, `README.md:18-19`)"
        )
    bad = [f for f in speaking if _emotion_token(f) not in KNOWN_EMOTIONS]
    if bad:
        rep.errors.append(
            f"{folder}: {len(bad)} Speaking filenames without a parseable "
            f"emotion token (e.g. {bad[0]})"
        )
    if deep:
        # walk EVERY Speaking clip's container header (no decode): a corrupt
        # clip anywhere in the archive surfaces in the gate, not hours into
        # the sweep, where the probes see three clips only
        for name in speaking:
            path = os.path.join(folder, name)
            try:
                peek_mp4_boxes(path)
            except Exception as e:  # noqa: BLE001 — report, don't crash the walk
                rep.errors.append(f"{path}: container header walk failed ({e})")
    if probe:
        # probe-decode one frame of the FIRST, MIDDLE and LAST clips:
        # codec/container problems at either end of the recording session
        # (and mid-archive, with --deep covering the rest) surface here
        from eav_tpu_torch.ingest.video import decode_strided_frames

        for i in sorted({0, len(speaking) // 2, len(speaking) - 1}):
            path = os.path.join(folder, speaking[i])
            try:
                frames = decode_strided_frames(path, stride=1, max_frames=1)
                if not len(frames):
                    rep.errors.append(f"{path}: decoded zero frames")
                else:
                    rep.info["video_frame_shape"] = tuple(np.asarray(frames[0]).shape)
            except Exception as e:  # noqa: BLE001
                rep.errors.append(f"{path}: probe decode failed ({e})")


def verify_data_root(
    data_root: str,
    subjects,
    modalities=("eeg", "audio", "vision"),
    eeg_channels: int = 30,
    trial_seconds: float = 20.0,
    probe_video: bool = True,
    deep: bool = False,
    verbose: bool = True,
) -> List[SubjectReport]:
    """Walk ``subjects`` under ``data_root`` and return per-subject reports
    (see module docstring). Zero errors across all reports == safe to launch
    the sweep against this root. ``deep``: additionally walk every Speaking
    clip's container header (peek_mp4_boxes; still no decode)."""
    reports = []
    for subject in subjects:
        rep = verify_subject(
            data_root, subject, modalities,
            eeg_channels=eeg_channels, trial_seconds=trial_seconds,
            probe_video=probe_video, deep=deep,
        )
        reports.append(rep)
        if verbose:
            status = "ok" if rep.ok else "ERROR"
            extra = ""
            if rep.warnings:
                extra = f", {len(rep.warnings)} warnings"
            print(f"[verify] subject{subject:02d}: {status}{extra}")
            for e in rep.errors:
                print(f"[verify]   error: {e}")
            for w in rep.warnings:
                print(f"[verify]   warn:  {w}")
    return reports
