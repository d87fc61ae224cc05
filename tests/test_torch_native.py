"""The port's native ingest library (``eav_tpu_torch/csrc/eav_ingest.cc``
through ``eav_tpu_torch/ingest/native.py``) against the port's pure-Python
readers and the JAX package's native library (``tests/test_native.py``'s
checks): WAV in four encodings, ``.mat`` compressed and not, the second
compressed variable that the JAX package's C++ reader loses, the libav MP4
decoder against JAX's and cv2's, the prefetch queue, the EEG and audio
loaders on both backends, and the build (an edited source builds anew, a
failed compile raises). Exact equality where both sides convert the same
bytes the same way; the MP4 decoders at ``tests/test_native.py``'s
tolerance against cv2."""

import struct
import sys

import numpy as np
import pytest
import scipy.io
import torch

from eav_tpu.ingest import native as jax_native
from eav_tpu_torch.core.config import EEGPreprocConfig
from eav_tpu_torch.ingest import mat5, native, video
from eav_tpu_torch.ingest.audio import DataLoadAudio
from eav_tpu_torch.ingest.eeg import DataLoadEEG
from eav_tpu_torch.ingest.wav import read_wav, write_wav
from eav_tpu_torch.ops import build


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _riff(path, fmt_tag, bits, channels, rate, payload: bytes) -> None:
    block = channels * bits // 8
    fmt = struct.pack("<HHIIHH", fmt_tag, channels, rate, rate * block, block, bits)
    body = b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
    body += b"data" + struct.pack("<I", len(payload)) + payload
    if len(payload) % 2:
        body += b"\x00"
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)


def _wav(path, encoding: str, x: np.ndarray, rate: int) -> None:
    """``x`` (samples, channels) in [-1, 1] written interleaved."""
    ch = x.shape[1]
    if encoding == "pcm16":
        _riff(path, 1, 16, ch, rate, (x * 32767).astype("<i2").tobytes())
    elif encoding == "pcm24":
        v = (x * (2**23 - 1)).astype("<i4").reshape(-1)
        raw = np.stack([(v >> s) & 0xFF for s in (0, 8, 16)], -1).astype(np.uint8)
        _riff(path, 1, 24, ch, rate, raw.tobytes())
    elif encoding == "pcm32":
        _riff(path, 1, 32, ch, rate, (x * (2**31 - 1)).astype("<i4").tobytes())
    else:
        _riff(path, 3, 32, ch, rate, x.astype("<f4").tobytes())


@pytest.mark.parametrize("encoding", ["pcm16", "pcm24", "pcm32", "float32"])
def test_wav_matches_python_and_jax(tmp_path, rng, encoding):
    x = np.clip(rng.normal(size=(777, 2)) * 0.3, -1, 1)
    p = str(tmp_path / "t.wav")
    _wav(p, encoding, x, 22050)
    ours, sr = native.read_wav(p)
    ref, sr_ref = read_wav(p)
    theirs, sr_jax = jax_native.read_wav(p)
    assert sr == sr_ref == sr_jax == 22050 and ours.shape == (2, 777)
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-7)


@pytest.mark.parametrize("compressed", [False, True])
def test_mat_matches_python_and_jax(tmp_path, rng, compressed):
    p = str(tmp_path / "t.mat")
    seg = rng.normal(size=(100, 6, 4))
    small = rng.normal(size=(7, 3)).astype(np.float32)
    label = rng.integers(0, 2, size=(10, 4)).astype(np.uint8)
    scipy.io.savemat(p, {"seg": seg, "seg1": small, "label": label}, do_compression=compressed)
    py = mat5.loadmat(p)
    for name, want in (("seg", seg), ("seg1", small), ("label", label)):
        got = native.read_mat_var(p, name)
        assert got.dtype == np.float64 and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want.astype(np.float64))
        np.testing.assert_array_equal(got, py[name])
    # the JAX package's reader agrees where it can read: the first variable
    np.testing.assert_array_equal(native.read_mat_var(p, "seg"), jax_native.read_mat_var(p, "seg"))
    with pytest.raises(IOError, match="not found"):
        native.read_mat_var(p, "nope")


def test_second_compressed_variable_reads_where_jax_loses_it(tmp_path):
    """``eav_tpu/ingest/cpp/eav_ingest.cc:197`` pads every element to 8
    bytes, compressed ones too, so the JAX reader walks past the second
    compressed variable; the port's copy does not pad miCOMPRESSED
    elements."""
    p = str(tmp_path / "two.mat")
    a, b = np.array([[3.0, 5.0]]), np.arange(6.0).reshape(2, 3)
    scipy.io.savemat(p, {"a": a, "b": b}, do_compression=True)
    np.testing.assert_array_equal(native.read_mat_var(p, "a"), a)
    np.testing.assert_array_equal(native.read_mat_var(p, "b"), b)
    np.testing.assert_array_equal(jax_native.read_mat_var(p, "a"), a)
    with pytest.raises(IOError, match="variable not found: b"):
        jax_native.read_mat_var(p, "b")


def test_truncated_and_foreign_files_raise(tmp_path, rng):
    p = str(tmp_path / "t.mat")
    scipy.io.savemat(p, {"seg": rng.normal(size=(50, 4))}, do_compression=True)
    raw = open(p, "rb").read()
    cut = tmp_path / "cut.mat"
    cut.write_bytes(raw[: len(raw) // 2])
    with pytest.raises(IOError):
        native.read_mat_var(str(cut), "seg")
    with pytest.raises(IOError, match="RIFF"):
        native.read_wav(p)


def test_prefetcher_returns_every_file_once(tmp_path, rng):
    """Completion order is the threads'; every submitted path comes back
    once with ``read_wav``'s waveform and rate, and a bad file raises with
    its path."""
    paths = []
    for i in range(9):
        p = str(tmp_path / f"{i}.wav")
        write_wav(p, (rng.normal(size=(1 + i % 2, 3000 + 17 * i)) * 0.1).astype(np.float32),
                  16000 if i % 3 else 22050)
        paths.append(p)
    with native.WavPrefetcher(n_threads=3) as pf:
        for p in paths:
            pf.submit(p)
        got = {}
        for path, wave, sr in pf:
            assert path not in got
            got[path] = (wave, sr)
    assert set(got) == set(paths)
    for p in paths:
        ref, sr = read_wav(p)
        assert got[p][1] == sr
        np.testing.assert_array_equal(got[p][0], ref)
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"not a wav")
    with native.WavPrefetcher(n_threads=1) as pf:
        pf.submit(str(bad))
        with pytest.raises(IOError, match="bad.wav"):
            pf.pop()


def _eeg_subject(root, rng, key="seg"):
    sdir = root / "subject01" / "EEG"
    sdir.mkdir(parents=True)
    scipy.io.savemat(str(sdir / "subject01_eeg.mat"), {key: rng.normal(size=(4000, 6, 5))})
    label = np.zeros((10, 5))
    label[(2 * np.arange(5) + 1) % 10, np.arange(5)] = 1
    scipy.io.savemat(str(sdir / "subject01_eeg_label.mat"), {"label": label})


def _audio_subject(root, rng):
    adir = root / "subject01" / "Audio"
    adir.mkdir(parents=True)
    for i, emo in enumerate(["Neutral", "Sadness", "Anger", "Happiness", "Calmness", "Anger"]):
        sr = 32000 if i % 2 else 16000  # two rate groups, resampled apart
        write_wav(str(adir / f"subject_01_Speaking_{i}_{emo}_.wav"),
                  0.1 * rng.normal(size=10 * sr), sr)


@pytest.mark.parametrize("key", ["seg", "seg1"])
def test_loaders_equal_on_both_backends(tmp_path, rng, monkeypatch, key):
    """``DataLoadEEG`` (``seg1`` tried before ``seg``) and the audio
    ``process`` (the native queue, back in dataset order) give the arrays
    of the pure-Python readers."""
    _eeg_subject(tmp_path, rng, key)
    _audio_subject(tmp_path, rng)
    cfg = EEGPreprocConfig(channels=6, trial_seconds=8.0, chunk_seconds=2.0)

    def load():
        eeg = DataLoadEEG(1, cfg, str(tmp_path), device="cpu").prepare_data()
        aud = DataLoadAudio(1, str(tmp_path), device="cpu").process()
        return eeg + aud

    with_native = load()
    monkeypatch.setattr(native, "available", lambda: False)
    with_python = load()
    assert with_native[0].shape == (20, 6, 200) and with_native[2].shape == (12, 80000)
    for a, b in zip(with_native, with_python):
        np.testing.assert_array_equal(a, b)


def _write_clip(path, frames=60, h=120, w=160):
    import cv2

    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 30, (w, h))
    yy, xx = np.mgrid[0:h, 0:w]
    for f in range(frames):
        img = np.stack([(xx * 2 + f * 4) % 256, (yy * 2) % 256, ((xx + yy) + f * 2) % 256],
                       axis=-1).astype(np.uint8)
        vw.write(img)
    vw.release()


def test_mp4_matches_jax_native_and_cv2(tmp_path):
    """The libav decoder equals the JAX package's (the same source) bit for
    bit, and cv2's grab loop at ``tests/test_native.py``'s tolerance (both
    run ffmpeg; swscale may round differently). ``'auto'`` takes it."""
    assert native.mp4_supported(), "this host's build has libav"
    p = str(tmp_path / "clip.mp4")
    _write_clip(p)
    ours = np.stack(video.decode_strided_frames(p, 6, 60, backend="native"))
    np.testing.assert_array_equal(ours, jax_native.read_mp4_strided(p, 6, 60))
    np.testing.assert_array_equal(np.stack(video.decode_strided_frames(p, 6, 60)), ours)
    ref = np.stack(video.decode_strided_frames(p, 6, 60, backend="cv2"))
    assert ours.shape == ref.shape == (10, 120, 160, 3)
    diff = np.abs(ours.astype(int) - ref.astype(int))
    assert diff.mean() < 1.0 and np.percentile(diff, 99) <= 4
    assert len(video.decode_strided_frames(p, 7, 20, backend="native")) == 3  # 0, 7, 14


_FILL = """
import sys
from concurrent.futures import ThreadPoolExecutor
import numpy as np
sys.path.insert(0, sys.argv[1])
from eav_tpu_torch.ingest import native
path = sys.argv[2]
with ThreadPoolExecutor(8) as ex:
    outs = list(ex.map(lambda _: native.read_mp4_strided(path, 6, 60), range(200)))
big = native.read_mp4_strided(path, 6, 600)
assert big.shape == (10, 32, 40, 3), big.shape
assert all(np.array_equal(o, big) for o in outs)
print("FILLED")
"""


def test_mp4_frames_that_fill_the_buffer_stay_inside_it(tmp_path):
    """A 40-pixel-wide clip whose kept frames fill the buffer exactly
    (60 frames at stride 6, ``max_frames`` 60): swscale's row writers store
    past an unpadded RGB24 row, and the JAX package's decoder, converting
    straight into the buffer, corrupts the heap there (it aborts within
    200 decodes, PERF.md). The port's converts through a padded scratch
    image. In a child process, so that a fault fails this test alone."""
    import subprocess

    p = tmp_path / "narrow.mp4"
    _write_clip(p, frames=60, h=32, w=40)
    out = subprocess.run([sys.executable, "-c", _FILL, str(build.PACKAGE_DIR.parent), str(p)],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and "FILLED" in out.stdout, out.stderr[-2000:]


def test_mp4_errors_raise_without_falling_back(tmp_path, monkeypatch):
    bad = tmp_path / "bad.mp4"
    bad.write_bytes(b"\x00\x00\x00\x18ftypisom" + b"\x00" * 64)
    with pytest.raises(IOError):
        native.read_mp4_strided(str(bad), 6, 60)
    with pytest.raises(IOError):  # 'auto' takes libav and raises: no retry with cv2
        video.decode_strided_frames(str(bad))
    with pytest.raises(ValueError, match="backend"):
        video.decode_strided_frames(str(bad), backend="ffmpeg")
    monkeypatch.setattr(native, "mp4_supported", lambda: False)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="no video decoder"):
        video.decode_strided_frames(str(bad))


def test_verify_probe_decodes_natively_without_cv2(tmp_path, monkeypatch):
    """On a machine without cv2 the data check's video probe goes
    through the native decoder."""
    from eav_tpu_torch.ingest.verify import verify_data_root

    vdir = tmp_path / "subject01" / "Video"
    vdir.mkdir(parents=True)
    _write_clip(vdir / "subject_01_Speaking_1_Anger_.mp4", frames=12, h=48, w=64)
    monkeypatch.setitem(sys.modules, "cv2", None)
    (rep,) = verify_data_root(str(tmp_path), [1], modalities=("vision",), verbose=False)
    assert not [e for e in rep.errors if "probe" in e], rep.errors
    assert rep.info["video_frame_shape"] == (48, 64, 3)


def test_edited_source_builds_anew_and_a_failed_compile_raises(tmp_path, monkeypatch):
    import ctypes

    monkeypatch.setattr(build, "CSRC_DIR", tmp_path / "csrc")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "csrc").mkdir()
    src = tmp_path / "csrc" / "probe.cc"
    src.write_text('extern "C" int probe() { return 1; }\n')
    first = build.build("probe")
    assert first.name.startswith("libprobe-") and build.build("probe") == first
    assert ctypes.CDLL(str(first)).probe() == 1
    src.write_text('extern "C" int probe() { return 2; }\n')
    second = build.build("probe")
    assert second != first and first.exists()
    assert ctypes.CDLL(str(second)).probe() == 2
    src.write_text('extern "C" int probe() { return }\n')
    with pytest.raises(RuntimeError, match=r"(?s)g\+\+ probe.cc failed .*error: expected"):
        build.build("probe")
    assert not list((tmp_path / "build").glob("*.tmp"))


def test_committed_fixture_decodes_to_its_stored_frames():
    """The CPU lane of ``chip_smoke.py``'s native-ingest phase: the
    committed clip decodes to the cv2 frames stored beside it, at
    ``tests/test_native.py``'s tolerance."""
    from eav_tpu_torch.scripts.make_video_fixture import FIXTURES, FRAMES, STRIDE

    got = native.read_mp4_strided(str(FIXTURES / "clip.mp4"), STRIDE, FRAMES)
    want = np.load(FIXTURES / "clip_frames.npz")["frames"]
    assert got.shape == want.shape == (10, 48, 64, 3)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.mean() < 1.0 and np.percentile(diff, 99) <= 4
