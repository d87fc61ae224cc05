"""The port's data verifier (``eav_tpu_torch/ingest/verify.py``) against the
JAX package's on the synthetic tree of ``tests/test_verify_data.py`` and
each of its corruptions, the video probe decoding through each package's
native libav decoder on the CPU: the header peeks, every report (errors,
warnings, info) equal, and the ``verify-data`` exit codes of both CLIs."""

import json
import re

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from eav_tpu import cli as jax_cli  # noqa: E402
from eav_tpu.ingest import verify as jax_verify  # noqa: E402
from eav_tpu_torch import cli  # noqa: E402
from eav_tpu_torch.ingest import mat5, verify  # noqa: E402
from eav_tpu_torch.ingest.wav import write_wav  # noqa: E402

from test_pipeline_e2e import CH, T500, _make_subject  # noqa: E402

TRIAL_SECONDS = T500 / 500.0


@pytest.fixture()
def tree(tmp_path):
    _make_subject(tmp_path, np.random.default_rng(0), subject=1)
    return tmp_path


def _plain(rep):
    """A report as JSON values (the info's tuples become lists). A probe's
    decode error keeps its path and drops the decoder's reason: where libav
    fails on a clip, the port raises libav's error and the JAX package
    retries the clip with cv2 and reports cv2's."""
    errors = [re.sub(r"probe decode failed \(.*\)$", "probe decode failed", e)
              for e in rep.errors]
    return json.loads(json.dumps({"subject": rep.subject, "ok": rep.ok, "errors": errors,
                                  "warnings": rep.warnings, "info": rep.info}))


def _both(root, subject=1, **kw):
    kw.setdefault("eeg_channels", CH)
    kw.setdefault("trial_seconds", TRIAL_SECONDS)
    got = verify.verify_subject(str(root), subject, **kw)
    want = jax_verify.verify_subject(str(root), subject, **kw)
    assert _plain(got) == _plain(want)
    return got


def test_peeks_equal_jax(tmp_path):
    import scipy.io

    a = np.arange(24, dtype=np.float64).reshape(2, 3, 4)
    mat5.savemat(str(tmp_path / "u.mat"), {"seg": a, "label": np.ones((10, 200))})
    scipy.io.savemat(str(tmp_path / "c.mat"), {"seg1": a, "x": np.ones(3)}, do_compression=True)
    for name in ("u.mat", "c.mat"):
        got = verify.peek_mat_vars(str(tmp_path / name))
        assert got == jax_verify.peek_mat_vars(str(tmp_path / name)) and got
    write_wav(str(tmp_path / "a.wav"), np.zeros(3 * 16000, np.float32), 16000)
    assert verify.peek_wav(str(tmp_path / "a.wav")) == (1, 16000, 3 * 16000)
    assert verify.peek_wav(str(tmp_path / "a.wav")) == jax_verify.peek_wav(str(tmp_path / "a.wav"))
    (tmp_path / "b.wav").write_bytes(b"RIFX" + bytes(40))
    with pytest.raises(ValueError, match="RIFF"):
        verify.peek_wav(str(tmp_path / "b.wav"))


def test_clean_tree_reports_equal_jax(tree):
    rep = _both(tree, deep=True)
    assert rep.ok and rep.info["eeg_shape"] == (T500, CH, 20)
    assert rep.info["n_wav"] == rep.info["n_speaking"] == 5
    assert "video_frame_shape" in rep.info
    clip = sorted((tree / "subject01" / "Video").iterdir())[0]
    assert verify.peek_mp4_boxes(str(clip)) == jax_verify.peek_mp4_boxes(str(clip))


def _corrupt(tree, kind):
    s = tree / "subject01"
    if kind == "non_one_hot":
        path = s / "EEG" / "subject01_eeg_label.mat"
        label = mat5.loadmat(str(path))["label"].copy()
        label[:, 0] = 0
        mat5.savemat(str(path), {"label": label})
    elif kind == "audio_name":
        wav = next((s / "Audio").glob("*.wav"))
        (s / "Audio" / "bad.wav").write_bytes(wav.read_bytes())
    elif kind == "wav_count":
        sorted((s / "Audio").glob("*.wav"))[0].unlink()
    elif kind in ("middle_clip_truncated", "header_garbage"):
        speaking = sorted(f for f in (s / "Video").iterdir() if "Speaking" in f.name)
        clip = speaking[2] if kind == "middle_clip_truncated" else speaking[1]
        data = clip.read_bytes()
        clip.write_bytes(data[: len(data) // 4] if kind == "middle_clip_truncated"
                         else b"\xde\xad\xbe\xef" * 64 + data[256:])
    elif kind == "missing_label":
        (s / "EEG" / "subject01_eeg_label.mat").unlink()


@pytest.mark.parametrize("kind,deep,caught", [
    ("channels", False, "channels"),
    ("non_one_hot", False, "one-hot"),
    ("audio_name", False, "emotion"),
    ("wav_count", False, None),
    ("middle_clip_truncated", False, "probe decode failed"),
    ("header_garbage", False, None),
    ("header_garbage", True, "header walk"),
    ("missing_label", False, "missing"),
    ("missing_subject", False, "missing subject folder"),
])
def test_corrupted_tree_reports_equal_jax(tree, kind, deep, caught):
    """Each corruption of ``tests/test_verify_data.py``: the same report in
    both packages, and the error it must raise (``None``: a clean report,
    the non-probed clip seen only by ``deep``; the wav count only warns)."""
    _corrupt(tree, kind)
    kw = {"eeg_channels": 30} if kind == "channels" else {}
    rep = _both(tree, 7 if kind == "missing_subject" else 1, deep=deep, **kw)
    if caught is None:
        assert rep.ok, rep.errors
    else:
        assert any(caught in e for e in rep.errors), rep.errors
    if kind == "wav_count":
        assert any("Speaking clip" in w for w in rep.warnings)


def test_verify_data_cli_exit_codes_equal_jax(tree, capsys):
    args = ["verify-data", "--data-root", str(tree), "--subjects", "1",
            "--set", f"eeg.eeg.channels={CH}", "--set", f"eeg.eeg.trial_seconds={TRIAL_SECONDS}"]
    for extra, rc in (([], 0), (["--no-probe"], 0), (["--deep"], 0), (["--subjects", "1,2"], 1)):
        assert cli.main([*args, *extra]) == rc
        got = capsys.readouterr().out
        assert jax_cli.main([*args, *extra]) == rc
        assert got == capsys.readouterr().out
    assert "subject01: ok" in got
    _corrupt(tree, "non_one_hot")
    assert cli.main([*args, "--no-probe"]) == jax_cli.main([*args, "--no-probe"]) == 1


def test_no_probe_reads_no_video(tree, monkeypatch):
    """``probe_video=False`` decodes nothing (for a machine without a decoder):
    a decoder that raises is never called."""
    import eav_tpu_torch.ingest.video as video

    def boom(*a, **k):
        raise AssertionError("decoded")

    monkeypatch.setattr(video, "decode_strided_frames", boom)
    rep = verify.verify_subject(str(tree), 1, eeg_channels=CH, trial_seconds=TRIAL_SECONDS,
                                probe_video=False)
    assert rep.ok and "video_frame_shape" not in rep.info
    rep = verify.verify_subject(str(tree), 1, eeg_channels=CH, trial_seconds=TRIAL_SECONDS)
    assert any("probe decode failed (decoded)" in e for e in rep.errors)
