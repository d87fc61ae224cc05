"""The port's vision ingest and trial votes against the JAX package's, on the
same numpy inputs: pixel values, frame flattening, center crop, the fast npz
reader, ``DataLoadVision`` on cv2-written clips, and the per-trial votes."""

import numpy as np
import pytest
import torch

from eav_tpu.core import metrics as JM
from eav_tpu.core.config import VisionPreprocConfig as JaxVisionPreprocConfig
from eav_tpu.ingest import npz as jax_npz
from eav_tpu.ingest import vision as JV
from eav_tpu_torch.core import metrics as M
from eav_tpu_torch.core.config import VisionPreprocConfig, get_preset
from eav_tpu_torch.ingest import vision as V
from eav_tpu_torch.ingest.npz import fast_npz_load
from eav_tpu_torch.train.pipeline import _cfg_hash

EMOTIONS = ["Neutral", "Sadness", "Anger", "Happiness", "Calmness"]


@pytest.mark.parametrize("size", [224, 64])
def test_vit_pixel_values_match_jax(rng, size):
    """56 -> 224 up and 96 -> 64 down: float32 roundoff of the resize."""
    side = 56 if size == 224 else 96
    frames = rng.integers(0, 256, size=(3, side, side, 3), dtype=np.uint8)
    want = np.asarray(JV.vit_pixel_values(frames, size=size))
    got = V.vit_pixel_values(frames, size=size, device="cpu")
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    host = V.preprocess_frames(frames, size=size, batch=2, device="cpu")
    np.testing.assert_allclose(host, JV.preprocess_frames(frames, size=size, batch=2),
                               rtol=1e-5, atol=1e-5)


def test_flatten_trials_to_frames_matches_jax(rng):
    x = rng.integers(0, 256, size=(4, 5, 8, 8, 3), dtype=np.uint8)
    y = np.array([2, 0, 4, 1], np.int32)
    for got, want in zip(V.flatten_trials_to_frames(x, y), JV.flatten_trials_to_frames(x, y)):
        np.testing.assert_array_equal(got, want)


def test_center_crop_and_resize_match_jax(rng):
    pytest.importorskip("cv2")
    from eav_tpu.ingest.video import center_crop_resize as jax_ccr
    from eav_tpu.ingest.video import resize_frames as jax_resize
    from eav_tpu_torch.ingest.video import center_crop_resize, resize_frames

    frames = rng.integers(0, 256, size=(3, 48, 64, 3), dtype=np.uint8)
    np.testing.assert_array_equal(center_crop_resize(frames, 56), jax_ccr(frames, 56))
    np.testing.assert_array_equal(resize_frames(frames, 32), jax_resize(frames, 32))


def test_fast_npz_load_matches_jax(tmp_path, rng):
    path = str(tmp_path / "c.npz")
    x = rng.integers(0, 256, size=(3, 2, 4, 4, 3), dtype=np.uint8)
    y = np.arange(3, dtype=np.int32)
    np.savez(path, x=x, y=y)
    got, want = fast_npz_load(path), jax_npz.fast_npz_load(path)
    assert got.keys() == want.keys() == {"x", "y"}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert not got[k].flags.writeable  # zero-copy views of the mmap


def test_vision_config_hash_is_the_jax_cache_key():
    """A frame cache written by either package is found by the other."""
    cfg = get_preset("vit_finetune").vision
    assert _cfg_hash(cfg) == _cfg_hash(JaxVisionPreprocConfig(face_detection=True))
    assert _cfg_hash(VisionPreprocConfig()) == _cfg_hash(JaxVisionPreprocConfig())


def _write_mp4(path, n_frames=60, h=48, w=64, value_step=4):
    import cv2

    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 30, (w, h))
    assert writer.isOpened()
    for i in range(n_frames):
        writer.write(np.full((h, w, 3), min(255, i * value_step), np.uint8))
    writer.release()


def _clips(root, emotions):
    vdir = root / "subject01" / "Video"
    vdir.mkdir(parents=True)
    for i, emo in enumerate(emotions):
        _write_mp4(vdir / f"subject_01_Speaking_{i}_{emo}_.mp4")
        _write_mp4(vdir / f"subject_01_Listening_{i}_{emo}_.mp4")  # ignored


@pytest.mark.parametrize("face_detection", [False, True])
def test_dataload_vision_matches_jax(tmp_path, monkeypatch, face_detection):
    pytest.importorskip("cv2")
    from eav_tpu.ingest.video import DataLoadVision as JaxDataLoadVision
    from eav_tpu_torch.ingest.video import DataLoadVision

    monkeypatch.delenv("EAV_TPU_MTCNN_WEIGHTS", raising=False)
    root = tmp_path / "EAV"
    _clips(root, EMOTIONS[:2])
    kw = dict(frame_stride=6, max_frames=60, frames_per_sample=5, image_size=32,
              face_detection=face_detection, face_image_size=24)
    x, y = DataLoadVision(1, str(root), VisionPreprocConfig(**kw), device="cpu").process()
    xj, yj = JaxDataLoadVision(1, str(root), JaxVisionPreprocConfig(**kw)).process()
    side = 24 if face_detection else 32
    assert x.shape == (4, 5, side, side, 3) and x.dtype == np.uint8
    assert y.tolist() == [0, 0, 1, 1]
    np.testing.assert_array_equal(x, xj)
    np.testing.assert_array_equal(y, yj)


def test_dataload_vision_refuses_mtcnn_weights(tmp_path, monkeypatch):
    """With MTCNN weights named, the JAX package would detect faces: the port
    raises instead of cropping otherwise. A given face_cropper still runs."""
    pytest.importorskip("cv2")
    from eav_tpu_torch.ingest.video import DataLoadVision

    root = tmp_path / "EAV"
    _clips(root, EMOTIONS[:1])
    monkeypatch.setenv("EAV_TPU_MTCNN_WEIGHTS", str(tmp_path))
    cfg = VisionPreprocConfig(max_frames=60, frames_per_sample=5, face_detection=True)
    with pytest.raises(NotImplementedError, match="slice 6"):
        DataLoadVision(1, str(root), cfg, device="cpu").process()
    crop = lambda f: np.zeros((len(f), 8, 8, 3), np.uint8)  # noqa: E731
    x, _ = DataLoadVision(1, str(root), cfg, face_cropper=crop, device="cpu").process()
    assert x.shape == (2, 5, 8, 8, 3)


def test_trial_votes_match_jax(rng):
    logits = rng.normal(size=(23, 5)).astype(np.float32)  # 4 trials of 5, 3 rows left over
    tl, pred = M.trial_vote(logits, 5)
    tl_j, pred_j = JM.trial_vote(logits, 5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(tl_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(pred.numpy(), np.asarray(pred_j))
    np.testing.assert_array_equal(M.trial_majority_vote(logits, 5, 5).numpy(),
                                  np.asarray(JM.trial_majority_vote(logits, 5, 5)))


def test_majority_vote_ties_go_to_the_smallest_class():
    """Frame votes 3,1,3,1,2,2 and 4,0,4,0,2,2 (three classes with two votes
    each): the smallest class wins, in both packages."""
    def onehot(classes):
        return np.eye(5, dtype=np.float32)[classes]

    logits = np.concatenate([onehot([3, 1, 3, 1, 2, 2]), onehot([4, 0, 4, 0, 2, 2])])
    got = M.trial_majority_vote(logits, 6, 5).tolist()
    assert got == np.asarray(JM.trial_majority_vote(logits, 6, 5)).tolist() == [1, 0]
