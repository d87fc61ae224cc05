"""The port's vision ingest and trial votes against the JAX package's, on the
same numpy inputs: pixel values, frame flattening, center crop (and its
cv2-free resize against cv2 itself), the fast npz reader, ``DataLoadVision``
on cv2-written clips with and without MTCNN weights, and the per-trial
votes."""

import os
import sys

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


@pytest.mark.parametrize("h,w,size", [
    (480, 640, 56), (240, 320, 56), (60, 52, 24), (270, 480, 224), (112, 112, 56),
    (48, 64, 32), (40, 40, 56), (33, 47, 56), (7, 9, 24)])
def test_center_crop_and_resize_equal_cv2_without_cv2(rng, monkeypatch, h, w, size):
    """Bit for bit equal to ``cv2.resize`` (INTER_LINEAR), downscales (an
    exact 2x one, which cv2 computes as INTER_AREA, among them) and upscales
    alike, with cv2 unimportable while the port resizes."""
    cv2 = pytest.importorskip("cv2")
    from eav_tpu_torch.ingest.video import center_crop_resize, resize_frames

    frames = rng.integers(0, 256, size=(3, h, w, 3), dtype=np.uint8)
    s = min(h, w)
    y0, x0 = (h - s) // 2, (w - s) // 2
    want_crop = np.stack([cv2.resize(f[y0 : y0 + s, x0 : x0 + s], (size, size)) for f in frames])
    want_resize = np.stack([cv2.resize(f, (size, size)) for f in frames])
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 now raises
    with pytest.raises(ImportError):
        import cv2  # noqa: F401, F811
    np.testing.assert_array_equal(center_crop_resize(frames, size), want_crop)
    np.testing.assert_array_equal(resize_frames(frames, size), want_resize)


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


def _face_clips(root, emotions, seed=0):
    """Speaking clips of a drawn face (scripts/convert_mtcnn.py's fixture at
    60 x 80) moving a few pixels from frame to frame."""
    import cv2

    face = _convert_mtcnn().synthetic_face_image(60, 80)
    vdir = root / "subject01" / "Video"
    vdir.mkdir(parents=True)
    for i, emo in enumerate(emotions):
        writer = cv2.VideoWriter(str(vdir / f"subject_01_Speaking_{i}_{emo}_.mp4"),
                                 cv2.VideoWriter_fourcc(*"mp4v"), 30, (80, 60))
        for j in range(30):
            writer.write(np.roll(face, (j % 5 - 2, 2 * (j % 4) - 3), axis=(0, 1))[..., ::-1])
        writer.release()


def _convert_mtcnn():
    import importlib.util

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "convert_mtcnn", os.path.join(repo, "scripts", "convert_mtcnn.py"))
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


def _mtcnn_pt_files(path):
    """Seeded facenet-layout P/R/O-Net weights (fan-in-scaled normals) as
    ``{p,r,o}net.pt`` under ``path``."""
    from eav_tpu_torch.models import mtcnn

    for seed, (net, cls) in enumerate(zip(mtcnn.NETS, (mtcnn.PNet, mtcnn.RNet, mtcnn.ONet))):
        g = torch.Generator().manual_seed(seed + 1)
        sd = {k: torch.randn(v.shape, generator=g)
              * (1.0 / np.sqrt(np.prod(v.shape[1:])) if v.ndim >= 2 else 0.25)
              for k, v in cls().state_dict().items()}
        torch.save(sd, path / f"{net}.pt")


def test_dataload_vision_with_mtcnn_weights_matches_jax(tmp_path, monkeypatch):
    """``EAV_TPU_MTCNN_WEIGHTS`` naming facenet weights: both packages crop
    faces with MTCNN (at the JAX tests' thresholds, where random weights
    find faces), and the port's crops equal JAX's within 1."""
    pytest.importorskip("cv2")
    from eav_tpu.ingest.video import DataLoadVision as JaxDataLoadVision
    from eav_tpu_torch.ingest.video import DataLoadVision, center_crop_resize

    root = tmp_path / "EAV"
    _face_clips(root, EMOTIONS[:2])
    weights = tmp_path / "mtcnn"
    weights.mkdir()
    _mtcnn_pt_files(weights)
    monkeypatch.setenv("EAV_TPU_MTCNN_WEIGHTS", str(weights))
    kw = dict(frame_stride=6, max_frames=30, frames_per_sample=5, face_detection=True,
              face_image_size=24, mtcnn_thresholds=(0.2, 0.05, 0.05))
    x, y = DataLoadVision(1, str(root), VisionPreprocConfig(**kw), device="cpu").process()
    xj, yj = JaxDataLoadVision(1, str(root), JaxVisionPreprocConfig(**kw)).process()
    assert x.shape == xj.shape == (2, 5, 24, 24, 3) and x.dtype == np.uint8
    assert np.abs(x.astype(int) - xj.astype(int)).max() <= 1
    np.testing.assert_array_equal(y, yj)
    # the crops are MTCNN's, not the center crop the loader takes without weights
    monkeypatch.delenv("EAV_TPU_MTCNN_WEIGHTS")
    x0, _ = DataLoadVision(1, str(root), VisionPreprocConfig(**kw), device="cpu").process()
    assert (x0 != x).any(axis=(2, 3, 4)).all()


def test_dataload_vision_raises_on_mtcnn_weights_it_cannot_load(tmp_path, monkeypatch):
    """A directory named by ``EAV_TPU_MTCNN_WEIGHTS`` without weights raises
    (the JAX package center-crops); a given face_cropper runs regardless."""
    pytest.importorskip("cv2")
    from eav_tpu_torch.ingest.video import DataLoadVision

    root = tmp_path / "EAV"
    _clips(root, EMOTIONS[:1])
    monkeypatch.setenv("EAV_TPU_MTCNN_WEIGHTS", str(tmp_path / "EAV"))
    cfg = VisionPreprocConfig(max_frames=60, frames_per_sample=5, face_detection=True)
    with pytest.raises(FileNotFoundError, match="pnet"):
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
