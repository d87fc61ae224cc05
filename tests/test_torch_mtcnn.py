"""The port's MTCNN (``eav_tpu_torch/models/mtcnn.py``) against the JAX
package's (``eav_tpu/models/mtcnn.py``), on the same facenet-layout weights:
the JAX nets get them through ``convert_facenet_state_dict``, the port's
through ``bridge.mtcnn_params_from_jax`` of the JAX trees (and, separately,
straight from ``.pt`` files). Frames are the JAX tests' 60 x 52; thresholds
the JAX tests' (0.2, 0.05, 0.05), at which random weights find faces.

Tolerances: the nets to rtol 1e-4 / atol 1e-5; boxes to atol 0.02 and
probabilities to 1e-4; uint8 crops within 1.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from eav_tpu.models import mtcnn as J
from eav_tpu_torch.models import mtcnn as P
from eav_tpu_torch.models.bridge import mtcnn_params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NET_CLASSES = {"pnet": P.PNet, "rnet": P.RNet, "onet": P.ONet}
THRESHOLDS = (0.2, 0.05, 0.05)


def _facenet_state_dict(net: str, seed: int) -> dict:
    """Fan-in-scaled normals, drawn as tests/test_mtcnn_oracle.py's
    ``_rand_state_dict`` draws them (a torch generator over facenet's keys,
    which the port's nets share in order)."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in NET_CLASSES[net]().state_dict().items():
        scale = 1.0 / np.sqrt(np.prod(v.shape[1:])) if v.ndim >= 2 else 0.25
        out[k] = torch.randn(v.shape, generator=g) * scale
    return out


def _weights(seeds=(1, 2, 3)):
    """(facenet state dicts, JAX trees, the port's state dicts from the JAX
    trees) of the three nets."""
    sds = tuple(_facenet_state_dict(n, s) for n, s in zip(P.NETS, seeds))
    trees = tuple(J.convert_facenet_state_dict(n, sd) for n, sd in zip(P.NETS, sds))
    ported = tuple(mtcnn_params_from_jax(n, t) for n, t in zip(P.NETS, trees))
    return sds, trees, ported


def _frames(seed=11, n=6):
    return np.random.default_rng(seed).integers(0, 256, size=(n, 60, 52, 3)).astype(np.uint8)


@pytest.fixture(scope="module")
def cascades():
    """The two detectors on the same weights, and JAX's batched results."""
    _, trees, ported = _weights()
    jd = J.MTCNNDetector(*trees, thresholds=THRESHOLDS)
    pd = P.MTCNNDetector(*ported, thresholds=THRESHOLDS, device="cpu")
    frames = _frames()
    return jd, pd, frames, jd.detect_batched(frames), jd.crop_faces_batched(frames, 0.0)


def _assert_dets_close(got, want):
    hits = 0
    for (gb, gp), (wb, wp) in zip(got, want, strict=True):
        assert (gb is None) == (wb is None)
        if wb is not None:
            hits += 1
            np.testing.assert_allclose(gb, wb, rtol=0, atol=0.02)
            assert abs(gp - wp) < 1e-4
    assert hits > 0, "no frame produced a detection"


def test_bridge_gives_the_facenet_state_dict():
    """Flax trees -> the port's state dicts are the facenet dicts they came
    from, exactly: the conv and dense transposes and the first dense layer's
    (C, H, W) -> (W, H, C) permutation undo JAX's converter."""
    sds, _, ported = _weights()
    for sd, got in zip(sds, ported):
        assert got.keys() == sd.keys()
        for k in sd:
            torch.testing.assert_close(got[k], sd[k], rtol=0, atol=0)


@pytest.mark.parametrize("net,shape", [("pnet", (2, 30, 26)), ("rnet", (3, 24, 24)),
                                       ("onet", (3, 48, 48))])
def test_nets_match_jax(net, shape):
    _, trees, ported = _weights()
    i = P.NETS.index(net)
    x = np.random.default_rng(i).normal(size=shape + (3,)).astype(np.float32)
    want = getattr(J, net[0].upper() + "Net")().apply({"params": trees[i]}, jnp.asarray(x))
    model = NET_CLASSES[net]()
    model.load_state_dict(ported[i])
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.numpy()
        if g.ndim == 4:  # P-Net's maps: NCHW -> NHWC
            g = g.transpose(0, 2, 3, 1)
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-5)


def _pool_sizes():
    """(h, w, window, stride) of every max pool the cascade runs: P-Net's at
    each pyramid scale of 640 x 480, 480 x 270 and 52 x 60 frames, and the
    fixed ones of R-Net and O-Net."""
    det = P.MTCNNDetector(*_weights()[2], device="cpu")
    sizes = {(hs - 2, ws - 2, 2, 2) for h, w in ((480, 640), (270, 480), (60, 52))
             for _, hs, ws in det._pyramid(h, w)}
    return sorted(sizes | {(22, 22, 3, 2), (10, 10, 3, 2), (46, 46, 3, 2), (20, 20, 3, 2),
                           (8, 8, 2, 2)})


def test_ceil_pooling_matches_jax_on_every_cascade_size():
    sizes = _pool_sizes()
    assert len(sizes) > 25
    rng = np.random.default_rng(0)
    for h, w, window, stride in sizes:
        x = rng.normal(size=(1, h, w, 2)).astype(np.float32)
        want = np.asarray(J._pool_ceil(jnp.asarray(x), window, stride))
        got = F.max_pool2d(torch.from_numpy(x).permute(0, 3, 1, 2), window, stride, ceil_mode=True)
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_resize_weight_matrix_is_the_jax_map():
    for in_size, out_size in ((7, 24), (50, 24), (24, 24), (3, 48), (113, 56), (1, 12)):
        np.testing.assert_array_equal(P.resize_weight_matrix(in_size, out_size),
                                      J.resize_weight_matrix(in_size, out_size))


def test_clamp_boxes_is_the_jax_clamp():
    """Row by row ``_clamp_box``: halves rounded to even, boxes before,
    across and past every edge of a 60 x 52 frame."""
    rng = np.random.default_rng(3)
    boxes = np.concatenate([rng.uniform(-20, 80, (400, 4)),
                            np.round(rng.uniform(-20, 80, (200, 4))) + 0.5]).astype(np.float32)
    want = np.array([J._clamp_box(b, 60, 52) for b in boxes])
    np.testing.assert_array_equal(P._clamp_boxes(boxes, 60, 52), want)
    np.testing.assert_array_equal(P._nonempty(boxes, 60, 52),
                                  (want[:, 2] > want[:, 0]) & (want[:, 3] > want[:, 1]))


def test_stage1_matches_jax_per_frame(cascades):
    """The per-frame pyramid (one resize and P-Net call a scale) and the
    stage-1 NMS and regression."""
    jd, pd, frames, _, _ = cascades
    for frame in frames[:3]:
        want = jd._stage1(frame)
        got = pd._stage1(torch.from_numpy(frame))
        assert got.shape == want.shape and len(want) > 0
        np.testing.assert_allclose(got[:, :4], want[:, :4], rtol=0, atol=0.02)
        np.testing.assert_allclose(got[:, 4], want[:, 4], rtol=0, atol=1e-4)


def test_detect_batched_matches_jax(cascades):
    jd, pd, frames, want, _ = cascades
    _assert_dets_close(pd.detect_batched(frames), want)


def test_detect_matches_jax(cascades):
    """The port's per-frame cascade against JAX's batched one (which JAX's own
    tests hold to its per-frame cascade at these tolerances; that one
    compiles a program per crop size, about 12 s a frame)."""
    jd, pd, frames, want, _ = cascades
    _assert_dets_close([pd.detect(f) for f in frames], want)


def test_crop_faces_match_jax(cascades):
    jd, pd, frames, _, want = cascades
    for got in (pd.crop_faces_batched(frames, 0.0), pd.crop_faces(frames, 0.0)):
        assert got.shape == want.shape == (6, 56, 56, 3) and got.dtype == np.uint8
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_crop_chunk_of_two_equals_unchunked(cascades):
    _, pd, frames, _, _ = cascades
    ref_det, ref_crops = pd.detect_batched(frames), pd.crop_faces_batched(frames, 0.0)
    pd.crop_chunk = 2
    try:
        got_det, got_crops = pd.detect_batched(frames), pd.crop_faces_batched(frames, 0.0)
    finally:
        pd.crop_chunk = P.MTCNNDetector.crop_chunk
    for (rb, rp), (gb, gp) in zip(ref_det, got_det):
        assert (rb is None) == (gb is None)
        if rb is not None:
            np.testing.assert_allclose(gb, rb, rtol=1e-5, atol=1e-4)
            assert abs(gp - rp) < 1e-5
    np.testing.assert_array_equal(ref_crops, got_crops)


def _convert_mtcnn():
    """scripts/convert_mtcnn.py as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "convert_mtcnn", os.path.join(REPO, "scripts", "convert_mtcnn.py"))
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


def test_load_mtcnn_params_from_pt_and_from_the_converter(tmp_path):
    """facenet ``.pt`` files and the npz that scripts/convert_mtcnn.py writes
    from them load to the same state dicts, equal to the ones saved."""
    sds, _, _ = _weights()
    src, out = tmp_path / "pt", tmp_path / "npz"
    src.mkdir()
    for net, sd in zip(P.NETS, sds):
        torch.save(sd, src / f"{net}.pt")
    assert _convert_mtcnn().main(["--src", str(src), "--out", str(out)]) == 0
    for sd, from_pt, from_npz in zip(sds, P.load_mtcnn_params(str(src)),
                                     P.load_mtcnn_params(str(out))):
        assert from_pt.keys() == from_npz.keys() == sd.keys()
        for k in sd:
            torch.testing.assert_close(from_pt[k], sd[k], rtol=0, atol=0)
            torch.testing.assert_close(from_npz[k], sd[k], rtol=0, atol=0)
    with pytest.raises(FileNotFoundError, match="pnet"):
        P.load_mtcnn_params(str(tmp_path))


def test_a_box_past_the_frame_crashes_jax_and_is_dropped_by_the_port():
    """The oracle's seeds 500 / 17 / 999 at the preset thresholds put
    stage-1 boxes at and past the right edge of the 320-wide face fixture
    (JAX's ``detect_batched`` raises on them). A box whose left edge rounds
    to the frame's width has a zero-width crop, and JAX's crop weights
    divide by zero; one further right gets all-zero weights, a black crop
    that JAX scores like any other. The port drops both and finishes."""
    _, trees, ported = _weights((500, 17, 999))
    img = _convert_mtcnn().synthetic_face_image()
    h, w = img.shape[:2]
    at_edge = np.array([[319.6, 131.1, 360.4, 161.0]], np.float32)
    past = np.array([[330.5, 131.1, 360.4, 161.0]], np.float32)
    inside = np.array([[w - 9.0, 10, w + 40, 50]], np.float32)
    jd = J.MTCNNDetector(*trees)
    with pytest.raises(ZeroDivisionError):
        jd._crop_weights(at_edge, h, w, 24)
    assert not jd._crop_weights(past, h, w, 24)[1].any()
    assert P._nonempty(np.concatenate([at_edge, past, inside]), h, w).tolist() == [
        False, False, True]
    pd = P.MTCNNDetector(*ported, device="cpu")
    sq = P._square(pd._stage1(torch.from_numpy(img))[:, :4])
    assert not P._nonempty(sq, h, w).all()  # the boxes JAX cannot crop are there
    assert pd.detect_batched(img[None]) == [pd.detect(img)] == [(None, 0.0)]
    np.testing.assert_array_equal(pd.crop_faces_batched(img[None]), pd.crop_faces(img[None]))


def test_default_face_cropper_follows_the_variable(tmp_path, monkeypatch):
    """Unset or empty: no cropper (the loader center-crops). A directory
    without weights, or a path that is no directory, raises. Weights: the
    batched cropper at the config's thresholds and size."""
    from eav_tpu_torch.core.config import VisionPreprocConfig

    cfg = VisionPreprocConfig(face_detection=True, mtcnn_thresholds=THRESHOLDS,
                              face_prob_threshold=0.0)
    monkeypatch.delenv("EAV_TPU_MTCNN_WEIGHTS", raising=False)
    assert P.default_face_cropper(cfg, "cpu") is None
    monkeypatch.setenv("EAV_TPU_MTCNN_WEIGHTS", "")
    assert P.default_face_cropper(cfg, "cpu") is None
    monkeypatch.setenv("EAV_TPU_MTCNN_WEIGHTS", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="pnet"):
        P.default_face_cropper(cfg, "cpu")
    monkeypatch.setenv("EAV_TPU_MTCNN_WEIGHTS", str(tmp_path / "absent"))
    with pytest.raises(FileNotFoundError, match="not a directory"):
        P.default_face_cropper(cfg, "cpu")
    sds, _, ported = _weights()
    for net, sd in zip(P.NETS, sds):
        torch.save(sd, tmp_path / f"{net}.pt")
    monkeypatch.setenv("EAV_TPU_MTCNN_WEIGHTS", str(tmp_path))
    frames = _frames(n=3)
    want = P.MTCNNDetector(*ported, thresholds=THRESHOLDS, device="cpu").crop_faces_batched(
        frames, 0.0)
    np.testing.assert_array_equal(P.default_face_cropper(cfg, "cpu")(frames), want)
