"""The port's EEG ingest against the JAX package's and the reference's chain:
the F-order helpers exactly, ``preprocess_eeg`` and
``DataLoadEEG.prepare_from_arrays`` in both filter orders (labels exactly,
float64 to 1e-7 / 1e-9, float32 within 2e-3 of the scale), the ``mat5``
copy against ``scipy.io`` files, and the loader from .mat files."""

import numpy as np
import pytest
import scipy.io
import scipy.signal as sps
import torch

from eav_tpu.core.config import EEGPreprocConfig as JaxEEGPreprocConfig
from eav_tpu.ingest import eeg as jax_eeg
from eav_tpu_torch.core.config import EEGPreprocConfig
from eav_tpu_torch.ingest import mat5
from eav_tpu_torch.ingest.eeg import (
    DataLoadEEG,
    chunk_trials,
    flatten_trials,
    preprocess_eeg,
    select_classes,
    unflatten_trials,
)

CH, T, TRI = 6, 4000, 10  # scaled down (real: 30, 10000, 200)
SMALL = dict(channels=CH, trial_seconds=8.0, chunk_seconds=2.0)


def _oracle(seg, label, fs_orig=500, fs_target=100):
    """The reference's `Dataload_eeg.py:85-152` chain with scipy and MATLAB
    F-order reshapes (tests/test_eeg_ingest.py), labels remapped to 0..4."""
    ch, t, tri = seg.shape
    tm = sps.resample_poly(np.reshape(seg, [ch, t * tri], order="F"), 1, fs_orig // fs_target,
                           axis=1)
    new_t = t * fs_target // fs_orig
    sos = sps.butter(5, (0.5, 45.0), btype="bandpass", fs=fs_target, output="sos")
    dat = np.reshape(np.reshape(tm, [ch, new_t, tri], order="F"), [ch, new_t * tri], order="F")
    seg_f = np.array([sps.sosfilt(sos, d) for d in dat]).reshape((ch, new_t, tri), order="F")
    chunk = new_t // 4
    seg_div = seg_f.reshape((ch, chunk, 4, tri), order="F").reshape((ch, chunk, 4 * tri),
                                                                     order="F")
    label_div = np.repeat(label, repeats=4, axis=1)
    selected = [1, 3, 5, 7, 9]
    mask = np.isin(np.argmax(label_div, axis=0), selected)
    lab = np.array([selected.index(v) for v in np.argmax(label_div[:, mask], axis=0)])
    return np.transpose(seg_div[:, :, mask], (2, 0, 1)), lab


@pytest.fixture
def subject(rng):
    seg = rng.normal(size=(CH, T, TRI))
    label = np.zeros((10, TRI))
    label[rng.integers(0, 10, size=TRI), np.arange(TRI)] = 1
    return seg, label


def test_config_hash_matches_jax():
    from eav_tpu.train.pipeline import _cfg_hash as jax_hash
    from eav_tpu_torch.train.pipeline import _cfg_hash

    for kw in ({}, SMALL, {"filter_before_downsample": True}):
        assert _cfg_hash(EEGPreprocConfig(**kw)) == jax_hash(JaxEEGPreprocConfig(**kw))


def test_forder_helpers_exact(rng):
    x = rng.normal(size=(3, 20, 4))
    flat = flatten_trials(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(flat, np.reshape(x, [3, 80], order="F"))
    np.testing.assert_array_equal(flat, np.asarray(jax_eeg.flatten_trials(x)))
    np.testing.assert_array_equal(unflatten_trials(torch.from_numpy(flat), 20).numpy(), x)
    chunks = chunk_trials(torch.from_numpy(x), 5).numpy()
    np.testing.assert_array_equal(
        chunks, x.reshape((3, 5, 4, 4), order="F").reshape((3, 5, 16), order="F"))
    np.testing.assert_array_equal(chunks, np.asarray(jax_eeg.chunk_trials(x, 5)))


@pytest.mark.parametrize("before", [False, True])
def test_preprocess_matches_jax_float64(subject, before):
    seg, _ = subject
    cfg = EEGPreprocConfig(filter_before_downsample=before, **SMALL)
    jcfg = JaxEEGPreprocConfig(filter_before_downsample=before, **SMALL)
    ours = preprocess_eeg(torch.from_numpy(seg), cfg).numpy()
    theirs = np.asarray(jax_eeg.preprocess_eeg(seg, jcfg))
    assert ours.shape == theirs.shape == (CH, 200, 4 * TRI)
    np.testing.assert_allclose(ours, theirs, rtol=1e-7, atol=1e-9)


def test_loader_matches_oracle_and_jax_float64(subject):
    seg, label = subject
    x, y = DataLoadEEG(config=EEGPreprocConfig(**SMALL), dtype=torch.float64,
                       device="cpu").prepare_from_arrays(seg, label)
    x_ref, y_ref = _oracle(seg, label)
    np.testing.assert_array_equal(y, y_ref)
    assert x.dtype == np.float64 and x.shape == x_ref.shape
    np.testing.assert_allclose(x, x_ref, rtol=1e-7, atol=1e-9)
    xj, yj = jax_eeg.DataLoadEEG(config=JaxEEGPreprocConfig(**SMALL),
                                 dtype=np.float64).prepare_from_arrays(seg, label)
    np.testing.assert_array_equal(y, yj)
    np.testing.assert_allclose(x, xj, rtol=1e-7, atol=1e-9)


@pytest.mark.parametrize("before", [False, True])
def test_loader_float32_close(subject, before):
    """float32 (the production dtype) within 2e-3 of the float64 scale,
    against the float64 port and JAX's float32 loader, in both orders."""
    seg, label = subject
    cfg = EEGPreprocConfig(filter_before_downsample=before, **SMALL)
    x32, y32 = DataLoadEEG(config=cfg, device="cpu").prepare_from_arrays(
        seg.astype(np.float32), label)
    x64, y64 = DataLoadEEG(config=cfg, dtype=torch.float64, device="cpu").prepare_from_arrays(
        seg, label)
    xj, yj = jax_eeg.DataLoadEEG(
        config=JaxEEGPreprocConfig(filter_before_downsample=before, **SMALL),
        dtype=np.float32).prepare_from_arrays(seg.astype(np.float32), label)
    np.testing.assert_array_equal(y32, y64)
    np.testing.assert_array_equal(y32, yj)
    assert x32.dtype == np.float32
    scale = np.abs(x64).max()
    assert (np.abs(x32 - x64) / scale).max() < 2e-3
    assert (np.abs(x32 - xj) / scale).max() < 2e-3


def test_select_classes_remaps_labels(rng):
    data = rng.normal(size=(2, 5, 8))
    onehot = np.zeros((10, 8))
    onehot[[0, 1, 3, 5, 7, 9, 2, 9], np.arange(8)] = 1
    x, y = select_classes(data, onehot, (1, 3, 5, 7, 9))
    assert x.shape == (6, 2, 5)
    np.testing.assert_array_equal(y, [0, 1, 2, 3, 4, 4])
    xj, yj = jax_eeg.select_classes(data, onehot, (1, 3, 5, 7, 9))
    np.testing.assert_array_equal(x, xj)
    np.testing.assert_array_equal(y, yj)


@pytest.mark.parametrize("compress", [False, True])
def test_mat5_reads_scipy_files(tmp_path, rng, compress):
    path = str(tmp_path / "s.mat")
    seg = rng.normal(size=(50, 3, 2)).astype(np.float32)
    label = rng.integers(0, 2, size=(10, 2)).astype(np.float64)
    scipy.io.savemat(path, {"seg1": seg, "label": label}, do_compression=compress)
    ours = mat5.loadmat(path)
    np.testing.assert_array_equal(ours["seg1"], seg)
    np.testing.assert_array_equal(ours["label"], label)


def test_mat5_writes_what_scipy_reads(tmp_path, rng):
    path = str(tmp_path / "w.mat")
    seg = rng.normal(size=(100, 6, 4))
    mat5.savemat(path, {"seg": seg})
    np.testing.assert_array_equal(scipy.io.loadmat(path)["seg"], seg)
    np.testing.assert_array_equal(mat5.loadmat(path)["seg"], seg)


def _write_subject(root, rng, var="seg"):
    sdir = root / "subject01" / "EEG"
    sdir.mkdir(parents=True)
    seg_tch = rng.normal(size=(T, CH, TRI))  # the .mat layout (t, ch, tri)
    label = np.zeros((10, TRI))
    label[rng.integers(0, 10, TRI), np.arange(TRI)] = 1
    scipy.io.savemat(str(sdir / "subject01_eeg.mat"), {var: seg_tch})
    scipy.io.savemat(str(sdir / "subject01_eeg_label.mat"), {"label": label})
    return seg_tch, label


@pytest.mark.parametrize("var", ["seg", "seg1"])
def test_loader_from_mat_files(tmp_path, rng, var):
    seg_tch, label = _write_subject(tmp_path / "EAV", rng, var)
    loader = DataLoadEEG(1, EEGPreprocConfig(**SMALL), str(tmp_path / "EAV"),
                         dtype=torch.float64, device="cpu")
    x, y = loader.prepare_data()
    x_ref, y_ref = _oracle(np.transpose(seg_tch, (1, 0, 2)), label)
    np.testing.assert_array_equal(y, y_ref)
    np.testing.assert_allclose(x, x_ref, rtol=1e-7, atol=1e-9)


def test_loader_without_signal_variable_raises(tmp_path, rng):
    _write_subject(tmp_path / "EAV", rng, var="eeg")
    with pytest.raises(KeyError, match="no 'seg'/'seg1'"):
        DataLoadEEG(1, EEGPreprocConfig(**SMALL), str(tmp_path / "EAV"),
                    device="cpu").prepare_data()
