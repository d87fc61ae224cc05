"""The port's SOS bandpass against scipy (the reference's DSP) and against the
JAX package's ``sosfilt``, at the JAX tests' tolerances (tests/test_signal.py):
float64 to 1e-7 / 1e-9, a long signal over many small blocks to 1e-6 / 1e-8,
float32 within 1e-3 of the signal's maximum."""

import numpy as np
import pytest
import scipy.signal as sps
import torch

from eav_tpu.ops.signal import design_butter_sos as jax_design_butter_sos
from eav_tpu.ops.signal import sosfilt as jax_sosfilt
from eav_tpu_torch.ops.signal import (
    _biquad_parfrac,
    bandpass_sos,
    design_butter_sos,
    linear_recurrence,
    sosfilt,
)


def test_design_matches_jax():
    np.testing.assert_array_equal(design_butter_sos(5, 0.5, 45.0, 100.0),
                                  jax_design_butter_sos(5, 0.5, 45.0, 100.0))


@pytest.mark.parametrize("method", ["scan", "parallel"])
def test_sosfilt_matches_scipy_and_jax(rng, method):
    sos = design_butter_sos(5, 0.5, 45.0, 100.0)
    x = rng.normal(size=(4, 5000))
    ref = sps.sosfilt(sos, x, axis=-1)
    ours = sosfilt(sos, torch.from_numpy(x), method=method).numpy()
    assert ours.dtype == np.float64
    np.testing.assert_allclose(ours, ref, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(ours, np.asarray(jax_sosfilt(sos, x, method=method)),
                               rtol=1e-7, atol=1e-9)


@pytest.mark.parametrize("block", [16, 64])
def test_sosfilt_long_signal_in_small_blocks(rng, block):
    """60k samples: 3750 blocks of 16 recurse three levels, 938 of 64 two."""
    sos = design_butter_sos(5, 0.5, 45.0, 100.0)
    x = rng.normal(size=(2, 60_000))
    ref = sps.sosfilt(sos, x, axis=-1)
    ours = sosfilt(sos, torch.from_numpy(x), block=block).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-8)


def test_float32_accuracy(rng):
    """The production dtype against float64 scipy and JAX's float32 path."""
    sos = design_butter_sos(5, 0.5, 45.0, 100.0)
    x = rng.normal(size=(30, 20000)).astype(np.float32)
    ref = sps.sosfilt(sos, x.astype(np.float64), axis=-1)
    ours = sosfilt(sos.astype(np.float32), torch.from_numpy(x)).numpy()
    assert ours.dtype == np.float32
    assert (np.abs(ours - ref) / np.abs(ref).max()).max() < 1e-3
    theirs = np.asarray(jax_sosfilt(sos.astype(np.float32), x, method="parallel"))
    assert (np.abs(ours - theirs) / np.abs(ref).max()).max() < 1e-3


def test_bandpass_response():
    """A 10 Hz tone passes the [0.5, 45] band; 49.5 Hz is attenuated."""
    t = np.arange(20000) / 100.0
    tones = torch.from_numpy(np.stack([np.sin(2 * np.pi * 10.0 * t),
                                       np.sin(2 * np.pi * 49.5 * t)]))
    y = bandpass_sos(tones, 0.5, 45.0, 100.0).numpy()
    assert np.std(y[0, 5000:]) > 0.5
    assert np.std(y[1, 5000:]) < 0.05


@pytest.mark.parametrize("n", [1, 7, 256, 1000])
def test_linear_recurrence_matches_loop(rng, n):
    """Against the sequential recurrence, for lengths below, at and between
    block multiples, with a pole near the unit circle."""
    p = 0.999 * np.exp(0.3j)
    c = rng.normal(size=(3, n)) + 1j * rng.normal(size=(3, n))
    want = np.zeros_like(c)
    u = np.zeros(3, complex)
    for i in range(n):
        u = p * u + c[:, i]
        want[:, i] = u
    got = linear_recurrence(p, torch.from_numpy(c), block=32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)


def test_defective_section_takes_the_scan(rng):
    """A double pole has no partial-fraction split: the parallel path falls to
    the sequential one and still equals scipy."""
    section = np.array([1.0, 0.5, 0.25, 1.0, -1.6, 0.64])  # (1 - 0.8 w)^2
    assert _biquad_parfrac(section) is None
    x = rng.normal(size=(2, 300))
    np.testing.assert_allclose(sosfilt(section[None], torch.from_numpy(x)).numpy(),
                               sps.sosfilt(section[None], x, axis=-1), rtol=1e-9, atol=1e-12)


def test_unknown_method_raises():
    with pytest.raises(ValueError, match="unknown sosfilt method"):
        sosfilt(design_butter_sos(5, 0.5, 45.0, 100.0), torch.zeros(1, 8), method="fft")
