"""The port's audio frontend (resampling, Kaldi fbank, ingest) against the
JAX package's, on the same numpy inputs."""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.signal
import torch

from eav_tpu.ingest.audio import DataLoadAudio as JaxDataLoadAudio
from eav_tpu.ingest.audio import ast_frontend as jax_ast_frontend
from eav_tpu.ingest.wav import write_wav
from eav_tpu.ops import signal as jsig
from eav_tpu.ops import spectral as jspec
from eav_tpu_torch.core.config import AudioPreprocConfig
from eav_tpu_torch.ingest.audio import DataLoadAudio, ast_frontend
from eav_tpu_torch.ops.signal import resample_poly
from eav_tpu_torch.ops.spectral import ast_fbank, ast_features


@pytest.mark.parametrize("up,down,n", [(160, 441, 4410), (1, 3, 1001), (3, 2, 257)])
def test_resample_poly_matches_scipy_and_jax(rng, up, down, n):
    x = rng.normal(size=(2, n))
    want = scipy.signal.resample_poly(x, up, down, axis=-1)
    got = resample_poly(torch.from_numpy(x), up, down).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)  # float64: exact design
    x32 = x.astype(np.float32)
    got32 = resample_poly(torch.from_numpy(x32), up, down).numpy()
    want32 = np.asarray(jsig.resample_poly(jnp.asarray(x32), up, down))
    assert got32.dtype == np.float32
    np.testing.assert_allclose(got32, want32, rtol=1e-5, atol=1e-5)


def test_ast_fbank_and_features_match_jax(rng):
    """f32 log-mel from two FFT libraries: the log amplifies relative error
    in the weakest bins, hence 1e-3 on values of up to ~16."""
    w = (0.1 * rng.normal(size=(2, 16000))).astype(np.float32)
    want = np.asarray(jspec.ast_fbank(jnp.asarray(w), max_frames=128))
    got = ast_fbank(torch.from_numpy(w), max_frames=128).numpy()
    assert got.shape == want.shape == (2, 128, 128)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    want = np.asarray(jspec.ast_features(jnp.asarray(w)))
    got = ast_features(torch.from_numpy(w)).numpy()
    assert got.shape == (2, 1024, 128)  # 98 real frames, zero-padded to 1024
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


def _subject(root, rng):
    """Five wavs in the EAV layout at two sample rates and two lengths,
    named so that sorted order interleaves the rates."""
    adir = root / "subject01" / "Audio"
    adir.mkdir(parents=True)
    specs = [(32000, 2.2), (16000, 2.0), (32000, 2.2), (8000, 1.1), (16000, 2.0)]
    emotions = ["Neutral", "Sadness", "Anger", "Happiness", "Calmness"]
    for i, ((sr, sec), emo) in enumerate(zip(specs, emotions)):
        x = 0.2 * rng.normal(size=int(sr * sec))
        write_wav(str(adir / f"subject_01_Speaking_{i}_{emo}_.wav"), x, sr)


def test_data_load_audio_matches_jax(tmp_path, rng):
    _subject(tmp_path, rng)
    cfg = AudioPreprocConfig(segment_seconds=0.5)
    got_x, got_y = DataLoadAudio(1, str(tmp_path), cfg, device="cpu").process()
    from eav_tpu.core.config import AudioPreprocConfig as JaxAudioCfg

    want_x, want_y = JaxDataLoadAudio(1, str(tmp_path), JaxAudioCfg(segment_seconds=0.5)).process()
    np.testing.assert_array_equal(got_y, want_y)
    assert got_y.dtype == np.int32 and got_x.dtype == np.float32
    assert got_x.shape == want_x.shape == (4 + 4 + 4 + 2 + 4, 8000)
    np.testing.assert_allclose(got_x, want_x, rtol=1e-5, atol=1e-5)
    # segments stay in file order: labels run 0,0,0,0,1,1,1,1,2,...
    np.testing.assert_array_equal(got_y, np.repeat([0, 1, 2, 3, 4], [4, 4, 4, 2, 4]))

    got = ast_frontend(got_x[:3], AudioPreprocConfig(max_frames=128), device="cpu")
    want = jax_ast_frontend(want_x[:3], JaxAudioCfg(max_frames=128))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
