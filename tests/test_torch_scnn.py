"""The port's SCNN slice against the JAX package's, on the same numpy inputs
in float32: every function of the scnn180 chain (the tuning indices exact),
``scnn_frontend``, SCNNAudio through ``models/bridge.py``, the ``scnn_audio``
trainer trajectory against ``JitTrainer``, the trainer flags ``l1_reg`` /
``l2_reg`` and ``compat_batch_mean_acc``, and ``run_audio(1, "scnn180")``
against the JAX pipeline on a synthetic subject."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eav_tpu.core.config import FinetuneConfig as JaxFinetuneConfig
from eav_tpu.core.config import PhaseConfig as JaxPhaseConfig
from eav_tpu.core.config import get_preset as jax_get_preset
from eav_tpu.ingest.audio import scnn_frontend as jax_scnn_frontend
from eav_tpu.ingest.wav import write_wav
from eav_tpu.models.scnn_audio import SCNNAudio as JaxSCNNAudio
from eav_tpu.ops import spectral as J
from eav_tpu.train.loop import JitTrainer
from eav_tpu.train.pipeline import ModalityPipelines as JaxPipelines
from eav_tpu_torch.core.config import AudioPreprocConfig, FinetuneConfig, PhaseConfig, get_preset
from eav_tpu_torch.ingest.audio import scnn_frontend
from eav_tpu_torch.models.bridge import scnn_params_from_jax
from eav_tpu_torch.models.scnn_audio import SCNNAudio
from eav_tpu_torch.ops import spectral as T
from eav_tpu_torch.train import pipeline as P
from eav_tpu_torch.train.loop import Trainer, kernel_penalty

SR = 22050


def _signals(rng):
    """1 s clips: a detuned harmonic tone, white noise, a tone in noise,
    silence (no candidates: tuning 0), and the speech-like mix of
    tests/test_spectral.py."""
    t = np.arange(SR) / SR
    return np.stack([
        sum(np.sin(2 * np.pi * 220 * 2 ** (0.23 / 12) * k * t) / k for k in range(1, 6)),
        rng.normal(size=t.shape),
        0.3 * np.sin(2 * np.pi * 347.0 * t) + 0.1 * rng.normal(size=t.shape),
        np.zeros_like(t),
        0.3 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 660 * t + 0.5)
        + 0.05 * rng.normal(size=t.shape),
    ]).astype(np.float32)


def _detuned(detunings=(-0.37, -0.2, -0.04, 0.0, 0.13, 0.33, 0.45)):
    t = np.arange(SR) / SR
    return np.stack([sum(np.sin(2 * np.pi * 220.0 * 2.0 ** (d / 12.0) * k * t) / k
                         for k in range(1, 6)) for d in detunings]).astype(np.float32)


def test_host_designs_equal_jax():
    """Slaney mel, the periodic Hann, the chroma bank and its tuning table
    are the JAX package's numpy designs."""
    np.testing.assert_array_equal(
        T.mel_filter_bank(1025, 128, 0.0, SR / 2.0, SR, norm="slaney", mel_scale="slaney"),
        J.mel_filter_bank(1025, 128, 0.0, SR / 2.0, SR, norm="slaney", mel_scale="slaney"))
    np.testing.assert_array_equal(T.hann_window(2048, periodic=True),
                                  J.hann_window(2048, periodic=True))
    np.testing.assert_array_equal(T.chroma_filter_bank(SR, 2048, 12, 0.13),
                                  J.chroma_filter_bank(SR, 2048, 12, 0.13))
    np.testing.assert_array_equal(T._chroma_bank_table(SR, 2048, 12, 0.01),
                                  J._chroma_bank_table(SR, 2048, 12, 0.01))


# float32 from two FFT libraries: each output agrees with JAX's to 1e-5 of
# its largest entry (measured: ~4e-7 for the spectra, ~2e-7 for the rest)
@pytest.mark.parametrize("name", ["stft_mag_sq", "mel_spectrogram", "mfcc", "chroma_stft",
                                  "chroma_pinned", "scnn180_features"])
def test_chain_matches_jax(rng, name):
    y = _signals(rng)
    calls = {
        "stft_mag_sq": (lambda m, x: m.stft_mag_sq(x, 2048, 512)),
        "mel_spectrogram": (lambda m, x: m.mel_spectrogram(x, SR)),
        "mfcc": (lambda m, x: m.mfcc(x, SR)),
        "chroma_stft": (lambda m, x: m.chroma_stft(x, SR)),
        "chroma_pinned": (lambda m, x: m.chroma_stft(x, SR, tuning=0.0)),
        "scnn180_features": (lambda m, x: m.scnn180_features(x, SR)),
    }
    want = np.asarray(calls[name](J, jnp.asarray(y, jnp.float32)))
    got = calls[name](T, torch.from_numpy(y)).numpy()
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_power_to_db_matches_jax(rng):
    """The top_db clip is relative to each clip's maximum."""
    S = (rng.uniform(size=(3, 7, 11)) ** 8 * np.array([1.0, 1e-6, 1e3])[:, None, None]).astype(
        np.float32)
    want = np.asarray(J.power_to_db(jnp.asarray(S)))
    got = T.power_to_db(torch.from_numpy(S)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
    assert (got.max(axis=(1, 2)) - got.min(axis=(1, 2)) <= 80.0 + 1e-4).all()


@pytest.mark.parametrize("which", ["signals", "detuned"])
def test_tuning_index_exact(rng, which):
    """The tuning index equals JAX's exactly, on JAX's power spectrum and on
    the port's own, batched and clip by clip."""
    y = _signals(rng) if which == "signals" else _detuned()
    pj = np.asarray(J.stft_mag_sq(jnp.asarray(y, jnp.float32), 2048, 512))
    want = np.asarray(J.estimate_tuning_power(jnp.asarray(pj), SR, 2048))
    got = T.estimate_tuning_power(torch.from_numpy(pj.copy()), SR, 2048).numpy()
    np.testing.assert_array_equal(got, want)
    own = T.estimate_tuning_power(T.stft_mag_sq(torch.from_numpy(y)), SR, 2048).numpy()
    np.testing.assert_array_equal(own, want)
    single = [int(T.estimate_tuning_power(torch.from_numpy(pj[i].copy()), SR, 2048))
              for i in range(len(y))]
    assert single == want.tolist()
    if which == "signals":
        assert want[3] == 50  # silence: no candidates, tuning 0.0


def test_detuned_tones_recover_their_tuning():
    """Within the estimator's own bias (0.11 bins, tests/test_spectral.py);
    a bank pinned to tuning 0 moves the detuned A off its pitch class."""
    detunings = (-0.37, -0.2, -0.04, 0.0, 0.13, 0.33, 0.45)
    idx = T.estimate_tuning_power(T.stft_mag_sq(torch.from_numpy(_detuned(detunings))),
                                  SR, 2048).numpy()
    assert np.abs(-0.5 + idx * 0.01 - np.array(detunings)).max() <= 0.11
    t = np.arange(SR) / SR
    a = torch.from_numpy(np.sin(2 * np.pi * 440.0 * 2 ** (0.45 / 12) * t).astype(np.float32))
    assert int(T.chroma_stft(a, SR).mean(-2).argmax()) == 9  # A
    est, pinned = T.chroma_stft(a, SR).mean(-2), T.chroma_stft(a, SR, tuning=0.0).mean(-2)
    assert float((est - pinned).abs().max()) > 0.05


def test_scnn_frontend_matches_jax(rng):
    """Three 5 s segments in batches of 2 against JAX's frontend; a float64
    run of the chain agrees with float32 within 2e-4 of each block's scale."""
    segs = (0.2 * rng.normal(size=(3, 5 * SR))).astype(np.float32)
    segs[1] += np.sin(2 * np.pi * 300 * np.arange(5 * SR) / SR).astype(np.float32)
    want = np.asarray(jax_scnn_frontend(segs, batch=2))
    got = scnn_frontend(segs, AudioPreprocConfig(frontend="scnn180"), device="cpu", batch=2)
    assert got.shape == want.shape == (3, 180) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-3)
    f64 = T.scnn180_features(torch.from_numpy(segs).double(), SR).numpy()
    for a, b in ((0, 40), (40, 52), (52, 180)):
        scale = np.abs(f64[:, a:b]).max()
        assert np.abs(got[:, a:b] - f64[:, a:b]).max() <= 2e-4 * scale, (a, b)


def _scnn_pair(rng, dropout_rates=(0.1, 0.5)):
    x = rng.normal(size=(4, 180)).astype(np.float32)
    mj = JaxSCNNAudio(dropout_rates=dropout_rates)
    params = jax.tree.map(np.asarray, mj.init(jax.random.PRNGKey(0), x)["params"])
    mt = SCNNAudio(dropout_rates=dropout_rates)
    mt.load_state_dict(scnn_params_from_jax(params))
    return x, mj, params, mt


def test_scnn_logits_match_jax(rng):
    """Eval mode with the preset's dropout, and train mode at dropout 0:
    the head's NWC -> NCW column permutation is what makes these agree."""
    x, mj, params, mt = _scnn_pair(rng)
    want = np.asarray(mj.apply({"params": params}, x, train=False))
    with torch.no_grad():
        got = mt.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == (4, 5) and mt.head.in_features == 2816
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    x, mj, params, mt = _scnn_pair(rng, (0.0, 0.0))
    want = np.asarray(mj.apply({"params": params}, x, train=True))
    with torch.no_grad():
        got = mt.train()(torch.from_numpy(x[:, None, :])).numpy()  # (B, 1, 180) too
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_scnn_bridge_permutes_the_head_rows(rng):
    """The same weights without the permutation give other logits."""
    x, mj, params, mt = _scnn_pair(rng)
    want = np.asarray(mj.apply({"params": params}, x, train=False))
    with torch.no_grad():
        mt.head.weight.copy_(torch.from_numpy(np.asarray(params["head"]["kernel"]).T.copy()))
        got = mt.eval()(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() > 1e-2


def _data(rng, n_train=10, n_test=5):
    return (rng.normal(size=(n_train, 180)).astype(np.float32),
            rng.integers(0, 5, size=n_train).astype(np.int32),
            rng.normal(size=(n_test, 180)).astype(np.float32),
            rng.integers(0, 5, size=n_test).astype(np.int32))


def _fit_both(rng, epochs=3, lr=1e-3, **flags):
    """The scnn_audio trainer (Adam) at dropout 0, in-order batches of 4
    over 10 rows (a partial last batch) and eval batches of 3 over 5, in
    both packages from the same weights."""
    data = _data(rng)
    kw = dict(model="scnn_audio", batch_size=4, optimizer="adam", weight_decay=0.0,
              shuffle=False, eval_batch_size=3, **flags)
    jcfg = JaxFinetuneConfig(phases=(JaxPhaseConfig(epochs, lr, False),), **kw)
    cfg = FinetuneConfig(phases=(PhaseConfig(epochs, lr, False),), **kw)
    mj = JaxSCNNAudio(dropout_rates=(0.0, 0.0))
    params = jax.tree.map(np.asarray, mj.init(jax.random.PRNGKey(1), data[0][:1])["params"])
    want = JitTrainer(mj, jcfg).fit(data, init_params=jax.tree.map(jnp.asarray, params))
    trainer = Trainer(SCNNAudio(dropout_rates=(0.0, 0.0)), cfg, device="cpu")
    got = trainer.fit(data, init_params=scnn_params_from_jax(params))
    return got, want


def assert_adam_params_close(got: dict, want: dict, lr: float, steps: int) -> None:
    """Trained weights to 1e-4, but for a few entries (at most 1e-3 of a
    leaf) within 2 lr a step: Adam's update is about lr * sign(g), so an
    entry whose gradient is at rounding level (a ReLU at its kink) steps by
    +-lr in either package as the roundoff sets its sign."""
    for name, value in want.items():
        a, w = got[name].numpy(), value.numpy()
        off = np.abs(a - w) > 1e-4 + 1e-4 * np.abs(w)
        assert off.sum() <= 1e-3 * a.size, (name, int(off.sum()))
        assert np.abs(a - w).max() <= 2 * lr * steps, name


@pytest.mark.parametrize("flags", [
    {}, {"l1_reg": 1e-4, "l2_reg": 1e-3}, {"compat_batch_mean_acc": True},
], ids=["plain", "l1_l2", "batch_mean_acc"])
def test_scnn_trajectory_matches_jit_trainer(rng, flags):
    """Two epochs of 3 steps at the preset's lr 1e-3: per-epoch history and
    test logits to 1e-4, the weights by ``assert_adam_params_close``."""
    got, want = _fit_both(rng, epochs=2, **flags)
    for k in ("loss", "train_acc", "test_acc"):
        assert got.history[k].shape == (2,)
        np.testing.assert_allclose(got.history[k], want.history[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(got.outputs_test, want.outputs_test, rtol=1e-4, atol=1e-4)
    assert_adam_params_close(got.params, scnn_params_from_jax(
        jax.tree.map(np.asarray, want.params)), 1e-3, 6)


def test_batch_mean_accuracy_weighs_the_partial_batch():
    """10 train rows in batches of 4, 4, 2 and 5 test rows in eval batches of
    3, 2: the per-batch means, not the sample means."""
    cfg = FinetuneConfig(model="scnn_audio", batch_size=4, phases=(PhaseConfig(1, 1e-3, False),),
                         eval_batch_size=3, compat_batch_mean_acc=True)
    trainer = Trainer(SCNNAudio(), cfg, device="cpu")
    acc = trainer._train_acc(torch.tensor([4, 0, 2]), 10, 4)
    assert float(acc) == pytest.approx((1.0 + 0.0 + 1.0) / 3)
    logits = torch.eye(5)[[0, 1, 2, 0, 0]]
    assert float(trainer._test_acc(logits, torch.tensor([0, 1, 2, 3, 4]))) == \
        pytest.approx((1.0 + 0.0) / 2)


def test_run_audio_scnn180_matches_jax(tmp_path, rng, monkeypatch):
    """Five 10 s wavs at 44.1 kHz, resampled to 22.05 kHz (two segments each):
    the same cached features under the same key, and, from the weights JAX
    draws for the subject's seed (dropout 0, in-order batches), the same
    history, test logits and metrics row."""
    root = tmp_path / "EAV"
    adir = root / "subject01" / "Audio"
    adir.mkdir(parents=True)
    t = np.arange(10 * 44100) / 44100
    for i, emo in enumerate(["Neutral", "Sadness", "Anger", "Happiness", "Calmness"]):
        x = 0.3 * np.sin(2 * np.pi * (200 + 100 * i) * t) + 0.01 * rng.normal(size=t.size)
        write_wav(str(adir / f"subject_01_Speaking_{i}_{emo}_.wav"), x, 44100)
    ft = dict(batch_size=4, shuffle=False, eval_batch_size=3,
              model_kwargs={"dropout_rates": (0.0, 0.0)})

    def preset(get):
        base = get("scnn_audio")
        phase = dataclasses.replace(base.finetune.phases[0], epochs=2)
        return base.replace(split=dataclasses.replace(base.split, h_idx=1), finetune=(
            dataclasses.replace(base.finetune, **{**ft, "phases": (phase,)})))

    jp = JaxPipelines(str(root), cache_dir=str(tmp_path / "jc"),
                      presets={"audio_scnn": preset(jax_get_preset)})
    want = jp.run_audio(1, "scnn180")
    x, _ = jp.load_audio(1, "scnn180")
    mj = JaxSCNNAudio(dropout_rates=(0.0, 0.0))
    k_init = jax.random.split(jax.random.PRNGKey(0 + 1))[1]
    init = mj.init({"params": k_init, "dropout": k_init}, x[:1], train=False)["params"]
    monkeypatch.setattr(P, "_pretrained_params", lambda *a: scnn_params_from_jax(
        jax.tree.map(np.asarray, init)))
    pipes = P.ModalityPipelines(str(root), cache_dir=str(tmp_path / "tc"),
                                logits_dir=str(tmp_path / "logits"),
                                presets={"audio_scnn": preset(get_preset)}, device="cpu")
    got = pipes.task_fn(1, "audio_scnn")
    assert sorted(os.listdir(tmp_path / "logits")) == ["s01_audio_scnn_test.npy",
                                                       "s01_audio_scnn_train.npy"]
    assert os.listdir(tmp_path / "tc") == os.listdir(tmp_path / "jc")
    gx, gy = pipes.load_audio(1, "scnn180")
    wx, wy = jp.load_audio(1, "scnn180")
    assert gx.shape == (10, 180)
    np.testing.assert_array_equal(gy, wy)
    np.testing.assert_allclose(gx, wx, rtol=1e-5, atol=2e-3)
    assert got.metrics.keys() == want.metrics.keys()
    for k in ("accuracy", "weighted_f1", "final_train_acc", "epochs"):
        assert got.metrics[k] == pytest.approx(want.metrics[k], abs=1e-4), k
    assert got.metrics["confusion"] == want.metrics["confusion"]
    assert_adam_params_close(got.artifacts["params"], scnn_params_from_jax(
        jax.tree.map(np.asarray, want.artifacts["params"])), 1e-3, 6)


def _penalty_models(kind):
    """(Flax model, port model, bridge, input) of a family: AST-tiny (fused
    qkv, patch conv, LayerNorms, tokens), EEGNet (BatchNorm scales) and the
    conformer (a free ``spatial_proj``, which is no kernel)."""
    from eav_tpu.models.ast import ast_tiny as jax_ast_tiny
    from eav_tpu.models.conformer_eeg import ConformerEEG as JaxConformer
    from eav_tpu.models.eegnet import EEGNet as JaxEEGNet
    from eav_tpu_torch.models.ast import ast_tiny
    from eav_tpu_torch.models.bridge import (ast_params_from_jax, conformer_params_from_jax,
                                             eegnet_params_from_jax)
    from eav_tpu_torch.models.conformer_eeg import ConformerEEG
    from eav_tpu_torch.models.eegnet import EEGNet

    if kind == "ast":
        return jax_ast_tiny(layers=1), ast_tiny(layers=1), \
            lambda p, s: ast_params_from_jax(p), (1, 128, 128)
    if kind == "eegnet":
        kw = dict(chans=4, samples=64, kern_length=16, f1=4, d=2, f2=8)
        return JaxEEGNet(**kw), EEGNet(**kw), eegnet_params_from_jax, (1, 4, 64)
    kw = dict(chans=4, samples=100, num_layers=2)
    return JaxConformer(**kw), ConformerEEG(**kw), conformer_params_from_jax, (1, 4, 100)


@pytest.mark.parametrize("kind", ["ast", "eegnet", "conformer"])
def test_kernel_penalty_matches_jax(rng, kind):
    """The penalty's value and its gradient on the same weights: the JAX
    trainer sums every leaf named ``kernel``; the port's ``kernel_penalty``
    must pick the same tensors (no biases, norm scales, tokens or free
    parameters)."""
    mj, mt, bridge, shape = _penalty_models(kind)
    x = rng.normal(size=shape).astype(np.float32)
    variables = jax.tree.map(np.asarray, jax.jit(lambda k, x0: mj.init(k, x0, train=False))(
        jax.random.PRNGKey(2), x))
    params, stats = variables["params"], variables.get("batch_stats", {})
    l1, l2 = 1e-3, 1e-2

    def penalty(p):
        kernels = [v for path, v in jax.tree_util.tree_flatten_with_path(p)[0]
                   if "kernel" in str(path[-1])]
        return (l1 * sum(jnp.abs(k).sum() for k in kernels)
                + l2 * sum((k * k).sum() for k in kernels))

    f32 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), params)
    want, grads = jax.jit(jax.value_and_grad(penalty))(f32)
    want_grads = bridge(jax.tree.map(np.asarray, grads), stats)
    mt.load_state_dict(bridge(params, stats))
    got = kernel_penalty(mt, l1, l2)
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
    for name, p in mt.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(g.numpy(), want_grads[name].numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=name)


def test_penalties_switch_the_frozen_cache_off():
    from eav_tpu_torch.models.ast import ast_tiny
    from eav_tpu_torch.parallel.subject import SubjectParallelTrainer

    base = dict(model="ast", batch_size=4, phases=(PhaseConfig(1, 1e-3, True),))
    assert Trainer(ast_tiny(layers=1), FinetuneConfig(**base), device="cpu")._frozen_cache_ok()
    for flag in ({"l1_reg": 1e-4}, {"l2_reg": 1e-4}):
        cfg = FinetuneConfig(**base, **flag)
        assert not Trainer(ast_tiny(layers=1), cfg, device="cpu")._frozen_cache_ok()
        # stacked fits take the flags too, and leave the cache the same way
        assert not SubjectParallelTrainer(ast_tiny(layers=1), cfg,
                                          device="cpu").inner._frozen_cache_ok()
