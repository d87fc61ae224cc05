"""The port's fusion leg against the JAX package's: ``FusionHead`` in both
modes through ``fusion_params_from_jax``, its ``Trainer`` trajectory
against ``JitTrainer``, ``run_fusion`` on the same archives, strict
alignment, the two learnability checks of tests/test_pipeline_e2e.py on the
port, and the sweep's task dispatch."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eav_tpu.models.fusion import FusionHead as JaxFusionHead
from eav_tpu.train.loop import JitTrainer
from eav_tpu.train.pipeline import ModalityPipelines as JaxPipelines
from eav_tpu.train.pipeline import default_presets as jax_default_presets
from eav_tpu_torch.core.config import FinetuneConfig, PhaseConfig, get_preset
from eav_tpu_torch.models.bridge import fusion_params_from_jax
from eav_tpu_torch.models.fusion import FusionHead
from eav_tpu_torch.train.loop import Trainer
from eav_tpu_torch.train.pipeline import ModalityPipelines, build_model, default_presets


def _jax_params(mode, rng, n_mods=3):
    """Flax params of the head, perturbed off the deterministic init."""
    x = np.zeros((1, n_mods, 5), np.float32)
    params = JaxFusionHead(num_modalities=n_mods, mode=mode).init(jax.random.PRNGKey(3), x)["params"]
    return jax.tree.map(lambda p: np.asarray(p) + 0.3 * rng.normal(size=p.shape).astype(np.float32),
                        params)


@pytest.mark.parametrize("mode", ["weighted", "mlp"])
def test_fusion_head_matches_jax(rng, mode):
    params = _jax_params(mode, rng)
    x = (3 * rng.normal(size=(7, 3, 5))).astype(np.float32)
    want = JaxFusionHead(mode=mode).apply({"params": jax.tree.map(jnp.asarray, params)},
                                          jnp.asarray(x), train=False)
    head = FusionHead(mode=mode)
    head.load_state_dict(fusion_params_from_jax(params))
    got = head.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_weighted_init_is_flax_and_mlp_draws_from_its_generator():
    head = FusionHead(num_modalities=2)
    want = JaxFusionHead(num_modalities=2).init(jax.random.PRNGKey(0), jnp.zeros((1, 2, 5)))
    for name, value in fusion_params_from_jax(jax.tree.map(np.asarray, want["params"])).items():
        torch.testing.assert_close(head.state_dict()[name], value)
    a, b = (FusionHead(mode="mlp", generator=torch.Generator().manual_seed(s)) for s in (0, 0))
    torch.testing.assert_close(a.fc1.weight, b.fc1.weight)
    assert a.fc1.weight.shape == (64, 15) and a.head.weight.shape == (5, 64)


def _archives(rng, n_train=40, n_test=20, n_mods=3):
    return (rng.normal(size=(n_train, n_mods, 5)).astype(np.float32),
            np.repeat(np.arange(5), n_train // 5).astype(np.int32),
            rng.normal(size=(n_test, n_mods, 5)).astype(np.float32),
            np.repeat(np.arange(5), n_test // 5).astype(np.int32))


def test_fusion_fit_matches_jit_trainer(rng):
    """The fusion_sweep finetune config (AdamW, weight decay 1e-4) at 4
    epochs of in-order batches with a partial last one, weighted mode."""
    from eav_tpu.core.config import PhaseConfig as JaxPhaseConfig
    from eav_tpu.core.config import get_preset as jax_get_preset

    data = _archives(rng, n_train=45)
    jft = dataclasses.replace(jax_get_preset("fusion_sweep").finetune, shuffle=False,
                              batch_size=8, phases=(JaxPhaseConfig(4, 5e-2, False),))
    ft = dataclasses.replace(get_preset("fusion_sweep").finetune, shuffle=False, batch_size=8,
                             phases=(PhaseConfig(4, 5e-2, False),))
    want = JitTrainer(JaxFusionHead(), jft).fit(data)
    got = Trainer(FusionHead(), ft, device="cpu").fit(data)
    # the trainer trajectories' bound (tests/test_torch_train.py): 1e-4
    for k in ("loss", "train_acc", "test_acc"):
        np.testing.assert_allclose(got.history[k], want.history[k], rtol=1e-4, atol=1e-4, err_msg=k)
    np.testing.assert_allclose(got.outputs_test, want.outputs_test, rtol=1e-4, atol=1e-4)
    for name, value in fusion_params_from_jax(jax.tree.map(np.asarray, want.params)).items():
        np.testing.assert_allclose(got.params[name].numpy(), value.numpy(), rtol=1e-4, atol=1e-4)


def _save(ldir, mods_logits):
    ldir.mkdir(exist_ok=True)
    for (m, split), logits in mods_logits.items():
        np.save(ldir / f"s01_{m}_{split}.npy", logits)


@pytest.mark.parametrize("mods", [None, ("eeg", "audio_scnn", "vision")],
                         ids=["default", "scnn_audio"])
def test_run_fusion_matches_jax(tmp_path, rng, mods):
    """The same archives through both packages' run_fusion, weighted mode,
    in-order batches: the same accuracy and weighted F1. ``None`` is the
    default mix (EEG, audio, vision); the other is the mix of
    tests/test_pipeline_e2e.py with the SCNN's audio archives."""
    kw = {} if mods is None else {"mods": mods}
    _save(tmp_path / "logits", {(m, split): rng.normal(size=(n, 5)).astype(np.float32)
                                for m in (mods or ("eeg", "audio", "vision"))
                                for split, n in (("train", 50), ("test", 25))})

    def no_shuffle(presets):
        ft = dataclasses.replace(presets["fusion"].finetune, shuffle=False)
        presets["fusion"] = presets["fusion"].replace(finetune=ft)
        return presets

    want = JaxPipelines(str(tmp_path), logits_dir=str(tmp_path / "logits"),
                        presets=no_shuffle(jax_default_presets())).run_fusion(1, **kw)
    got = ModalityPipelines(str(tmp_path), logits_dir=str(tmp_path / "logits"),
                            presets=no_shuffle(default_presets()), device="cpu").run_fusion(1, **kw)
    assert set(got.metrics) == set(want.metrics) == {"accuracy", "weighted_f1"}
    for key in want.metrics:
        assert got.metrics[key] == pytest.approx(want.metrics[key], abs=1e-6), key


def test_strict_fusion_refuses_misaligned_archives(tmp_path, rng):
    _save(tmp_path / "logits", {("eeg", "train"): rng.normal(size=(30, 5)),
                                ("eeg", "test"): rng.normal(size=(10, 5)),
                                ("audio", "train"): rng.normal(size=(25, 5)),
                                ("audio", "test"): rng.normal(size=(10, 5))})
    pipes = ModalityPipelines(str(tmp_path), logits_dir=str(tmp_path / "logits"), device="cpu")
    with pytest.raises(ValueError, match="misaligned"):
        pipes.run_fusion(1, mods=("eeg", "audio"))
    res = pipes.run_fusion(1, strict=False, mods=("eeg", "audio"))  # the common 25 rows
    assert 0.0 <= res.metrics["accuracy"] <= 1.0
    assert "fusion#2" in pipes._trainers
    with pytest.raises(ValueError, match="logits_dir"):
        ModalityPipelines(str(tmp_path), device="cpu").run_fusion(1)


def _complementary(rng, y, known, informative_noise):
    """Logits that separate the classes ``known`` and are noise elsewhere."""
    logits = rng.normal(size=(len(y), 5)).astype(np.float32)
    mask = np.isin(y, known)
    if informative_noise is not None:
        logits[mask] = (rng.normal(size=(mask.sum(), 5)) * informative_noise).astype(np.float32)
        logits[mask, y[mask]] += 5.0
    else:
        logits[mask, y[mask]] += 4.0
    return logits


@pytest.mark.parametrize("mode", ["weighted", "mlp"])
@pytest.mark.parametrize("case", ["fuses_complementary", "beats_every_single"])
def test_fusion_beats_every_single_modality(tmp_path, mode, case):
    """The port's mirror of tests/test_pipeline_e2e.py:411 and :466: class
    information split across modalities (EEG knows {0, 1}, audio {2, 3},
    vision {4}); through run_fusion(strict=True), the fused accuracy clears
    every single modality by more than 0.15."""
    rng = np.random.default_rng(0)
    n_train, n_test, floor, noise = ((150, 50, 0.85, 0.3) if case == "fuses_complementary"
                                     else (100, 50, 0.8, None))
    known = {"eeg": (0, 1), "audio": (2, 3), "vision": (4,)}
    singles = {}
    for split, n in (("train", n_train), ("test", n_test)):
        y = np.repeat(np.arange(5), n // 5)
        for m, ks in known.items():
            logits = _complementary(rng, y, ks, noise)
            _save(tmp_path / "logits", {(m, split): logits})
            if split == "test":
                singles[m] = float((logits.argmax(1) == y).mean())
    assert max(singles.values()) < 0.7, singles
    presets = default_presets()
    ft = dataclasses.replace(presets["fusion"].finetune, model_kwargs={"mode": mode})
    presets["fusion"] = presets["fusion"].replace(finetune=ft)
    pipes = ModalityPipelines(str(tmp_path), logits_dir=str(tmp_path / "logits"),
                              presets=presets, device="cpu")
    acc = pipes.run_fusion(1, strict=True).metrics["accuracy"]
    assert acc >= floor, (mode, acc, singles)
    assert acc > max(singles.values()) + 0.15, (mode, acc, singles)


def test_fusion_preset_and_task_dispatch(tmp_path, rng):
    """fusion_sweep's fine-tune config equals the JAX package's; task_fn
    runs fusion, sends the SCNN and ResNet keys to their loaders (no data
    here, so those raise) and refuses an unknown modality."""
    from eav_tpu.core.config import get_preset as jax_get_preset

    ft, jft = get_preset("fusion_sweep").finetune, jax_get_preset("fusion_sweep").finetune
    for field in ("model", "batch_size", "optimizer", "weight_decay", "seed", "shuffle",
                  "keep_epoch_logits"):
        assert getattr(ft, field) == getattr(jft, field), field
    assert [(p.epochs, p.lr, p.freeze) for p in ft.phases] == \
        [(p.epochs, p.lr, p.freeze) for p in jft.phases]
    assert set(default_presets()) == set(jax_default_presets())
    assert isinstance(build_model(default_presets()["fusion"], num_modalities=2), FusionHead)
    _save(tmp_path / "logits", {(m, split): rng.normal(size=(n, 5)).astype(np.float32)
                                for m in ("eeg", "audio", "vision")
                                for split, n in (("train", 20), ("test", 10))})
    presets = default_presets()
    presets["fusion"] = presets["fusion"].replace(finetune=dataclasses.replace(
        presets["fusion"].finetune, phases=(PhaseConfig(2, 1e-3, False),)))
    pipes = ModalityPipelines(str(tmp_path), logits_dir=str(tmp_path / "logits"),
                              presets=presets, device="cpu")
    assert set(pipes.task_fn(1, "fusion").metrics) == {"accuracy", "weighted_f1"}
    for modality in ("audio_scnn", "vision_resnet"):
        with pytest.raises(FileNotFoundError, match="subject01"):
            pipes.task_fn(1, modality)
    with pytest.raises(KeyError, match="unknown modality"):
        pipes.task_fn(1, "smell")
    assert FinetuneConfig(model="fusion", batch_size=1, phases=()).keep_epoch_logits is False
