"""The port's optimizer and trainer against the JAX package's: one AdamW step
against ``adam_update`` with frozen leaves, the two-phase ``fit`` trajectory
against ``JitTrainer`` on the same weights and data (AST, and ViT on uint8
frames), and the frozen-feature cache against the full frozen phase."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from eav_tpu.core.config import FinetuneConfig as JaxFinetuneConfig
from eav_tpu.core.config import PhaseConfig as JaxPhaseConfig
from eav_tpu.core.optim import adam_update, init_adam_state
from eav_tpu.models.ast import ast_tiny as jax_ast_tiny
from eav_tpu.models.vit import vit_tiny as jax_vit_tiny
from eav_tpu.train.loop import JitTrainer
from eav_tpu_torch.core.config import FinetuneConfig, PhaseConfig
from eav_tpu_torch.core.optim import make_optimizer, set_trainable
from eav_tpu_torch.models.ast import ast_tiny
from eav_tpu_torch.models.bridge import ast_params_from_jax, vit_params_from_jax
from eav_tpu_torch.models.vit import vit_tiny
from eav_tpu_torch.train.loop import Trainer, cross_entropy


class _TwoLeaves(torch.nn.Module):
    def __init__(self, backbone, classifier):
        super().__init__()
        self.backbone = torch.nn.Parameter(torch.from_numpy(backbone.copy()))
        self.classifier = torch.nn.Parameter(torch.from_numpy(classifier.copy()))


def test_adamw_steps_match_adam_update(rng):
    """Three frozen steps (only the head moves, the backbone keeps zero
    moments and count) then two unfrozen steps: the backbone's bias
    correction starts at count 1 while the head's continues at 4."""
    p0 = {"backbone": rng.normal(size=(3, 4)).astype(np.float32),
          "classifier": rng.normal(size=(4, 2)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(5)]
    schedule = [(True, 5e-2)] * 3 + [(False, 5e-3)] * 2

    params = {k: jnp.asarray(v) for k, v in p0.items()}
    state = init_adam_state(params)
    model = _TwoLeaves(p0["backbone"], p0["classifier"])
    cfg = FinetuneConfig(model="x", batch_size=1, weight_decay=0.01,
                         phases=(PhaseConfig(3, 5e-2, True), PhaseConfig(2, 5e-3, False)))
    opt = make_optimizer(model, cfg)
    for g, (freeze, lr) in zip(grads, schedule):
        mask = {"backbone": not freeze, "classifier": True}
        params, state = adam_update(
            {k: jnp.asarray(v) for k, v in g.items()}, state, params,
            lr=jnp.asarray(lr, jnp.float32), trainable_mask=mask, weight_decay=0.01,
        )
        set_trainable(model, freeze)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.zero_grad(set_to_none=True)
        for name, p in model.named_parameters():
            if p.requires_grad:
                p.grad = torch.from_numpy(g[name])
        opt.step()
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[name]),
                                       rtol=1e-6, atol=1e-6, err_msg=name)
        if freeze:  # a frozen leaf is untouched, its state absent
            np.testing.assert_array_equal(model.backbone.detach().numpy(), p0["backbone"])
            assert model.backbone not in opt.state
    assert int(opt.state[model.backbone]["step"]) == int(state.count["backbone"]) == 2
    assert int(opt.state[model.classifier]["step"]) == int(state.count["classifier"]) == 5


def test_cross_entropy_matches_jax(rng):
    from eav_tpu.train.loop import cross_entropy as jax_cross_entropy

    logits = rng.normal(size=(6, 5)).astype(np.float32)
    labels = rng.integers(0, 5, size=6).astype(np.int32)
    want = jax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels), jnp.ones(6, jnp.float32))
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels).long())
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _data(rng, n_train=10, n_test=5):
    return (
        rng.normal(size=(n_train, 128, 128)).astype(np.float32),
        rng.integers(0, 5, size=n_train).astype(np.int32),
        rng.normal(size=(n_test, 128, 128)).astype(np.float32),
        rng.integers(0, 5, size=n_test).astype(np.int32),
    )


_CFG = dict(model="ast", batch_size=4, weight_decay=0.01, shuffle=False, eval_batch_size=3)
_JAX_CFG = dict(_CFG, optimizer="adamw")


def test_two_phase_fit_matches_jit_trainer(rng):
    """Frozen (cached features) then unfrozen, with a partial last batch and a
    partial eval batch: per-epoch history and final test logits agree."""
    data = _data(rng)
    jcfg = JaxFinetuneConfig(
        phases=(JaxPhaseConfig(2, 5e-3, True), JaxPhaseConfig(2, 5e-4, False)), **_JAX_CFG)
    cfg = FinetuneConfig(phases=(PhaseConfig(2, 5e-3, True), PhaseConfig(2, 5e-4, False)), **_CFG)
    mj = jax_ast_tiny(layers=1)
    variables = mj.init(jax.random.PRNGKey(1), jnp.asarray(data[0][:1]), train=False)
    params = jax.tree.map(np.asarray, variables["params"])
    want = JitTrainer(mj, jcfg).fit(data, init_params=jax.tree.map(jnp.asarray, params))
    got = Trainer(ast_tiny(layers=1), cfg, device="cpu").fit(
        data, init_params=ast_params_from_jax(params))
    for k in ("loss", "train_acc", "test_acc"):
        assert got.history[k].shape == (4,)
        np.testing.assert_allclose(got.history[k], want.history[k], rtol=1e-4, atol=1e-4, err_msg=k)
    np.testing.assert_allclose(got.outputs_test, want.outputs_test, rtol=1e-4, atol=1e-4)
    hidden = 32
    for name, value in ast_params_from_jax(jax.tree.map(np.asarray, want.params)).items():
        a, w = got.params[name].numpy(), value.numpy()
        if name.endswith("qkv.bias"):
            # the key bias has an exactly zero gradient (softmax ignores a
            # per-query shift), so Adam turns roundoff into steps of about lr
            # whose sign the roundoff sets: after 2 unfrozen steps at 5e-4
            # two runs may stand up to 2 * 2 * lr apart
            keys = slice(hidden, 2 * hidden)
            np.testing.assert_allclose(a[keys], w[keys], rtol=0, atol=4 * 5e-4)
            a, w = np.delete(a, np.r_[keys]), np.delete(w, np.r_[keys])
        np.testing.assert_allclose(a, w, rtol=1e-4, atol=1e-4, err_msg=name)


def test_frozen_cache_matches_full_frozen_phase(rng):
    data = _data(rng, 9, 4)
    cfg = FinetuneConfig(
        phases=(PhaseConfig(2, 5e-3, True), PhaseConfig(1, 5e-4, False)),
        **dict(_CFG, shuffle=True))
    on = Trainer(ast_tiny(layers=1), cfg, device="cpu")
    off = Trainer(ast_tiny(layers=1), dataclasses.replace(cfg, cache_frozen_features=False),
                  device="cpu")
    assert on._frozen_cache_ok() and not off._frozen_cache_ok()
    r_on, r_off = on.fit(data, seed=3), off.fit(data, seed=3)
    for k in ("loss", "train_acc", "test_acc"):
        np.testing.assert_allclose(r_on.history[k], r_off.history[k], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(r_on.outputs_test, r_off.outputs_test, rtol=1e-5, atol=1e-5)
    for name in r_on.params:
        np.testing.assert_allclose(r_on.params[name].numpy(), r_off.params[name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_cache_gate():
    cfg = FinetuneConfig(phases=(PhaseConfig(1, 5e-3, True),), **_CFG)
    assert Trainer(ast_tiny(), cfg, device="cpu")._frozen_cache_ok()
    assert not Trainer(ast_tiny(dropout=0.1), cfg, device="cpu")._frozen_cache_ok()
    assert not Trainer(ast_tiny(), cfg, head_regex=r"classifier", device="cpu")._frozen_cache_ok()


def test_same_seed_same_fit_and_predict(rng):
    data = _data(rng, 6, 3)
    cfg = FinetuneConfig(phases=(PhaseConfig(1, 5e-3, True), PhaseConfig(1, 5e-4, False)),
                         **dict(_CFG, shuffle=True))
    trainer = Trainer(ast_tiny(layers=1), cfg, device="cpu")
    a, b = trainer.fit(data, seed=5), trainer.fit(data, seed=5)
    np.testing.assert_array_equal(a.outputs_test, b.outputs_test)
    np.testing.assert_allclose(trainer.predict(data[2], a.params, batch_size=2),
                               a.outputs_test, rtol=1e-6, atol=1e-6)


def _frames(rng, n_train=10, n_test=5, side=56):
    """uint8 frames at 56x56 (resized to the model's 64 inside it)."""
    return (
        rng.integers(0, 256, size=(n_train, side, side, 3), dtype=np.uint8),
        rng.integers(0, 5, size=n_train).astype(np.int32),
        rng.integers(0, 256, size=(n_test, side, side, 3), dtype=np.uint8),
        rng.integers(0, 5, size=n_test).astype(np.int32),
    )


def test_vit_two_phase_fit_on_uint8_frames_matches_jit_trainer(rng):
    """ViT with ``preprocess_uint8``: the frames stay uint8 through batching,
    the frozen-feature cache and eval; history and test logits agree."""
    data = _frames(rng)
    jcfg = JaxFinetuneConfig(
        phases=(JaxPhaseConfig(2, 5e-3, True), JaxPhaseConfig(2, 5e-4, False)),
        **dict(_JAX_CFG, model="vit"))
    cfg = FinetuneConfig(phases=(PhaseConfig(2, 5e-3, True), PhaseConfig(2, 5e-4, False)),
                         **dict(_CFG, model="vit"))
    mj = jax_vit_tiny(layers=1, preprocess_uint8=True)
    variables = mj.init(jax.random.PRNGKey(1), jnp.asarray(data[0][:1]), train=False)
    params = jax.tree.map(np.asarray, variables["params"])
    want = JitTrainer(mj, jcfg).fit(data, init_params=jax.tree.map(jnp.asarray, params))
    trainer = Trainer(vit_tiny(layers=1, preprocess_uint8=True), cfg, device="cpu")
    assert trainer._frozen_cache_ok()
    assert trainer._to_device(data[0]).dtype == torch.uint8
    got = trainer.fit(data, init_params=vit_params_from_jax(params))
    for k in ("loss", "train_acc", "test_acc"):
        assert got.history[k].shape == (4,)
        np.testing.assert_allclose(got.history[k], want.history[k], rtol=1e-4, atol=1e-4, err_msg=k)
    np.testing.assert_allclose(got.outputs_test, want.outputs_test, rtol=1e-4, atol=1e-4)


def test_vit_frozen_cache_matches_full_frozen_phase(rng):
    data = _frames(rng, 9, 4)
    cfg = FinetuneConfig(
        phases=(PhaseConfig(2, 5e-3, True), PhaseConfig(1, 5e-4, False)),
        **dict(_CFG, model="vit", shuffle=True))
    on = Trainer(vit_tiny(layers=1, preprocess_uint8=True), cfg, device="cpu")
    off = Trainer(vit_tiny(layers=1, preprocess_uint8=True),
                  dataclasses.replace(cfg, cache_frozen_features=False), device="cpu")
    assert on._frozen_cache_ok() and not off._frozen_cache_ok()
    r_on, r_off = on.fit(data, seed=3), off.fit(data, seed=3)
    for k in ("loss", "train_acc", "test_acc"):
        np.testing.assert_allclose(r_on.history[k], r_off.history[k], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(r_on.outputs_test, r_off.outputs_test, rtol=1e-5, atol=1e-5)
    for name in r_on.params:
        np.testing.assert_allclose(r_on.params[name].numpy(), r_off.params[name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
