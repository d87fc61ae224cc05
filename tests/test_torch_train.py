"""The port's optimizer and trainer against the JAX package's: one AdamW step
against ``adam_update`` with frozen leaves, the two-phase ``fit`` trajectory
against ``JitTrainer`` on the same weights and data (AST, and ViT on uint8
frames), and the frozen-feature cache against the full frozen phase."""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eav_tpu.core.config import FinetuneConfig as JaxFinetuneConfig
from eav_tpu.core.config import PhaseConfig as JaxPhaseConfig
from eav_tpu.core.optim import adam_update, init_adam_state
from eav_tpu.models.ast import ast_tiny as jax_ast_tiny
from eav_tpu.models.vit import vit_tiny as jax_vit_tiny
from eav_tpu.train.loop import JitTrainer
from eav_tpu_torch.core.config import FinetuneConfig, PhaseConfig
from eav_tpu_torch.core.device import deterministic_algorithms
from eav_tpu_torch.core.optim import make_optimizer, set_trainable
from eav_tpu_torch.models.ast import ast_tiny
from eav_tpu_torch.models.dropout import set_generator
from eav_tpu_torch.models.bridge import ast_params_from_jax, vit_params_from_jax
from eav_tpu_torch.models.vit import vit_tiny
from eav_tpu_torch.train.loop import StepGraph, Trainer, cross_entropy


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
    trainer = Trainer(ast_tiny(layers=1), cfg, device="cpu")
    got = trainer.fit(data, init_params=ast_params_from_jax(params))
    # a CPU fit never captures a graph: 4 epochs of 3 steps, all eager
    assert trainer.step_counts == {"eager": 12, "captured": 0, "replayed": 0}
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


# -- the EEG trainer features: compat flags, max-norm, dropout generator ----

from eav_tpu.core.optim import maxnorm_project as jax_maxnorm_project  # noqa: E402
from eav_tpu.models.conformer_eeg import ConformerEEG as JaxConformerEEG  # noqa: E402
from eav_tpu.models.eegnet import EEGNet as JaxEEGNet  # noqa: E402
from eav_tpu_torch.core.config import get_preset  # noqa: E402
from eav_tpu_torch.core.optim import maxnorm_project  # noqa: E402
from eav_tpu_torch.models.bridge import (  # noqa: E402
    conformer_params_from_jax,
    eegnet_params_from_jax,
)
from eav_tpu_torch.models.conformer_eeg import ConformerEEG  # noqa: E402
from eav_tpu_torch.models.eegnet import EEGNet  # noqa: E402

EEGNET_TINY = dict(chans=4, samples=64, kern_length=16, f1=4, d=2, f2=8)
CONFORMER_TINY = dict(chans=4, samples=100, num_layers=2)


def test_compat_softmax_cross_entropy_matches_jax(rng):
    from eav_tpu.train.loop import cross_entropy as jax_cross_entropy

    logits = rng.normal(size=(6, 5)).astype(np.float32) * 3
    labels = rng.integers(0, 5, size=6).astype(np.int32)
    want = jax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels), jnp.ones(6, jnp.float32),
                             compat_softmax=True)
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels).long(),
                        compat_softmax=True)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    plain = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels).long())
    assert not np.isclose(float(got), float(plain))


def test_maxnorm_project_matches_jax(rng):
    """EEGNet's rules on weights scaled so some units exceed their norm and
    some do not: the same projection as JAX's, and untouched leaves."""
    x = np.zeros((1, 4, 64), np.float32)
    mj = JaxEEGNet(**EEGNET_TINY)
    variables = jax.tree.map(np.asarray, mj.init(jax.random.PRNGKey(0), x, train=False))
    params = jax.tree.map(lambda p: p * rng.uniform(0.2, 3.0, size=p.shape).astype(np.float32),
                          variables["params"])
    want = eegnet_params_from_jax(jax.tree.map(np.asarray, jax_maxnorm_project(
        jax.tree.map(jnp.asarray, params), mj.maxnorm_rules)), variables["batch_stats"])
    model = EEGNet(**EEGNET_TINY)
    model.load_state_dict(eegnet_params_from_jax(params, variables["batch_stats"]))
    maxnorm_project(model, model.maxnorm_rules)
    for name, value in model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), rtol=1e-6, atol=1e-6,
                                   err_msg=name)
    norms = model.conv_depthwise.weight.detach().square().sum((1, 2, 3)).sqrt()
    assert bool((norms <= 1.0 + 1e-5).all())


def _eeg_data(rng, chans, samples, n_train=10, n_test=5):
    return (
        rng.normal(size=(n_train, chans, samples)).astype(np.float32),
        rng.integers(0, 5, size=n_train).astype(np.int32),
        rng.normal(size=(n_test, chans, samples)).astype(np.float32),
        rng.integers(0, 5, size=n_test).astype(np.int32),
    )


def _eeg_cfgs(model, lr, sticky):
    kw = dict(model=model, batch_size=4, optimizer="adam", weight_decay=0.0, shuffle=False,
              compat_softmax=True, compat_sticky_eval=sticky)
    return (JaxFinetuneConfig(phases=(JaxPhaseConfig(3, lr, False),), **kw),
            FinetuneConfig(phases=(PhaseConfig(3, lr, False),), **kw))


@pytest.mark.parametrize("sticky", [True, False])
def test_eegnet_fit_matches_jit_trainer(rng, sticky):
    """Tiny EEGNet, dropout 0, in-order batches with a partial last one, the
    double softmax, max-norm after every step; with the sticky eval mode
    (epochs 2-3 train on frozen running stats) and without. Per-epoch
    history, test logits and the final weights and stats agree."""
    data = _eeg_data(rng, 4, 64)
    jcfg, cfg = _eeg_cfgs("eegnet", 1e-2, sticky)
    mj = JaxEEGNet(**EEGNET_TINY, dropout_rate=0.0)
    variables = jax.tree.map(np.asarray, mj.init(jax.random.PRNGKey(1), data[0][:1], train=False))
    want = JitTrainer(mj, jcfg, maxnorm_rules=mj.maxnorm_rules).fit(
        data, init_params=jax.tree.map(jnp.asarray, variables["params"]))
    trainer = Trainer(EEGNet(**EEGNET_TINY, dropout_rate=0.0), cfg, device="cpu")
    assert not trainer._frozen_cache_ok()
    got = trainer.fit(data, init_params=eegnet_params_from_jax(variables["params"],
                                                                variables["batch_stats"]))
    for k in ("loss", "train_acc", "test_acc"):
        assert got.history[k].shape == (3,)
        np.testing.assert_allclose(got.history[k], want.history[k], rtol=1e-4, atol=1e-4, err_msg=k)
    np.testing.assert_allclose(got.outputs_test, want.outputs_test, rtol=1e-4, atol=1e-4)
    final = eegnet_params_from_jax(jax.tree.map(np.asarray, want.params),
                                   jax.tree.map(np.asarray, want.batch_stats))
    for name, value in final.items():
        if not name.endswith("num_batches_tracked"):  # Flax keeps no count
            np.testing.assert_allclose(got.params[name].numpy(), value.numpy(), rtol=1e-4,
                                       atol=1e-4, err_msg=name)


def _rounding_level_leaves(mj, variables, x, y) -> set:
    """The parameters whose reference gradient on the batch ``(x, y)``, in
    train mode, is at float32 rounding level (below 1e-6 of the largest
    gradient entry), in the port's names."""
    from eav_tpu.train.loop import cross_entropy as jax_cross_entropy

    def loss(p):
        logits, _ = mj.apply({"params": p, "batch_stats": variables["batch_stats"]},
                             jnp.asarray(x), train=True, mutable=["batch_stats"],
                             rngs={"dropout": jax.random.PRNGKey(0)})
        return jax_cross_entropy(logits, jnp.asarray(y), jnp.ones(len(y), jnp.float32),
                                 compat_softmax=True)

    grads = jax.grad(loss)(jax.tree.map(jnp.asarray, variables["params"]))
    named = conformer_params_from_jax(jax.tree.map(np.asarray, grads), variables["batch_stats"])
    names = {n for n, _ in ConformerEEG(**CONFORMER_TINY).named_parameters()}
    top = max(float(named[n].abs().max()) for n in names)
    return {n for n in names if float(named[n].abs().max()) < 1e-6 * top}


def test_conformer_fit_matches_jit_trainer(rng):
    """Tiny conformer at the preset's lr 1e-3, with the 0.5 head max-norm
    binding from the first step (the head's initial row norms are about 1).

    The last layer's norm2 bias feeds a train-mode BatchNorm, which removes
    any per-channel shift: its gradient is exactly zero, the reference's
    reads at rounding level (6e-8 of the largest; the next leaf's 1e-2), so
    Adam turns roundoff into steps of about lr whose sign the roundoff sets
    (as for AST's key bias above), and the BatchNorm's running mean follows
    that walk. Those two are left out of the leaf-by-leaf check and the test
    logits, which read both, get 3e-4 (they drift by 1.3e-4 in 9 steps); with
    the reference's values of the two loaded, the port's logits agree to
    1e-4. The history is train mode, where the shift cancels: 1e-4."""
    data = _eeg_data(rng, 4, 100)
    jcfg, cfg = _eeg_cfgs("conformer_eeg", 1e-3, False)
    assert cfg.phases[0].lr == get_preset("conformer_eeg").finetune.phases[0].lr
    mj = JaxConformerEEG(**CONFORMER_TINY, dropout=0.0)
    variables = jax.tree.map(np.asarray, mj.init(
        {"params": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)}, data[0][:1],
        train=False))
    init = conformer_params_from_jax(variables["params"], variables["batch_stats"])
    assert float(init["head.weight"].norm(dim=1).min()) > 0.5
    walk = _rounding_level_leaves(mj, variables, data[0][:4], data[1][:4])
    last = f"layers.{CONFORMER_TINY['num_layers'] - 1}"
    assert walk == {f"{last}.norm2.bias"}  # the bias that feeds the BatchNorm
    walk |= {"bn.running_mean"}
    want = JitTrainer(mj, jcfg, maxnorm_rules=mj.maxnorm_rules).fit(
        data, init_params=jax.tree.map(jnp.asarray, variables["params"]))
    trainer = Trainer(ConformerEEG(**CONFORMER_TINY, dropout=0.0), cfg, device="cpu")
    got = trainer.fit(data, init_params=init)
    for k in ("loss", "train_acc", "test_acc"):
        np.testing.assert_allclose(got.history[k], want.history[k], rtol=1e-4, atol=1e-4, err_msg=k)
    np.testing.assert_allclose(got.outputs_test, want.outputs_test, rtol=3e-4, atol=3e-4)
    assert float(got.params["head.weight"].norm(dim=1).max()) <= 0.5 + 1e-6
    final = conformer_params_from_jax(jax.tree.map(np.asarray, want.params),
                                      jax.tree.map(np.asarray, want.batch_stats))
    for name, value in final.items():
        if name.endswith("num_batches_tracked") or name in walk:
            continue
        np.testing.assert_allclose(got.params[name].numpy(), value.numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    patched = dict(got.params, **{n: final[n] for n in walk})
    np.testing.assert_allclose(trainer.predict(data[2], params=patched), want.outputs_test,
                               rtol=1e-4, atol=1e-4)


def test_dropout_fit_repeats_under_one_seed(rng):
    """Dropout 0.5 with shuffled batches: one seed, one fit; another seed,
    another fit. The BN buffers travel in ``params``."""
    data = _eeg_data(rng, 4, 64, 12, 4)
    cfg = FinetuneConfig(model="eegnet", batch_size=4, optimizer="adam", weight_decay=0.0,
                         phases=(PhaseConfig(2, 1e-2, False),), compat_softmax=True,
                         compat_sticky_eval=True)
    trainer = Trainer(EEGNet(**EEGNET_TINY, dropout_rate=0.5), cfg, device="cpu")
    a, b, c = trainer.fit(data, seed=4), trainer.fit(data, seed=4), trainer.fit(data, seed=5)
    np.testing.assert_array_equal(a.outputs_test, b.outputs_test)
    np.testing.assert_array_equal(a.history["loss"], b.history["loss"])
    assert not np.array_equal(a.outputs_test, c.outputs_test)
    assert "bn_temporal.running_var" in a.params


def test_sticky_eval_stops_the_running_stats_after_the_first_epoch(rng):
    data = _eeg_data(rng, 4, 64)
    stats = {}
    for epochs in (1, 3):
        cfg = FinetuneConfig(model="eegnet", batch_size=4, optimizer="adam", weight_decay=0.0,
                             phases=(PhaseConfig(epochs, 1e-2, False),), compat_sticky_eval=True)
        stats[epochs] = Trainer(EEGNet(**EEGNET_TINY), cfg, device="cpu").fit(data, seed=1).params
    for name in ("bn_temporal.running_mean", "bn_separable.running_var"):
        assert torch.equal(stats[1][name], stats[3][name]), name
    assert not torch.equal(stats[1]["head.weight"], stats[3]["head.weight"])


def test_adam_decays_nothing_and_unknown_optimizers_raise():
    cfg = FinetuneConfig(model="eegnet", batch_size=4, optimizer="adam", weight_decay=0.5,
                         phases=(PhaseConfig(1, 1e-3, False),))
    opt = make_optimizer(EEGNet(**EEGNET_TINY), cfg)
    assert opt.param_groups[0]["weight_decay"] == 0.0
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer(EEGNet(**EEGNET_TINY), dataclasses.replace(cfg, optimizer="sgd"))


def test_cache_gate_refuses_maxnorm_rules():
    cfg = FinetuneConfig(phases=(PhaseConfig(1, 5e-3, True),), **_CFG)
    model = ast_tiny()
    model.maxnorm_rules = ((r"^classifier\.weight$", 1.0, (1,)),)
    assert not Trainer(model, cfg, device="cpu")._frozen_cache_ok()


# ---------------------------------------------------------------------------
# When a step may run as a CUDA graph: decided on the CPU with the trainer's
# device named 'cuda' (its tensors stay on the CPU) and the graph's own
# stream work replaced by the eager body.
# ---------------------------------------------------------------------------


def test_cpu_fits_run_every_step_eagerly(rng):
    """Two phases, shuffled, a partial last batch, dropout: every step of a
    CPU fit is eager, no step is kept, and the fit repeats under its seed."""
    data = _data(rng, 10, 3)
    cfg = FinetuneConfig(phases=(PhaseConfig(1, 5e-3, True), PhaseConfig(2, 5e-4, False)),
                         **dict(_CFG, shuffle=True))
    trainer = Trainer(ast_tiny(layers=1, dropout=0.1), cfg, device="cpu")
    a = trainer.fit(data, seed=5)
    assert trainer.step_counts == {"eager": 9, "captured": 0, "replayed": 0}
    assert not trainer._graphs
    b = trainer.fit(data, seed=5)
    np.testing.assert_array_equal(a.outputs_test, b.outputs_test)
    np.testing.assert_array_equal(a.history["loss"], b.history["loss"])


def _as_if_on_cuda(model, **adamw):
    """A trainer that takes itself to be on the card, with a capturable
    AdamW, whose eager step, warm-up, capture and replay each only log
    their name (a capturable AdamW cannot step on the CPU)."""
    cfg = FinetuneConfig(phases=(PhaseConfig(1, 1e-3, False),), **_CFG)
    trainer = Trainer(model, cfg, device="cpu")
    trainer.device = torch.device("cuda")
    opt = torch.optim.AdamW(trainer.model.parameters(), lr=1e-3, capturable=True, **adamw)
    calls = []

    def logged(name, then=None):
        def run(graph=None, *args):
            calls.append(name)
            if then is not None:
                then(graph)
            return torch.zeros(()), torch.zeros((), dtype=torch.long)
        return run

    trainer._step = logged("eager")
    trainer._warm_up = logged("warm_up")
    trainer._capture = logged("capture", lambda graph: setattr(graph, "graph", "captured"))
    trainer._replay = logged("replay")
    return trainer, opt, calls


def _batch(rng, n=4):
    return (torch.from_numpy(rng.normal(size=(n, 128, 128)).astype(np.float32)),
            torch.from_numpy(rng.integers(0, 5, size=n)))


def test_a_step_runs_eagerly_then_is_captured_then_replays(rng):
    """The first call with a key is an eager step (on the side stream), the
    second captures and replays, later ones replay; a partial batch is a
    step of its own; the graphs go with ``drop_graphs`` and with a new
    optimizer state."""
    trainer, opt, calls = _as_if_on_cuda(ast_tiny(layers=1, dropout=0.1))
    trainer.model.train()
    x, y = _batch(rng)
    for _ in range(4):
        trainer.train_step(opt, x, y)
    trainer.train_step(opt, x[:3], y[:3])
    # the capture's call replays the graph once, to do that call's work
    assert calls == ["warm_up", "capture", "replay", "replay", "replay", "warm_up"]
    assert trainer.step_counts == {"eager": 2, "captured": 1, "replayed": 2}
    assert len(trainer._graphs) == 2
    assert all(isinstance(g, StepGraph) and g.opt is opt for g in trainer._graphs.values())
    trainer.drop_graphs()
    assert not trainer._graphs
    trainer.train_step(opt, x, y)
    assert calls[-1] == "warm_up"


def test_new_optimizer_state_drops_the_graphs_and_no_cycle_keeps_them(rng):
    """``opt.load_state_dict`` (a resumed phase's) drops the trainer's
    graphs; the optimizer's hook holds the trainer weakly, so a trainer that
    kept graphs goes, with their memory, as soon as it is dropped, without
    waiting for the garbage collector."""
    import gc
    import weakref

    trainer, opt, calls = _as_if_on_cuda(ast_tiny(layers=1))
    x, y = _batch(rng)
    for _ in range(3):
        trainer.train_step(opt, x, y)
    assert len(trainer._graphs) == 1
    opt.load_state_dict(opt.state_dict())
    assert not trainer._graphs
    trainer.train_step(opt, x, y)
    assert calls[-1] == "warm_up" and len(trainer._graphs) == 1
    gone = weakref.ref(trainer)
    gc.disable()
    try:
        del trainer, calls
        assert gone() is None
    finally:
        gc.enable()


def _hook_module(trainer):
    return trainer.model.register_forward_hook(lambda *args: None)


def _pre_hook_module(trainer):
    return trainer.model.encoder.register_forward_pre_hook(lambda *args: None)


def _backward_hook_module(trainer):
    return trainer.model.classifier.register_full_backward_hook(lambda *args: None)


def _global_hook(trainer):
    return torch.nn.modules.module.register_module_forward_hook(lambda *args: None)


def _global_pre_hook(trainer):
    return torch.nn.modules.module.register_module_forward_pre_hook(lambda *args: None)


@pytest.mark.parametrize("register", [_hook_module, _pre_hook_module, _backward_hook_module,
                                      _global_hook, _global_pre_hook])
def test_a_registered_hook_keeps_steps_eager(rng, register):
    """A hook's Python would run only at capture: with one registered, on the
    model or for every module, steps run eagerly; once removed, the next
    step is a warm-up."""
    trainer, opt, calls = _as_if_on_cuda(ast_tiny(layers=1))
    x, y = _batch(rng)
    handle = register(trainer)
    try:
        for _ in range(3):
            trainer.train_step(opt, x, y)
    finally:
        handle.remove()
    assert calls == ["eager"] * 3 and trainer.step_counts["eager"] == 3 and not trainer._graphs
    trainer.train_step(opt, x, y)
    assert calls[-1] == "warm_up"


def _anomaly_mode(trainer, opt):
    return torch.autograd.detect_anomaly()


def _data_parallel(trainer, opt):
    trainer._shards.group = object()  # a data axis: the step all-reduces
    return contextlib.nullcontext()


def _cpu_generator(trainer, opt):
    set_generator(trainer.model, torch.Generator().manual_seed(0))
    return contextlib.nullcontext()


def _not_capturable(trainer, opt):
    for group in opt.param_groups:
        group["capturable"] = False
    return contextlib.nullcontext()


def _off_the_card(trainer, opt):
    trainer.device = torch.device("cpu")
    return contextlib.nullcontext()


@pytest.mark.parametrize("condition", [_anomaly_mode, _data_parallel, _cpu_generator,
                                       _not_capturable, _off_the_card])
def test_the_eager_conditions(rng, condition):
    """No key, so an eager step, off the card, in a data-parallel fit, in
    anomaly mode, with an optimizer that is not capturable, and with a
    Dropout drawing from a generator no graph can register (on the CPU);
    without the condition the same step has a key."""
    trainer, opt, _ = _as_if_on_cuda(ast_tiny(layers=1, dropout=0.1))
    trainer.model.train()
    x, y = _batch(rng)
    assert trainer._graph_key(opt, x, y, "full", None) is not None
    with condition(trainer, opt):
        assert trainer._graph_key(opt, x, y, "full", None) is None


def test_the_step_key_follows_what_the_graph_bakes_in(rng):
    """The key holds still for the same step, and changes with the lr, the
    weight decay, the trainable set, train/eval, the batch's shape, the
    mode, the optimizer and the deterministic mode."""
    trainer, opt, _ = _as_if_on_cuda(ast_tiny(layers=1))
    x, y = _batch(rng)

    def key(opt=opt, x=x, y=y, mode="full"):
        return trainer._graph_key(opt, x, y, mode, None)

    first = key()
    assert key() == first
    seen = {first}

    def changed():
        k = key()
        assert k not in seen
        seen.add(k)

    opt.param_groups[0]["lr"] = 2e-3
    changed()
    opt.param_groups[0]["weight_decay"] = 0.5
    changed()
    set_trainable(trainer.model, True)
    changed()
    trainer.model.eval()
    changed()
    assert key(x=x[:3], y=y[:3]) not in seen
    assert key(mode="features") not in seen
    other = torch.optim.AdamW(trainer.model.parameters(), lr=2e-3, weight_decay=0.5,
                              capturable=True)
    assert key(opt=other) not in seen
    with deterministic_algorithms(True):
        assert key() not in seen


def test_make_optimizer_builds_the_plain_adamw():
    """Every caller (the trainer, the stacked trainer, the scripts) gets
    the foreach AdamW, not capturable and not fused, on any device."""
    cfg = FinetuneConfig(model="eegnet", batch_size=4, phases=(PhaseConfig(1, 1e-3, False),))
    for device in ("cpu", "meta"):
        opt = make_optimizer(EEGNet(**EEGNET_TINY).to(device), cfg)
        assert [g["capturable"] for g in opt.param_groups] == [False]
        assert not opt.defaults["fused"]


def test_a_step_on_the_card_makes_the_trainers_adamw_capturable(rng):
    """The trainer's first step on the card makes ``make_optimizer``'s AdamW
    capturable, also a step a hook or a data-parallel fit keeps eager (how
    a step runs changes no number); a step off the card leaves it plain."""
    x, y = _batch(rng)

    def data_parallel(trainer):
        trainer._shards.group = object()

    def off_the_card(trainer):
        trainer.device = torch.device("cpu")

    for setup, want, first in ((None, True, "warm_up"), (_hook_module, True, "eager"),
                               (data_parallel, True, "eager"), (off_the_card, False, "eager")):
        trainer, _, calls = _as_if_on_cuda(ast_tiny(layers=1))
        opt = make_optimizer(trainer.model, trainer.cfg)
        if setup is not None:
            setup(trainer)
        trainer.train_step(opt, x, y)
        assert [g["capturable"] for g in opt.param_groups] == [want]
        assert calls == [first]


def test_make_capturable_moves_step_counts_beside_their_parameters():
    """Step counts an earlier plain step left on the host move to their
    parameter's device as float32; a parameter without state gets none; an
    optimizer without the setting is left as it is."""
    from eav_tpu_torch.train.loop import make_capturable

    params = [torch.nn.Parameter(torch.zeros(3, device="meta")) for _ in range(2)]
    opt = torch.optim.AdamW(params, lr=1e-3)
    opt.state[params[0]]["step"] = torch.tensor(4.0)
    make_capturable(opt)
    assert [g["capturable"] for g in opt.param_groups] == [True]
    step = opt.state[params[0]]["step"]
    assert step.device.type == "meta" and step.dtype == torch.float32
    assert params[1] not in opt.state
    cpu = torch.nn.Parameter(torch.ones(3))
    opt = torch.optim.AdamW([cpu], lr=1e-3)
    cpu.grad = torch.ones(3)
    opt.step()
    make_capturable(opt)
    assert opt.param_groups[0]["capturable"] and float(opt.state[cpu]["step"]) == 1.0
    sgd = torch.optim.SGD(params, lr=0.1)
    make_capturable(sgd)
    assert "capturable" not in sgd.param_groups[0]
