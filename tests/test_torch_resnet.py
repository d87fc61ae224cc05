"""The port's ResNetAttn against the JAX package's on the same weights
(through ``models/bridge.py``) at 64 x 64, batch 2: eval logits, and the
loss, gradients and BatchNorm running stats of one train-mode step, in
float32 and, for every gradient, in float64; the frozen protocol (the
backbone frozen, its running stats moving); the torchvision-layout import
against a hand-written torch backbone (the oracle of
tests/test_resnet_import.py); the partial overlay of ``EAV_TPU_RESNET_CKPT``;
and ``run_vision(1, "vision_resnet")`` against the JAX pipeline on a
synthetic frame cache, with three planted faults its check must catch."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from eav_tpu.core.config import get_preset as jax_get_preset
from eav_tpu.models import norm as jax_norm
from eav_tpu.models.resnet_attn import ResNetAttn as JaxResNetAttn
from eav_tpu.train import pipeline as JP
from eav_tpu.train.loop import cross_entropy as jax_cross_entropy
from eav_tpu_torch.core.config import FinetuneConfig, PhaseConfig, get_preset
from eav_tpu_torch.models.bridge import resnet_attn_params_from_jax
from eav_tpu_torch.models.resnet_attn import ResNetAttn, convert_torchvision_resnet50
from eav_tpu_torch.train import pipeline as P
from eav_tpu_torch.train.loop import Trainer
from test_resnet_import import _randomized_torch_backbone


@pytest.fixture(scope="module")
def jax_variables():
    """Flax ResNetAttn variables at (2, 64, 64, 3), running stats moved off
    their init so that the bridge's mapping of them is exercised."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    v = jax.tree.map(np.asarray, jax.jit(lambda k, x0: JaxResNetAttn().init(k, x0))(
        jax.random.PRNGKey(0), x))
    stats = jax.tree.map(lambda a: a, v["batch_stats"])
    for path, leaf in jax.tree_util.tree_flatten_with_path(stats)[0]:
        node = stats
        for key in path[:-1]:
            node = node[key.key]
        name = path[-1].key
        node[name] = (rng.normal(size=leaf.shape) * 0.1 if name == "mean"
                      else rng.uniform(0.5, 1.5, size=leaf.shape)).astype(np.float32)
    return x, v["params"], stats


def _port(params, stats) -> ResNetAttn:
    m = ResNetAttn()
    m.load_state_dict(resnet_attn_params_from_jax(params, stats))
    return m


def test_eval_logits_match_jax(jax_variables):
    x, params, stats = jax_variables
    want = np.asarray(jax.jit(JaxResNetAttn().apply)({"params": params, "batch_stats": stats},
                                                      x))
    with torch.no_grad():
        got = _port(params, stats).eval()(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 5) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_train_step_matches_jax(jax_variables):
    """One train-mode step in float32: loss, logits (1e-3 of their scale),
    the updated running stats (1e-4) and the gradients of the attention and
    head (1e-3 of each leaf's largest entry). The backbone's float32
    gradients are ill-conditioned at a random init (the port's own part
    from its float64 ones by tenths of a leaf's largest entry), so they are
    held in float64, below."""
    x, params, stats = jax_variables
    y = np.array([1, 3], np.int32)

    def loss(p):
        logits, upd = JaxResNetAttn().apply({"params": p, "batch_stats": stats}, x, train=True,
                                            mutable=["batch_stats"])
        return jax_cross_entropy(logits, jnp.asarray(y), jnp.ones(2, jnp.float32)), (logits, upd)

    f32 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), params)
    (want_loss, (want_logits, upd)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(f32)
    want = resnet_attn_params_from_jax(jax.tree.map(np.asarray, grads),
                                       jax.tree.map(np.asarray, upd["batch_stats"]))
    m = _port(params, stats).train()
    logits = m(torch.from_numpy(x))
    loss_t = F.cross_entropy(logits, torch.from_numpy(y).long())
    loss_t.backward()
    assert float(loss_t.detach()) == pytest.approx(float(want_loss), rel=1e-4, abs=1e-5)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits), rtol=0,
                               atol=1e-3 * np.abs(np.asarray(want_logits)).max())
    for name, p in m.named_parameters():
        if not name.startswith("backbone."):
            w = want[name].numpy()
            np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=1e-3 * np.abs(w).max(),
                                       err_msg=name)
    for name, b in m.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(b.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-4,
                                       err_msg=name)


class _Float64Numpy:
    """``jax.numpy`` with ``float32`` read as ``float64``: the JAX package's
    ``TorchBatchNorm`` pins its statistics to ``jnp.float32``, and through
    this namespace it computes them in float64 like the rest of the model."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


def test_train_step_gradients_match_jax_in_float64(jax_variables, monkeypatch):
    """One train-mode step in float64 on both sides, where the backbone's
    gradients are well-conditioned: every gradient, the backbone's included,
    to 1e-6 of each leaf's largest entry, and the running stats to 1e-6
    (measured: 6e-8; both models hand float32 logits to the loss)."""
    x, params, stats = jax_variables
    y = np.array([1, 3], np.int32)
    monkeypatch.setattr(jax_norm, "jnp", _Float64Numpy())

    def loss(p):
        logits, upd = JaxResNetAttn().apply({"params": p, "batch_stats": stats},
                                            jnp.asarray(x, jnp.float64), train=True,
                                            mutable=["batch_stats"])
        return jax_cross_entropy(logits, jnp.asarray(y), jnp.ones(2, jnp.float32)), upd

    f64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
    (want_loss, upd), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(f64)
    assert jax.tree.leaves(grads)[0].dtype == jnp.float64
    want = resnet_attn_params_from_jax(jax.tree.map(np.asarray, grads),
                                       jax.tree.map(np.asarray, upd["batch_stats"]))
    m = _port(params, stats).double().train()
    loss_t = F.cross_entropy(m(torch.from_numpy(x).double()), torch.from_numpy(y).long())
    loss_t.backward()
    assert float(loss_t.detach()) == pytest.approx(float(want_loss), rel=1e-6)
    for name, p in m.named_parameters():
        assert p.grad.dtype == torch.float64
        w = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=1e-6 * np.abs(w).max(),
                                   err_msg=name)
    for name, b in m.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(b.numpy(), want[name].numpy(), rtol=1e-6, atol=1e-6,
                                       err_msg=name)


def _data(rng, n_train=6, n_test=3, side=32):
    return (rng.normal(size=(n_train, side, side, 3)).astype(np.float32),
            (np.arange(n_train) % 5).astype(np.int32),
            rng.normal(size=(n_test, side, side, 3)).astype(np.float32),
            (np.arange(n_test) % 5).astype(np.int32))


def test_frozen_protocol(rng):
    """A frozen epoch trains attention and head only: the backbone's
    weights stay bit for bit (no AdamW decay either), its BatchNorm running
    stats move (train mode), and the frozen-feature cache stays off."""
    cfg = FinetuneConfig(model="resnet_attn", batch_size=4, weight_decay=0.01,
                         phases=(PhaseConfig(1, 5e-4, True),))
    trainer = Trainer(ResNetAttn(), cfg, ResNetAttn.HEAD_REGEX, device="cpu")
    assert not trainer._frozen_cache_ok()
    init = {k: v.clone() for k, v in ResNetAttn(generator=torch.Generator().manual_seed(0))
            .state_dict().items()}
    res = trainer.fit(_data(rng), seed=0)
    for name, value in init.items():
        moved = not torch.equal(res.params[name], value)
        if name.startswith("backbone.") and name.endswith(("running_mean", "running_var",
                                                           "num_batches_tracked")):
            assert moved, name
        elif name.startswith("backbone."):
            assert not moved, name
        elif name.endswith("weight"):  # attention and head
            assert moved, name


def test_torchvision_import_matches_torch_backbone(rng):
    """A torchvision-layout state dict (randomized BN affine and stats) gives
    the hand-written torch backbone's features to 1e-4 of their scale."""
    m = _randomized_torch_backbone(seed=0)
    sd = {**m.state_dict(), "fc.weight": torch.zeros(1000, 2048), "fc.bias": torch.zeros(1000)}
    converted = convert_torchvision_resnet50(sd)
    assert all(k.startswith("backbone.") for k in converted)
    model = ResNetAttn()
    assert not model.load_state_dict(converted, strict=False).unexpected_keys
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        want = m(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
        got = model.eval().backbone(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == want.shape == (2, 2048, 2, 2)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    with pytest.raises(KeyError):
        convert_torchvision_resnet50({k: v for k, v in sd.items() if "layer4.2" not in k})


def test_pretrained_overlay_is_the_backbone_only(tmp_path, monkeypatch, rng):
    """``EAV_TPU_RESNET_CKPT`` -> ``_pretrained_params``: the ``backbone.*``
    weights and BN stats only (cached per path), overlaid on the seeded
    init so that attention and head start fresh; after a frozen fit the
    backbone's weights still equal the checkpoint's. A path that names no
    file raises; an unset variable gives None."""
    monkeypatch.delenv("EAV_TPU_RESNET_CKPT", raising=False)
    assert P._pretrained_params("resnet_attn", 5) is None
    path = tmp_path / "resnet50-seeded.pth"
    torch.save(_randomized_torch_backbone(seed=1).state_dict(), str(path))
    monkeypatch.setenv("EAV_TPU_RESNET_CKPT", str(path))
    cache = {}
    init = P._pretrained_params("resnet_attn", 5, cache)
    assert P._pretrained_params("resnet_attn", 5, cache) is init
    fresh = ResNetAttn(generator=torch.Generator().manual_seed(0)).state_dict()
    assert set(init) == {k for k in fresh if k.startswith("backbone.")}
    cfg = FinetuneConfig(model="resnet_attn", batch_size=6, weight_decay=0.01,
                         phases=(PhaseConfig(1, 1e-3, True),))
    res = Trainer(ResNetAttn(), cfg, ResNetAttn.HEAD_REGEX, device="cpu").fit(
        _data(rng), seed=0, init_params=init)
    for name, value in init.items():
        if not name.endswith(("running_mean", "running_var", "num_batches_tracked")):
            assert torch.equal(res.params[name], value), name
    # the attention started from the seeded init: one Adam step moves an
    # entry by about lr, where the init's entries are ~0.02 apart
    moved = (res.params["attn_fc1.weight"] - fresh["attn_fc1.weight"]).abs().max()
    assert 0 < float(moved) <= 2e-3
    monkeypatch.setenv("EAV_TPU_RESNET_CKPT", str(tmp_path / "missing.pth"))
    with pytest.raises(FileNotFoundError):
        P._pretrained_params("resnet_attn", 5)


def _vision_preset(get, **finetune):
    """``resnet_vision`` cut to a frame cache of 10 trials x 2 uint8 24 x 24
    frames (one trial a class trains, one tests) at ``image_size`` 64:
    1 frozen + 1 unfrozen epoch of 5 in-order steps at batch 2."""
    base = get("resnet_vision")
    return base.replace(
        split=dataclasses.replace(base.split, h_idx=1),
        vision=dataclasses.replace(base.vision, frames_per_sample=2, face_image_size=24),
        finetune=dataclasses.replace(base.finetune, **{
            "batch_size": 2, "shuffle": False, "model_kwargs": {"image_size": 64},
            "phases": tuple(dataclasses.replace(p, epochs=1) for p in base.finetune.phases),
            **finetune}))


@pytest.fixture(scope="module")
def vision_fits(tmp_path_factory):
    """JAX's ``run_vision(1, "vision_resnet")`` on a synthetic frame cache,
    its trained weights and the init it drew for the subject's seed, and a
    function that runs the port's from that init with overrides of the
    preset's finetune config."""
    root = tmp_path_factory.mktemp("vision_resnet")
    rng = np.random.default_rng(5)
    x = rng.integers(0, 256, size=(10, 2, 24, 24, 3), dtype=np.uint8)
    y = (np.arange(10) % 5).astype(np.int32)
    key = f"s01_vis_{P._cfg_hash(_vision_preset(get_preset).vision)}.npz"
    assert key == f"s01_vis_{JP._cfg_hash(_vision_preset(jax_get_preset).vision)}.npz"
    for d in ("jc", "tc"):
        os.makedirs(root / d)
        np.savez(root / d / key, x=x, y=y)
    with pytest.MonkeyPatch.context() as mp:
        orig = JP._model_kwargs  # the JAX model takes no image_size; its pipeline reads it
        mp.setattr(JP, "_model_kwargs", lambda p: {
            k: v for k, v in orig(p).items() if k != "image_size"})
        jp = JP.ModalityPipelines(str(root / "EAV"), cache_dir=str(root / "jc"),
                                  presets={"vision_resnet": _vision_preset(jax_get_preset)})
        jax_trainer = jp._trainer("vision_resnet", jp.presets["vision_resnet"])
        fits = []
        fit = jax_trainer.fit
        jax_trainer.fit = lambda *a, **k: fits.append(fit(*a, **k)) or fits[-1]
        want = jp.task_fn(1, "vision_resnet")
        tr_f = jp._load_split_vision(1, "vision_resnet")[0]
    # JAX's init for the subject's seed, through the trainer's own compiled init
    k_init = jax.random.split(jax.random.PRNGKey(0 + 1))[1]
    (init_fn,) = jax_trainer._init_fn_cache.values()
    v = init_fn(k_init, tr_f[:1])
    init = resnet_attn_params_from_jax(*jax.tree.map(np.asarray, (v["params"],
                                                                  v["batch_stats"])))
    final = resnet_attn_params_from_jax(*jax.tree.map(np.asarray, (
        fits[0].params, fits[0].batch_stats)))

    def port(**finetune):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(P, "_pretrained_params", lambda *a: init)
            pipes = P.ModalityPipelines(
                str(root / "EAV"), cache_dir=str(root / "tc"),
                presets={"vision_resnet": _vision_preset(get_preset, **finetune)}, device="cpu")
            return pipes.task_fn(1, "vision_resnet")

    return want, final, port


def _assert_resnet_fit_close(got, want, steps=5):
    """The port's weights after ``_vision_preset``'s fit against JAX's, in
    float32 (measured readings in brackets):

    - attention and head: every entry within 1e-4 (+ 1e-4 of itself) but at
      most 2e-3 of a leaf [5.5e-4 at most], and those few within 2 lr a step
      (1.1 x: a bias-corrected Adam step can exceed lr a little): Adam's
      step is about lr * sign(g), so an entry whose gradient float32 cannot
      fix the sign of steps by +-lr in either package;
    - the same entries' mean shift toward zero, sign(w) * (a - w), within
      5e-8 [2.6e-9]: AdamW's decay shrinks every entry by lr * 0.01 * |w| a
      step, which dropped reads 4.6e-7;
    - the backbone (5 unfrozen steps at 5e-6): its float32 gradients are
      ill-conditioned, so an entry may part by 2 lr a step, but at most 30%
      of its entries by more than half a step [19%];
    - the BatchNorm running stats to 1e-2 of their scale [0.68%]: the
      statistics of those backbone weights' activations.

    Returns those readings (``pytest -s`` prints them)."""
    lrs = [p.lr for p in get_preset("resnet_vision").finetune.phases]
    head_bound = 1.1 * 2 * steps * sum(lrs)
    backbone_bound = 1.1 * 2 * steps * lrs[1]
    failed = []
    drift, n_head, off_backbone, n_backbone = 0.0, 0, 0, 0
    worst_head = worst_stats = 0.0
    for name, value in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        a, w = got[name].double().numpy(), value.double().numpy()
        err = np.abs(a - w)
        if name.endswith(("running_mean", "running_var")):
            scale = max(np.abs(w).max(), 1e-3)
            worst_stats = max(worst_stats, err.max() / scale)
            if err.max() > 1e-2 * scale:
                failed.append(f"{name}: running stat off by {err.max():.3g}")
        elif name.startswith("backbone."):
            if err.max() > backbone_bound:
                failed.append(f"{name}: backbone entry off by {err.max():.3g}")
            off_backbone += int((err > lrs[1] / 2).sum())
            n_backbone += err.size
        else:
            off = int((err > 1e-4 + 1e-4 * np.abs(w)).sum())
            worst_head = max(worst_head, off / err.size)
            if off > 2e-3 * err.size:
                failed.append(f"{name}: {off} head entries off by more than 1e-4")
            if err.max() > head_bound:
                failed.append(f"{name}: head entry off by {err.max():.3g}")
            drift += float((np.sign(w) * (a - w)).sum())
            n_head += err.size
    if abs(drift / n_head) > 5e-8:
        failed.append(f"head drift toward zero {drift / n_head:.3g}")
    if off_backbone > 0.3 * n_backbone:
        failed.append(f"backbone share off by half a step {off_backbone / n_backbone:.3g}")
    assert not failed, "\n".join(failed)
    return {"head share off, worst leaf": worst_head, "head drift": drift / n_head,
            "backbone share off": off_backbone / n_backbone, "running stats": worst_stats}


def test_run_vision_resnet_matches_jax(vision_fits):
    """``run_vision(1, "vision_resnet")`` from the weights JAX draws for the
    subject's seed: the same metrics row, and the trained weights and
    running stats by ``_assert_resnet_fit_close``. At batch 2: on the CPU,
    XLA's compiled gradient of the JAX model is wrong at batch 3 and 5, where
    the eager one agrees with the port's (tests/probe_resnet_jit.py), so
    JAX's fit is no reference there."""
    want, final, port = vision_fits
    got = port()
    assert got.metrics.keys() == want.metrics.keys()
    for k in ("accuracy", "weighted_f1", "final_train_acc", "epochs"):
        assert got.metrics[k] == pytest.approx(want.metrics[k], abs=1e-4), k
    assert got.metrics["confusion"] == want.metrics["confusion"]
    print(_assert_resnet_fit_close(got.artifacts["params"], final))


def _phases(unfrozen_lr_scale: float):
    frozen, unfrozen = get_preset("resnet_vision").finetune.phases
    return (dataclasses.replace(frozen, epochs=1),
            dataclasses.replace(unfrozen, epochs=1, lr=unfrozen.lr * unfrozen_lr_scale))


@pytest.mark.parametrize("finetune, caught_by", [
    pytest.param({"weight_decay": 0.0}, "head drift", id="no_weight_decay"),
    pytest.param({"phases": _phases(unfrozen_lr_scale=2.0)}, "backbone share",
                 id="unfrozen_lr_doubled"),
])
def test_run_vision_resnet_check_catches(vision_fits, finetune, caught_by):
    """Planted faults in the port's fit that ``_assert_resnet_fit_close``
    must catch, each by the check named: AdamW's decay dropped (the head's
    drift reads 4.6e-7), the unfrozen phase's lr doubled (the backbone's
    share off by half a step reads 0.90)."""
    _, final, port = vision_fits
    with pytest.raises(AssertionError, match=caught_by) as caught:
        _assert_resnet_fit_close(port(**finetune).artifacts["params"], final)
    print(caught.value)
