"""The port's subject-parallel fits (``eav_tpu_torch/parallel/subject.py``):
stacked against the port's own serial ``Trainer.fit`` subject by subject
(dropout on, shuffled batches, the sticky eval mode, max-norm, BatchNorm's
running stats, remat under vmap, freeze -> unfreeze with init weights, uint8
frames; the SCNN, with the trainer flags ``l1_reg``, ``l2_reg`` and
``compat_batch_mean_acc``; ResNetAttn's frozen and unfrozen steps), stacked
against the JAX package's ``fit_stacked`` and ``run_stacked`` on the same
weights, ``keep_epoch_logits``, the partial init overlay, and
``run_stacked`` end to end. Tolerance: rtol = atol = 2e-4, the JAX package's
stacked == serial bound (tests/test_parallel.py)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eav_tpu_torch.core.config import (
    EEGPreprocConfig,
    FinetuneConfig,
    PhaseConfig,
    PresetConfig,
    SplitConfig,
)
from eav_tpu_torch.core.optim import HEAD_REGEX
from eav_tpu_torch.models.ast import ast_tiny
from eav_tpu_torch.models.conformer_eeg import ConformerEEG
from eav_tpu_torch.models.dropout import Dropout, record_dropouts
from eav_tpu_torch.models.eegnet import EEGNet
from eav_tpu_torch.models.resnet_attn import ResNetAttn
from eav_tpu_torch.models.scnn_audio import SCNNAudio
from eav_tpu_torch.models.vit import vit_tiny
from eav_tpu_torch.parallel.subject import SubjectParallelTrainer
from eav_tpu_torch.train.loop import Trainer
from eav_tpu_torch.train.pipeline import ModalityPipelines

TOL = dict(rtol=2e-4, atol=2e-4)
EEGNET_TINY = dict(chans=4, samples=64, kern_length=16, f1=4, d=2, f2=8)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread a test: the test runner runs several files at
    once, and torch's default of a thread per core oversubscribes the host
    (the stacked SCNN tests took 6x longer beside five busy processes with
    the default than with one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stacked_data(rng, shape, subjects, n_train=14, n_test=6, uint8=False):
    def x(n):
        if uint8:
            return rng.integers(0, 256, size=(subjects, n) + shape, dtype=np.uint8)
        return rng.normal(size=(subjects, n) + shape).astype(np.float32)

    return (x(n_train), rng.integers(0, 5, (subjects, n_train)).astype(np.int32),
            x(n_test), rng.integers(0, 5, (subjects, n_test)).astype(np.int32))


def _eeg_cfg(lr=1e-2, epochs=3, sticky=True, **kw):
    return FinetuneConfig(model="eeg", batch_size=4, optimizer="adam", weight_decay=0.0,
                          phases=(PhaseConfig(epochs, lr, False),), compat_softmax=True,
                          compat_sticky_eval=sticky, **kw)


def _assert_matches_serial(make_model, cfg, data, seeds, init_params=None, serial_init=None,
                           head_regex=HEAD_REGEX):
    """Each subject's stacked fit against ``Trainer.fit`` at its seed:
    history, test logits and every state_dict entry (the BN running stats
    included)."""
    stacked = SubjectParallelTrainer(make_model(), cfg, head_regex, device="cpu").fit_stacked(
        data, seeds=seeds, init_params=init_params)
    trainer = Trainer(make_model(), cfg, head_regex, device="cpu")
    for s, seed in enumerate(seeds):
        serial = trainer.fit(tuple(a[s] for a in data), seed=seed, init_params=serial_init)
        for k in ("loss", "train_acc", "test_acc"):
            np.testing.assert_allclose(stacked.history[k][s], serial.history[k], **TOL, err_msg=k)
        np.testing.assert_allclose(stacked.outputs_test[s], serial.outputs_test, **TOL)
        assert stacked.params.keys() == serial.params.keys()
        for name, value in serial.params.items():
            np.testing.assert_allclose(stacked.params[name][s].numpy(), value.numpy(), **TOL,
                                       err_msg=name)
    return stacked


def test_stacked_eegnet_with_dropout_matches_serial(rng):
    """S 3, dropout 0.25 with shuffled batches and a partial last batch, the
    sticky eval mode (BatchNorm frozen from the second epoch) and max-norm."""
    data = _stacked_data(rng, (4, 64), 3)
    stacked = _assert_matches_serial(lambda: EEGNet(**EEGNET_TINY, dropout_rate=0.25),
                                     _eeg_cfg(), data, seeds=[7, 8, 9])
    norms = stacked.params["conv_depthwise.weight"].flatten(2).norm(dim=2)
    assert float(norms.max()) <= 1.0 + 1e-5
    # the subjects' fits differ: their own inits, batch orders and masks
    assert not np.allclose(stacked.outputs_test[0], stacked.outputs_test[1])


def test_stacked_conformer_with_dropout_matches_serial(rng):
    data = _stacked_data(rng, (4, 100), 2, n_train=10, n_test=5)
    _assert_matches_serial(lambda: ConformerEEG(chans=4, samples=100, num_layers=2, dropout=0.5),
                           _eeg_cfg(lr=1e-3, epochs=2, sticky=False), data, seeds=[0, 1])


def test_stacked_ast_remat_with_init_params_matches_serial(rng):
    """ast_tiny, frozen (on cached features) then unfrozen, from one
    checkpoint broadcast to both subjects, under remat 'attn' inside vmap,
    against serial fits without remat (the mirror of the JAX package's
    test_stacked_with_init_params_matches_serial)."""
    kw = dict(hidden=16, layers=1, heads=2, mlp_dim=32, max_frames=32, num_mel_bins=16)
    data = _stacked_data(rng, (32, 16), 2, n_train=12, n_test=8)
    cfg = FinetuneConfig(model="ast", batch_size=8, weight_decay=0.01,
                         phases=(PhaseConfig(2, 5e-4, True), PhaseConfig(1, 5e-6, False)))
    ckpt = ast_tiny(**kw, generator=torch.Generator().manual_seed(99)).state_dict()
    stacked_ckpt = {k: v.expand(2, *v.shape) for k, v in ckpt.items()}
    stacked = SubjectParallelTrainer(ast_tiny(**kw, remat="attn"), cfg, device="cpu").fit_stacked(
        data, seeds=[0, 1], init_params=stacked_ckpt)
    trainer = Trainer(ast_tiny(**kw), cfg, device="cpu")
    for s in range(2):
        serial = trainer.fit(tuple(a[s] for a in data), seed=s, init_params=ckpt)
        np.testing.assert_allclose(stacked.outputs_test[s], serial.outputs_test, **TOL)
        np.testing.assert_allclose(stacked.history["loss"][s], serial.history["loss"], **TOL)


def test_remat_under_vmap_has_the_serial_gradients(rng):
    """Remat 'full' with dropout 0.2 inside vmap: the recompute takes the
    sublayers' tensors and masks as inputs; each subject's gradients equal
    its own module's without remat, on the same masks."""
    from torch.func import functional_call, stack_module_state, vmap

    kw = dict(hidden=16, layers=2, heads=2, mlp_dim=32, max_frames=32, num_mel_bins=16,
              dropout=0.2)
    models = [ast_tiny(**kw, generator=torch.Generator().manual_seed(s)) for s in range(2)]
    params, buffers = stack_module_state(models)
    base = ast_tiny(**kw, remat="full")
    x = torch.from_numpy(rng.normal(size=(2, 3, 32, 16)).astype(np.float32))
    with torch.no_grad():
        calls = record_dropouts(base, lambda: base(x[0]))
    names = [n for n, _ in calls]
    assert len(names) == 1 + 2 * 2  # pos_drop, and each layer's two sublayers
    gen = torch.Generator().manual_seed(0)
    masks = {f"{n}.mask": torch.rand((2,) + shape, generator=gen) >= 0.2 for n, shape in calls}
    out = vmap(lambda p, b, m, x: functional_call(base, (p, b, m), (x,)))(params, buffers, masks, x)
    out.square().sum().backward()
    for s, m in enumerate(models):
        for n in names:
            m.get_submodule(n).mask = masks[f"{n}.mask"][s]
        m(x[s]).square().sum().backward()
        for name, p in m.named_parameters():
            np.testing.assert_allclose(params[name].grad[s].numpy(), p.grad.numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=name)


def test_stacked_vit_on_uint8_frames_matches_serial(rng):
    data = _stacked_data(rng, (16, 16, 3), 2, n_train=12, n_test=8, uint8=True)
    cfg = FinetuneConfig(model="vit", batch_size=8, weight_decay=0.01,
                         phases=(PhaseConfig(1, 5e-4, True), PhaseConfig(1, 5e-6, False)))
    kw = dict(hidden=16, layers=1, heads=2, mlp_dim=32, patch_size=8, image_size=16,
              preprocess_uint8=True)
    _assert_matches_serial(lambda: vit_tiny(**kw, remat="attn"), cfg, data, seeds=[3, 4])


def test_stacked_eegnet_matches_jax_fit_stacked(rng):
    """The same stacked EEGNet weights into JAX's fit_stacked and the port's,
    through the bridge: in-order batches, dropout 0, the sticky eval mode."""
    from eav_tpu.core.config import FinetuneConfig as JaxFinetuneConfig
    from eav_tpu.core.config import PhaseConfig as JaxPhaseConfig
    from eav_tpu.models.eegnet import EEGNet as JaxEEGNet
    from eav_tpu.parallel.subject import SubjectParallelTrainer as JaxSubjectParallelTrainer
    from eav_tpu_torch.models.bridge import eegnet_params_from_jax

    data = _stacked_data(rng, (4, 64), 2, n_train=10, n_test=5)
    kw = dict(model="eegnet", batch_size=4, optimizer="adam", weight_decay=0.0, shuffle=False,
              compat_softmax=True, compat_sticky_eval=True)
    jcfg = JaxFinetuneConfig(phases=(JaxPhaseConfig(3, 1e-2, False),), **kw)
    cfg = FinetuneConfig(phases=(PhaseConfig(3, 1e-2, False),), **kw)
    mj = JaxEEGNet(**EEGNET_TINY, dropout_rate=0.0)
    inits = [jax.tree.map(np.asarray, mj.init(jax.random.PRNGKey(s), data[0][0, :1], train=False))
             for s in (1, 2)]
    stacked_p = jax.tree.map(lambda *a: np.stack(a), *(v["params"] for v in inits))
    stacked_b = jax.tree.map(lambda *a: np.stack(a), *(v["batch_stats"] for v in inits))
    want = JaxSubjectParallelTrainer(mj, jcfg, maxnorm_rules=mj.maxnorm_rules).fit_stacked(
        data, seeds=[0, 1], init_params=(jax.tree.map(jnp.asarray, stacked_p),
                                         jax.tree.map(jnp.asarray, stacked_b)))
    sds = [eegnet_params_from_jax(v["params"], v["batch_stats"]) for v in inits]
    init = {k: torch.stack([sd[k] for sd in sds]) for k in sds[0]}
    got = SubjectParallelTrainer(EEGNet(**EEGNET_TINY, dropout_rate=0.0), cfg,
                                 device="cpu").fit_stacked(data, seeds=[0, 1], init_params=init)
    for k in ("loss", "train_acc", "test_acc"):
        np.testing.assert_allclose(got.history[k], want.history[k], **TOL, err_msg=k)
    np.testing.assert_allclose(got.outputs_test, want.outputs_test, **TOL)


def test_keep_epoch_logits_serial_and_stacked(rng):
    data = _stacked_data(rng, (4, 64), 2, n_train=10, n_test=5)
    cfg = _eeg_cfg(epochs=3, keep_epoch_logits=True)
    serial = Trainer(EEGNet(**EEGNET_TINY), cfg, device="cpu").fit(tuple(a[0] for a in data))
    assert serial.epoch_logits.shape == (3, 5, 5)
    np.testing.assert_array_equal(serial.epoch_logits[-1], serial.outputs_test)
    stacked = SubjectParallelTrainer(EEGNet(**EEGNET_TINY), cfg, device="cpu").fit_stacked(
        data, seeds=[0, 1])
    assert stacked.epoch_logits.shape == (2, 3, 5, 5)
    np.testing.assert_array_equal(stacked.epoch_logits[:, -1], stacked.outputs_test)
    plain = Trainer(EEGNet(**EEGNET_TINY), dataclasses.replace(cfg, keep_epoch_logits=False),
                    device="cpu").fit(tuple(a[0] for a in data))
    assert plain.epoch_logits is None


def test_partial_init_overlay_and_unknown_keys(rng):
    """A head-only stacked state_dict overlays the fresh init at lr 0: the
    head keeps the given value, every other leaf its subject's own init.
    A key the model lacks raises."""
    data = _stacked_data(rng, (4, 64), 2, n_train=8, n_test=4)
    cfg = _eeg_cfg(lr=0.0, epochs=1, sticky=False)
    model = EEGNet(**EEGNET_TINY)
    head = {"head.weight": torch.full((2,) + model.head.weight.shape, 0.125)}
    sp = SubjectParallelTrainer(model, cfg, device="cpu")
    res = sp.fit_stacked(data, seeds=[0, 1], init_params=head)
    assert torch.all(res.params["head.weight"] == 0.125)
    k = res.params["conv_temporal.weight"]
    assert not torch.allclose(k[0], k[1])
    fresh = EEGNet(**EEGNET_TINY)
    fresh.reset_parameters(torch.Generator().manual_seed(1))
    torch.testing.assert_close(k[1], fresh.conv_temporal.weight)
    with pytest.raises(KeyError, match="not in the model"):
        sp.fit_stacked(data, seeds=[0, 1], init_params={"nope": torch.zeros(2, 3)})


def test_a_stacked_forward_never_shares_a_mask(rng):
    """Under vmap, an active Dropout given no mask raises instead of drawing
    one mask for every subject; a Dropout called twice in one forward
    cannot be given one mask a call and raises when its calls are recorded."""
    from torch.func import functional_call, stack_module_state, vmap

    models = [EEGNet(**EEGNET_TINY) for _ in range(2)]
    params, buffers = stack_module_state(models)
    x = torch.from_numpy(rng.normal(size=(2, 3, 4, 64)).astype(np.float32))
    with pytest.raises(RuntimeError, match="random"):
        vmap(lambda p, b, x: functional_call(models[0], (p, b), (x,)))(params, buffers, x)

    class Twice(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.drop = Dropout(0.5)

        def forward(self, x):
            return self.drop(self.drop(x))

    twice = Twice()
    with pytest.raises(RuntimeError, match="twice"):
        record_dropouts(twice, lambda: twice(x[0]))


def _write_eeg_subject(root, rng, subject, trials=10):
    """A .mat subject in the EAV layout (500 Hz, listening rows in turn)."""
    import scipy.io

    name = f"subject{subject:02d}"
    sdir = root / name / "EEG"
    sdir.mkdir(parents=True)
    scipy.io.savemat(str(sdir / f"{name}_eeg.mat"), {"seg": rng.normal(size=(4000, 6, trials))})
    label = np.zeros((10, trials))
    label[(2 * np.arange(trials) + 1) % 10, np.arange(trials)] = 1
    scipy.io.savemat(str(sdir / f"{name}_eeg_label.mat"), {"label": label})


def _eeg_preset():
    return PresetConfig(
        name="eegnet", description="", split=SplitConfig(h_idx=6),
        eeg=EEGPreprocConfig(channels=6, trial_seconds=8.0, chunk_seconds=2.0),
        finetune=FinetuneConfig(
            model="eegnet", batch_size=8, optimizer="adam", weight_decay=0.0,
            phases=(PhaseConfig(2, 1e-3, False),), compat_softmax=True, compat_sticky_eval=True,
            model_kwargs=dict(chans=6, samples=200, kern_length=16, f1=4, d=2, f2=8)),
    )


def test_run_stacked_eeg_end_to_end(tmp_path, rng):
    """Two synthetic subjects: the rows carry the serial keys plus
    group_size, both splits are archived for every subject, and each
    subject's archives equal its serial run_eeg's."""
    for s in (1, 2):
        _write_eeg_subject(tmp_path / "EAV", rng, s)
    pipes = ModalityPipelines(str(tmp_path / "EAV"), cache_dir=str(tmp_path / "cache"),
                              logits_dir=str(tmp_path / "stacked"),
                              presets={"eeg": _eeg_preset()}, device="cpu")
    rows = pipes.run_eeg_stacked([1, 2])
    serial = ModalityPipelines(str(tmp_path / "EAV"), cache_dir=str(tmp_path / "cache"),
                               logits_dir=str(tmp_path / "serial"),
                               presets={"eeg": _eeg_preset()}, device="cpu")
    for s in (1, 2):
        want = serial.run_eeg(s)
        m = rows[s].metrics
        assert set(m) == set(want.metrics) | {"group_size"}
        assert m["group_size"] == 2 and m["epochs"] == 2
        assert m["confusion"] == want.metrics["confusion"]
        for split, n in (("train", 30), ("test", 10)):
            got = np.load(tmp_path / "stacked" / f"s{s:02d}_eeg_{split}.npy")
            assert got.shape == (n, 5)
            np.testing.assert_allclose(got, np.load(tmp_path / "serial" / f"s{s:02d}_eeg_{split}.npy"),
                                       **TOL)
    assert sorted(os.listdir(tmp_path / "stacked")) == sorted(os.listdir(tmp_path / "serial"))


def test_run_stacked_refuses_modalities_not_ported(tmp_path):
    """Fusion has no stacked form, and an unknown key none either: both
    raise. The SCNN and ResNet families stack (as in JAX): without data
    they fail in the load, not at the gate."""
    pipes = ModalityPipelines(str(tmp_path), device="cpu")
    for modality in ("fusion", "eeg_scnn"):
        with pytest.raises(KeyError, match="does not support"):
            pipes.run_stacked([1, 2], modality)
    for modality in ("audio_scnn", "vision_resnet"):
        with pytest.raises(FileNotFoundError):
            pipes.run_stacked([1, 2], modality)


def _scnn_cfg(**flags):
    return FinetuneConfig(model="scnn_audio", batch_size=4, optimizer="adam", weight_decay=0.0,
                          phases=(PhaseConfig(2, 1e-3, False),), eval_batch_size=3, **flags)


@pytest.mark.parametrize("flags", [
    {}, {"l1_reg": 1e-4, "l2_reg": 1e-3, "compat_batch_mean_acc": True},
], ids=["plain", "flags"])
def test_stacked_scnn_with_dropout_matches_serial(rng, flags):
    """S 2 at the preset's dropout (0.1, 0.5) and lr 1e-3, shuffled batches
    of 4 over 10 rows (a partial last one), eval batches of 3; with the
    three trainer flags, the penalty in each subject's loss and the
    per-batch accuracies."""
    data = _stacked_data(rng, (180,), 2, n_train=10, n_test=5)
    stacked = _assert_matches_serial(SCNNAudio, _scnn_cfg(**flags), data, seeds=[3, 4])
    assert not np.allclose(stacked.outputs_test[0], stacked.outputs_test[1])


def _jax_scnn_inits(x, seeds):
    from eav_tpu.models.scnn_audio import SCNNAudio as JaxSCNNAudio

    mj = JaxSCNNAudio(dropout_rates=(0.0, 0.0))
    return mj, [jax.tree.map(np.asarray, mj.init(jax.random.PRNGKey(s), x[:1])["params"])
                for s in seeds]


@pytest.mark.parametrize("flags", [
    {"l1_reg": 1e-4, "l2_reg": 1e-3}, {"compat_batch_mean_acc": True},
], ids=["l1_l2", "batch_mean_acc"])
def test_stacked_scnn_flags_match_jax_fit_stacked(rng, flags):
    """The trainer flags in a stacked fit: the same stacked SCNN weights
    into JAX's ``fit_stacked`` and the port's (dropout 0, in-order
    batches): histories and test logits to 2e-4."""
    from eav_tpu.core.config import FinetuneConfig as JaxFinetuneConfig
    from eav_tpu.core.config import PhaseConfig as JaxPhaseConfig
    from eav_tpu.parallel.subject import SubjectParallelTrainer as JaxSubjectParallelTrainer
    from eav_tpu_torch.models.bridge import scnn_params_from_jax

    data = _stacked_data(rng, (180,), 2, n_train=10, n_test=5)
    kw = dict(model="scnn_audio", batch_size=4, optimizer="adam", weight_decay=0.0,
              shuffle=False, eval_batch_size=3, **flags)
    mj, inits = _jax_scnn_inits(data[0][0], (1, 2))
    stacked_p = jax.tree.map(lambda *a: np.stack(a), *inits)
    want = JaxSubjectParallelTrainer(mj, JaxFinetuneConfig(
        phases=(JaxPhaseConfig(2, 1e-3, False),), **kw)).fit_stacked(
        data, seeds=[0, 1], init_params=jax.tree.map(jnp.asarray, stacked_p))
    sds = [scnn_params_from_jax(p) for p in inits]
    got = SubjectParallelTrainer(SCNNAudio(dropout_rates=(0.0, 0.0)), FinetuneConfig(
        phases=(PhaseConfig(2, 1e-3, False),), **kw), device="cpu").fit_stacked(
        data, seeds=[0, 1], init_params={k: torch.stack([sd[k] for sd in sds]) for k in sds[0]})
    for k in ("loss", "train_acc", "test_acc"):
        np.testing.assert_allclose(got.history[k], want.history[k], **TOL, err_msg=k)
    np.testing.assert_allclose(got.outputs_test, want.outputs_test, **TOL)


def test_run_stacked_scnn_matches_jax(tmp_path, rng, monkeypatch):
    """``run_stacked([1, 2], "audio_scnn")`` in both packages on the same
    cached features (the cache key is shared), from one set of weights
    broadcast to both subjects (the checkpoint path of both), dropout 0 and
    in-order batches: the same rows (but timings) and archives to 2e-4.
    At lr 1e-4: at the preset's 1e-3 on these random features, the port's
    and JAX's test logits part by 0.026 after 6 steps, serial fits as much
    as stacked ones (Adam steps a weight whose gradient is at rounding
    level by +-lr, and ReLU units switch), while each package's stacked fit
    equals its serial one to 3e-6; at 1e-4 the packages agree to 5e-6."""
    import eav_tpu.train.pipeline as JP
    from eav_tpu.core.config import get_preset as jax_get_preset
    import eav_tpu_torch.train.pipeline as P
    from eav_tpu_torch.core.config import get_preset
    from eav_tpu_torch.models.bridge import scnn_params_from_jax

    def preset(get):
        base = get("scnn_audio")
        ft = dataclasses.replace(base.finetune, batch_size=4, shuffle=False, eval_batch_size=3,
                                 phases=(dataclasses.replace(base.finetune.phases[0], epochs=2,
                                                             lr=1e-4),),
                                 model_kwargs={"dropout_rates": (0.0, 0.0)})
        return base.replace(split=dataclasses.replace(base.split, h_idx=2), finetune=ft)

    key = P._cfg_hash(preset(get_preset).audio)
    assert key == JP._cfg_hash(preset(jax_get_preset).audio)
    for cache in ("jc", "tc"):
        os.makedirs(tmp_path / cache)
    for s in (1, 2):
        x = rng.normal(size=(20, 180)).astype(np.float32)
        y = np.repeat(np.arange(5), 4).astype(np.int32)
        for cache in ("jc", "tc"):
            np.savez(tmp_path / cache / f"s{s:02d}_aud_scnn180_{key}.npz", x=x, y=y)
    mj, (init,) = _jax_scnn_inits(np.zeros((1, 180), np.float32), (5,))
    monkeypatch.setattr(JP, "_pretrained_params", lambda *a: (init, None))
    monkeypatch.setattr(P, "_pretrained_params", lambda *a: scnn_params_from_jax(init))
    want = JP.ModalityPipelines(str(tmp_path), cache_dir=str(tmp_path / "jc"),
                                logits_dir=str(tmp_path / "jl"),
                                presets={"audio_scnn": preset(jax_get_preset)}
                                ).run_stacked([1, 2], "audio_scnn")
    got = P.ModalityPipelines(str(tmp_path), cache_dir=str(tmp_path / "tc"),
                              logits_dir=str(tmp_path / "tl"),
                              presets={"audio_scnn": preset(get_preset)}, device="cpu"
                              ).run_stacked([1, 2], "audio_scnn")
    timings = {"fit_seconds", "samples_per_sec", "load_seconds", "archive_seconds"}
    for s in (1, 2):
        g, w = got[s].metrics, want[s].metrics
        assert g.keys() == w.keys() and g["group_size"] == 2
        assert g["confusion"] == w["confusion"] and g["epochs"] == w["epochs"] == 2
        for k in set(w) - timings - {"confusion", "group_size", "epochs"}:
            assert g[k] == pytest.approx(w[k], abs=2e-4), k
    assert sorted(os.listdir(tmp_path / "tl")) == sorted(os.listdir(tmp_path / "jl"))
    for name in os.listdir(tmp_path / "jl"):
        np.testing.assert_allclose(np.load(tmp_path / "tl" / name), np.load(tmp_path / "jl" / name),
                                   **TOL, err_msg=name)


def test_stacked_resnet_steps_match_serial(rng):
    """ResNetAttn at 64 x 64, S 2, batch 2: one unfrozen step stacked
    against serial: history, test logits and every weight and running stat
    to 2e-4. In float64 (the model computes in its parameters'
    type): at a random init, BatchNorm over batch 2 makes the float32
    network ill-conditioned, and stacked and serial float32 losses part by
    up to 5e-4 with one thread a process. lr 1e-5: where roundoff flips the
    sign of a near-zero gradient, Adam's first step moves that weight by
    2 lr."""
    data = _stacked_data(rng, (64, 64, 3), 2, n_train=2, n_test=2)
    cfg = FinetuneConfig(model="resnet_attn", batch_size=2, weight_decay=0.01,
                         phases=(PhaseConfig(1, 1e-5, False),))
    _assert_matches_serial(lambda: ResNetAttn().double(), cfg, data, seeds=[0, 1],
                           head_regex=ResNetAttn.HEAD_REGEX)


def test_deterministic_mode_holds_only_for_the_fit(tmp_path, rng):
    """``deterministic=True``: every forward of a serial or stacked fit runs
    under torch's deterministic algorithms, and the process's setting is
    back afterwards, also when the fit raises; the pipelines pass it on."""
    data = _stacked_data(rng, (4, 64), 2, n_train=8, n_test=4)
    seen = []
    model = EEGNet(**EEGNET_TINY)
    model.register_forward_pre_hook(
        lambda m, a: seen.append(torch.are_deterministic_algorithms_enabled()))
    before = torch.are_deterministic_algorithms_enabled()
    Trainer(model, _eeg_cfg(epochs=1), device="cpu", deterministic=True).fit(
        tuple(a[0] for a in data))
    SubjectParallelTrainer(model, _eeg_cfg(epochs=1), device="cpu",
                           deterministic=True).fit_stacked(data)
    assert seen and all(seen)
    assert torch.are_deterministic_algorithms_enabled() == before
    with pytest.raises(KeyError):
        Trainer(model, _eeg_cfg(), device="cpu", deterministic=True).fit(
            tuple(a[0] for a in data), init_params={"nope": torch.zeros(1)})
    assert torch.are_deterministic_algorithms_enabled() == before
    pipes = ModalityPipelines(str(tmp_path), presets={"eeg": _eeg_preset()}, device="cpu",
                              deterministic=True)
    assert pipes._trainer("eeg", pipes.presets["eeg"]).deterministic


@pytest.mark.parametrize("remat", ["none", "attn"])
def test_stacked_ast_flash_step_matches_jax_stacked_step(rng, remat):
    """One unfrozen stacked step of two ast_tiny subjects with
    ``attn_impl='flash'`` (the kernels' plain versions, the stack folded
    into B·H) against JAX's vmapped step with the Pallas kernels in
    interpret mode, on the same weights through the bridge: each subject's
    loss and gradients."""
    from eav_tpu.models.ast import ast_tiny as jax_ast_tiny
    from eav_tpu.train.loop import cross_entropy as jax_cross_entropy
    from eav_tpu_torch.models.bridge import ast_params_from_jax

    x = rng.normal(size=(2, 4, 128, 128)).astype(np.float32)
    y = rng.integers(0, 5, size=(2, 4)).astype(np.int32)
    mj = jax_ast_tiny(attn_impl="flash", remat=remat)
    inits = [jax.tree.map(np.asarray, mj.init(jax.random.PRNGKey(s), jnp.asarray(x[0, :1]),
                                              train=False)["params"]) for s in (0, 1)]
    stacked = jax.tree.map(lambda *a: jnp.asarray(np.stack(a)), *inits)

    def loss_fn(p, x, y):
        logits = mj.apply({"params": p}, x, train=False)
        return jax_cross_entropy(logits, y, jnp.ones_like(y, jnp.float32))

    want_loss, want_grads = jax.vmap(jax.value_and_grad(loss_fn))(
        stacked, jnp.asarray(x), jnp.asarray(y))
    cfg = FinetuneConfig(model="ast", batch_size=4, weight_decay=0.01,
                         phases=(PhaseConfig(1, 5e-6, False),))
    sp = SubjectParallelTrainer(ast_tiny(attn_impl="flash", remat=remat), cfg, device="cpu")
    sds = [ast_params_from_jax(p) for p in inits]
    stack = sp.init_stack([0, 1], {k: torch.stack([sd[k] for sd in sds]) for k in sds[0]})
    sp.model.eval()
    loss, _ = sp.train_step(stack, torch.from_numpy(x), torch.from_numpy(y).long())
    np.testing.assert_allclose(loss.numpy(), np.asarray(want_loss), **TOL)
    want = [ast_params_from_jax(jax.tree.map(lambda g: np.asarray(g)[s], want_grads))
            for s in (0, 1)]
    for name, p in stack.params.items():
        for s in (0, 1):
            np.testing.assert_allclose(p.grad[s].numpy(), want[s][name].numpy(), **TOL,
                                       err_msg=f"{name}, subject {s}")


@pytest.mark.parametrize("attn_impl,overrides", [
    ("flash", {"remat": "attn"}),
    ("auto", {"attn_impl": "math", "remat": "attn"}),
    ("math", {"remat": "attn"}),
])
def test_run_stacked_keeps_flash_and_rewrites_auto(tmp_path, monkeypatch, attn_impl, overrides):
    """As the JAX package's ``run_stacked`` (eav_tpu/train/pipeline.py:553-563):
    only ``'auto'`` attention becomes math in a stacked fit; an explicit
    ``'flash'`` stays, and remat ``'none'`` becomes ``'attn'``."""
    from eav_tpu_torch.core.config import get_preset
    from eav_tpu_torch.train import pipeline

    class Built(Exception):
        pass

    seen = {}

    def build(preset, **kw):
        seen.update(kw)
        raise Built

    base = get_preset("ast_finetune")
    preset = base.replace(finetune=dataclasses.replace(
        base.finetune, model_kwargs={**base.finetune.model_kwargs, "attn_impl": attn_impl}))
    monkeypatch.setattr(pipeline, "build_model", build)
    monkeypatch.setattr(ModalityPipelines, "_stack_splits", lambda self, subs, mod: (None, None))
    with pytest.raises(Built):
        ModalityPipelines(str(tmp_path), presets={"audio": preset},
                          device="cpu").run_stacked([1, 2], "audio")
    assert seen == overrides
