"""The port's EEGNet against the JAX package's on the same weights (through
``models/bridge.py``): float32 eval-mode logits to 2e-4 for both
``separable_mode``s, both ``temporal_mode``s, an odd kernel and
``eegnet_keras``; one train-mode forward's logits and BatchNorm running
stats to 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eav_tpu.models.eegnet import EEGNet as JaxEEGNet
from eav_tpu.models.eegnet import eegnet_keras as jax_eegnet_keras
from eav_tpu_torch.models.bridge import eegnet_params_from_jax
from eav_tpu_torch.models.eegnet import EEGNet, eegnet_keras, fft_correlate

TINY = dict(chans=4, samples=64, kern_length=16, f1=4, d=2, f2=8)


def _jax_variables(model, x, rng):
    """Init, then running stats moved off their init values so the bridge's
    mapping of mean and var is exercised."""
    variables = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0), x, train=False))
    stats = {name: {"mean": rng.normal(size=s["mean"].shape).astype(np.float32) * 0.1,
                    "var": rng.uniform(0.5, 1.5, size=s["var"].shape).astype(np.float32)}
             for name, s in variables["batch_stats"].items()}
    return variables["params"], stats


def _pair(rng, jax_factory, torch_factory, **kw):
    x = rng.normal(size=(3, kw.get("chans", 4), kw.get("samples", 64))).astype(np.float32)
    mj = jax_factory(**kw)
    params, stats = _jax_variables(mj, x, rng)
    mt = torch_factory(**kw)
    mt.load_state_dict(eegnet_params_from_jax(params, stats))
    return x, mj, params, stats, mt.eval()


@pytest.mark.parametrize("separable_mode", ["single", "true"])
@pytest.mark.parametrize("temporal_mode", ["conv", "fft"])
def test_eval_logits_match_jax(rng, separable_mode, temporal_mode):
    kw = dict(TINY, dropout_rate=0.5, separable_mode=separable_mode, temporal_mode=temporal_mode)
    x, mj, params, stats, mt = _pair(rng, JaxEEGNet, EEGNet, **kw)
    want = np.asarray(mj.apply({"params": params, "batch_stats": stats}, x, train=False))
    with torch.no_grad():
        got = mt(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == (3, 5)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("temporal_mode", ["conv", "fft"])
def test_odd_kernel_and_keras_variant(rng, temporal_mode):
    """kern 15 ('SAME' pads 7 and 7) and the Keras EEGNet (true separable,
    no first ELU, dense max-norm 0.25)."""
    kw = dict(TINY, kern_length=15, temporal_mode=temporal_mode)
    x, mj, params, stats, mt = _pair(rng, jax_eegnet_keras, eegnet_keras, **kw)
    assert mt.separable_mode == "true" and not mt.first_activation
    assert dict((r, m) for r, m, _ in mt.maxnorm_rules)[r"^head\.weight$"] == 0.25
    want = np.asarray(mj.apply({"params": params, "batch_stats": stats}, x, train=False))
    with torch.no_grad():
        got = mt(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("separable_mode", ["single", "true"])
def test_train_forward_updates_stats_as_jax(rng, separable_mode):
    """One train-mode forward (dropout 0): the same logits and the same BN
    running stats, Bessel-corrected var, momentum 0.9 / 0.1."""
    kw = dict(TINY, dropout_rate=0.0, separable_mode=separable_mode)
    x, mj, params, stats, mt = _pair(rng, JaxEEGNet, EEGNet, **kw)
    want, mutated = mj.apply({"params": params, "batch_stats": stats}, x, train=True,
                             mutable=["batch_stats"])
    mt.train()
    with torch.no_grad():
        got = mt(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    new = eegnet_params_from_jax(params, jax.tree.map(np.asarray, mutated["batch_stats"]))
    sd = mt.state_dict()
    for name in ("bn_temporal", "bn_depthwise", "bn_separable"):
        for buf in ("running_mean", "running_var"):
            key = f"{name}.{buf}"
            np.testing.assert_allclose(sd[key].numpy(), new[key].numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=key)


def test_full_width_flatten_is_960():
    """64 * (500 // 4 // 8) = 960 (`EEGNet_tor.py:43`), 30 electrodes, kern 300."""
    m = EEGNet()
    assert m.head.weight.shape == (5, 960)
    assert m.conv_depthwise.weight.shape == (64, 1, 30, 1)
    assert m.conv_temporal.weight.shape == (8, 1, 1, 300)
    with torch.no_grad():
        assert m.eval()(torch.zeros(2, 30, 500)).shape == (2, 5)


def test_fft_correlation_equals_same_conv(rng):
    """The even kernel 300's 'SAME' correlation: 149 left, 150 right."""
    x = torch.from_numpy(rng.normal(size=(2, 1, 3, 500)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(8, 1, 1, 300)).astype(np.float32))
    want = torch.nn.functional.conv2d(torch.nn.functional.pad(x, (149, 150)), w)
    np.testing.assert_allclose(fft_correlate(x, w).numpy(), want.numpy(), rtol=1e-4, atol=1e-4)


def test_bf16_compute_close_to_f32(rng):
    x = torch.from_numpy(rng.normal(size=(4, 30, 500)).astype(np.float32))
    m32 = EEGNet(dropout_rate=0.0).eval()
    m16 = EEGNet(dropout_rate=0.0, compute_dtype=torch.bfloat16).eval()
    m16.load_state_dict(m32.state_dict())
    with torch.no_grad():
        o32, o16 = m32(x), m16(x)
    assert o16.dtype == torch.float32
    assert float((o32 - o16).abs().max()) < 0.15 * float(o32.abs().max()) + 0.05


def test_init_is_seeded_and_leaves_the_global_rng():
    state = torch.random.get_rng_state()
    a = EEGNet(**TINY, generator=torch.Generator().manual_seed(3))
    b = EEGNet(**TINY, generator=torch.Generator().manual_seed(3))
    assert torch.equal(torch.random.get_rng_state(), state)
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), name
    assert float(a.bn_temporal.running_var.min()) == 1.0


def test_bad_modes_raise():
    with pytest.raises(ValueError, match="separable_mode"):
        EEGNet(**TINY, separable_mode="depthwise")
    with pytest.raises(ValueError, match="temporal_mode"):
        EEGNet(**TINY, temporal_mode="direct")


def test_jax_param_shapes_map_onto_the_port(rng):
    """Every Flax leaf has a port tensor of the transposed shape, strictly."""
    x = np.zeros((1, 4, 64), np.float32)
    for mode in ("single", "true"):
        variables = JaxEEGNet(**TINY, separable_mode=mode).init(
            jax.random.PRNGKey(1), jnp.asarray(x), train=False)
        sd = eegnet_params_from_jax(jax.tree.map(np.asarray, variables["params"]),
                                    jax.tree.map(np.asarray, variables["batch_stats"]))
        EEGNet(**TINY, separable_mode=mode).load_state_dict(sd)  # strict
