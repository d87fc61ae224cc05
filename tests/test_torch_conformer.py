"""The port's EEG conformer against the JAX package's on the same weights
(through ``models/bridge.py``): float32 eval-mode logits to 2e-4, a
train-mode forward's BatchNorm running stats to 1e-5, and the 2600-wide
flatten of the full-size model."""

import jax
import numpy as np
import pytest
import torch

from eav_tpu.models.conformer_eeg import ConformerEEG as JaxConformerEEG
from eav_tpu_torch.models.bridge import conformer_params_from_jax
from eav_tpu_torch.models.conformer_eeg import ConformerEEG

TINY = dict(chans=4, samples=100, num_layers=2)  # T 88 -> 8 pooled positions


def _pair(rng, **kw):
    kw = dict(TINY, **kw)
    x = rng.normal(size=(3, kw["chans"], kw["samples"])).astype(np.float32)
    mj = JaxConformerEEG(**kw)
    variables = jax.tree.map(np.asarray, mj.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, x, train=False))
    stats = {"bn": {"mean": rng.normal(size=40).astype(np.float32) * 0.1,
                    "var": rng.uniform(0.5, 1.5, size=40).astype(np.float32)}}
    mt = ConformerEEG(**kw)
    mt.load_state_dict(conformer_params_from_jax(variables["params"], stats))
    return x, mj, variables["params"], stats, mt


def test_eval_logits_match_jax(rng):
    x, mj, params, stats, mt = _pair(rng)
    want = np.asarray(mj.apply({"params": params, "batch_stats": stats}, x, train=False))
    with torch.no_grad():
        got = mt.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == (3, 5)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_train_forward_updates_stats_as_jax(rng):
    x, mj, params, stats, mt = _pair(rng, dropout=0.0)
    want, mutated = mj.apply({"params": params, "batch_stats": stats}, x, train=True,
                             mutable=["batch_stats"])
    with torch.no_grad():
        got = mt.train()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4, atol=2e-4)
    new = mutated["batch_stats"]["bn"]
    np.testing.assert_allclose(mt.bn.running_mean.numpy(), np.asarray(new["mean"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mt.bn.running_var.numpy(), np.asarray(new["var"]),
                               rtol=1e-5, atol=1e-5)


def test_full_size_flatten_is_2600():
    """65 pooled positions x 40 filters = 2600 (`Transformer_EEG.py:128`);
    12 layers, T 488 tokens of width 40."""
    m = ConformerEEG()
    assert m.head.weight.shape == (5, 2600) and m.head.bias is None
    assert len(m.layers) == 12 and m.spatial_proj.shape == (40, 30)
    with torch.no_grad():
        assert m.eval()(torch.zeros(2, 30, 500)).shape == (2, 5)


def test_dropout_is_drawn_from_the_given_generator(rng):
    """Train-mode forwards with dropout 0.5 repeat under one generator seed
    and differ under another."""
    from eav_tpu_torch.models.dropout import set_generator

    m = ConformerEEG(**TINY).train()
    x = torch.from_numpy(rng.normal(size=(2, 4, 100)).astype(np.float32))

    def run(seed):
        set_generator(m, torch.Generator().manual_seed(seed))
        with torch.no_grad():
            return m(x)

    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))


@pytest.mark.parametrize("scale", [0.1, 10.0])
def test_maxnorm_rule_names_the_head(scale):
    from eav_tpu_torch.core.optim import maxnorm_project

    m = ConformerEEG(**TINY)
    with torch.no_grad():
        m.head.weight.mul_(scale)
    before = m.head.weight.detach().norm(dim=1).clone()
    maxnorm_project(m, m.maxnorm_rules)
    after = m.head.weight.detach().norm(dim=1)
    assert bool((after <= 0.5 + 1e-6).all())
    np.testing.assert_allclose(after.numpy(), np.minimum(before.numpy(), 0.5), rtol=1e-6)
