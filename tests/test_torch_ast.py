"""The port's AST against the JAX package's, on the same weights (carried by
``ast_params_from_jax``) and the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eav_tpu.core.optim import path_str
from eav_tpu.core.optim import trainable_mask as jax_trainable_mask
from eav_tpu.models.ast import ast_tiny as jax_ast_tiny
from eav_tpu_torch.core.optim import HEAD_REGEX, trainable_mask
from eav_tpu_torch.models.ast import AST, ast_tiny
from eav_tpu_torch.models.bridge import ast_params_from_jax
from eav_tpu_torch.models.dropout import Dropout, set_generator


def _pair(rng, jax_kw=None, torch_kw=None):
    """(jax model, variables, torch model with the same weights)."""
    x = rng.normal(size=(1, 128, 128)).astype(np.float32)
    mj = jax_ast_tiny(**(jax_kw or {}))
    variables = mj.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    mt = ast_tiny(**(torch_kw or {}))
    mt.load_state_dict(ast_params_from_jax(jax.tree.map(np.asarray, variables["params"])))
    return mj, variables, mt.eval()


def _both(mj, variables, mt, x, mode):
    want = np.asarray(mj.apply(variables, jnp.asarray(x), train=False, mode=mode))
    with torch.no_grad():
        got = mt(torch.from_numpy(x), mode=mode).numpy()
    return got, want


@pytest.mark.parametrize("attn_impl", ["math", "flash"])
@pytest.mark.parametrize("mode", ["full", "features", "head"])
def test_f32_matches_jax(rng, attn_impl, mode):
    mj, variables, mt = _pair(rng, torch_kw={"attn_impl": attn_impl})
    if mode == "head":
        x = rng.normal(size=(3, 32)).astype(np.float32)
    else:
        x = rng.normal(size=(3, 128, 128)).astype(np.float32)
    got, want = _both(mj, variables, mt, x, mode)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_bf16_compute_and_stream_match_jax(rng):
    """bf16 matmuls and residual stream (the preset's setting): the two
    frameworks round bf16 at slightly different points (GELU, softmax), so
    the logits agree to bf16 roundoff through two layers, not to f32."""
    mj, variables, mt = _pair(
        rng,
        jax_kw={"compute_dtype": jnp.bfloat16, "stream_dtype": jnp.bfloat16},
        torch_kw={"compute_dtype": torch.bfloat16, "stream_dtype": torch.bfloat16},
    )
    x = rng.normal(size=(3, 128, 128)).astype(np.float32)
    for mode in ("full", "features"):
        got, want = _both(mj, variables, mt, x, mode)
        assert got.dtype == np.float32  # the head computes in f32
        np.testing.assert_allclose(got, want, rtol=5e-2, atol=5e-2)


def test_bf16_layer_norm_statistics_in_f32():
    """LayerNorm under bf16 compute takes its statistics in f32, as Flax
    does: a row whose mean dwarfs its spread still normalizes exactly."""
    from eav_tpu_torch.models.transformer import layer_norm

    ln = torch.nn.LayerNorm(4, eps=1e-12)
    x = torch.tensor([[1000.0, 1001.0, 1002.0, 1003.0]], dtype=torch.bfloat16)
    y = layer_norm(x, ln, torch.bfloat16)
    assert y.dtype == torch.bfloat16
    ref = torch.nn.functional.layer_norm(x.double(), (4,), eps=1e-12).float()
    torch.testing.assert_close(y.float(), ref, rtol=1e-2, atol=1e-2)


def test_bridge_covers_every_parameter(rng):
    _, variables, mt = _pair(rng)
    sd = ast_params_from_jax(jax.tree.map(np.asarray, variables["params"]))
    assert set(sd) == set(mt.state_dict())
    n_jax = sum(np.asarray(v).size for v in jax.tree.leaves(variables["params"]))
    assert n_jax == sum(p.numel() for p in mt.parameters())


def test_head_regex_selects_the_jax_head(rng):
    """The dotted-name regex marks trainable exactly the parameters that the
    JAX regex marks on '/'-joined paths, frozen and unfrozen."""
    _, variables, mt = _pair(rng)

    def rename(path):
        return path.replace("/", ".").replace(".kernel", ".weight").replace(".scale", ".weight")

    for freeze in (True, False):
        jmask = jax_trainable_mask(variables["params"], freeze=freeze)
        want = {rename(path_str(p)): on for p, on in jax.tree_util.tree_flatten_with_path(jmask)[0]}
        assert trainable_mask(mt, freeze=freeze) == want
    assert {n for n, on in trainable_mask(mt, freeze=True).items() if on} == {
        "classifier.weight", "classifier.bias", "classifier_ln.weight", "classifier_ln.bias"}
    assert AST.head_mode_regex == HEAD_REGEX


@pytest.mark.parametrize("remat", ["attn", "full"])
def test_remat_keeps_gradients(rng, remat):
    """Recomputing sublayers in the backward changes no gradient."""
    x = torch.from_numpy(rng.normal(size=(2, 128, 128)).astype(np.float32))
    grads = []
    for mode in ("none", remat):
        m = ast_tiny(remat=mode)
        m(x).square().sum().backward()
        grads.append({n: p.grad for n, p in m.named_parameters()})
    for n in grads[0]:
        torch.testing.assert_close(grads[1][n], grads[0][n], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("remat", ["attn", "full"])
def test_remat_replays_the_dropout_generator(rng, remat):
    """Dropout masks from an explicit generator: the recompute in the
    backward draws the forward's masks, so every gradient and the
    generator's final state equal those of the run that keeps its
    activations."""
    x = torch.from_numpy(rng.normal(size=(2, 128, 128)).astype(np.float32))
    grads, states = [], []
    for mode in ("none", remat):
        m = ast_tiny(dropout=0.3, remat=mode).train()
        assert not any(isinstance(s, torch.nn.Dropout) for s in m.modules())
        # pos_drop + one a sublayer (two a layer), all drawing from one generator
        assert sum(isinstance(s, Dropout) for s in m.modules()) == 5
        gen = torch.Generator().manual_seed(7)
        set_generator(m, gen)
        m(x).square().sum().backward()
        grads.append({n: p.grad for n, p in m.named_parameters()})
        states.append(gen.get_state())
    assert torch.equal(states[0], states[1])
    for n in grads[0]:
        torch.testing.assert_close(grads[1][n], grads[0][n], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("remat", ["attn", "full"])
def test_remat_runs_the_flash_function(rng, remat):
    """The recompute runs the flash autograd function (its plain versions on
    the CPU) under ``torch.func.vjp``, with dropout on: every gradient equals
    that of the run that keeps its activations."""
    x = torch.from_numpy(rng.normal(size=(2, 128, 128)).astype(np.float32))
    grads = []
    for mode in ("none", remat):
        m = ast_tiny(dropout=0.3, attn_impl="flash", remat=mode).train()
        set_generator(m, torch.Generator().manual_seed(7))
        m(x).square().sum().backward()
        grads.append({n: p.grad for n, p in m.named_parameters()})
    for n in grads[0]:
        torch.testing.assert_close(grads[1][n], grads[0][n], rtol=1e-6, atol=1e-6)


def test_remat_hands_the_kernels_plain_tensors(rng, monkeypatch):
    """Under the recompute's ``torch.func.vjp`` a kernel wrapper must be
    given tensors with a data pointer, as a launch needs on the card: each
    wrapper here reads its operands' pointers before its plain version."""
    from eav_tpu_torch.ops import attention as A

    for name in ("flash_fwd", "flash_dkv", "flash_dq"):
        def reads_pointers(*args, _fn=getattr(A, name)):
            for a in args:
                if isinstance(a, torch.Tensor):
                    a.data_ptr()
            return _fn(*args)

        monkeypatch.setattr(A, name, reads_pointers)
    x = torch.from_numpy(rng.normal(size=(2, 128, 128)).astype(np.float32))
    ast_tiny(attn_impl="flash", remat="attn").train()(x).square().sum().backward()


def test_dropout_masks_follow_the_generator(rng):
    x = torch.from_numpy(rng.normal(size=(2, 128, 128)).astype(np.float32))
    m = ast_tiny(dropout=0.3).train()
    out = []
    for seed in (5, 5, 6):
        set_generator(m, torch.Generator().manual_seed(seed))
        with torch.no_grad():
            out.append(m(x))
    assert torch.equal(out[0], out[1])
    assert not torch.equal(out[0], out[2])


def test_same_generator_same_weights():
    a = ast_tiny(generator=torch.Generator().manual_seed(3))
    b = ast_tiny(generator=torch.Generator().manual_seed(3))
    c = ast_tiny(generator=torch.Generator().manual_seed(4))
    for (n, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), n
    assert not torch.equal(a.encoder.layer_0.fc1.weight, c.encoder.layer_0.fc1.weight)
