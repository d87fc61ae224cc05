"""The port's ViT against the JAX package's, on the same weights (carried by
``vit_params_from_jax``) and the same numpy inputs, and its uint8 resize
against ``jax.image.resize``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eav_tpu.ingest.vision import vit_pixel_values as jax_vit_pixel_values
from eav_tpu.models.vit import vit_tiny as jax_vit_tiny
from eav_tpu_torch.core.optim import trainable_mask
from eav_tpu_torch.models.bridge import vit_params_from_jax
from eav_tpu_torch.models.vit import ViT, vit_tiny
from eav_tpu_torch.ops.image import pixel_values, resize_bilinear


def _pair(rng, jax_kw=None, torch_kw=None, size=64):
    """(jax model, variables, torch model with the same weights)."""
    x = rng.normal(size=(1, size, size, 3)).astype(np.float32)
    mj = jax_vit_tiny(**(jax_kw or {}))
    variables = mj.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    mt = vit_tiny(**(torch_kw or {}))
    mt.load_state_dict(vit_params_from_jax(jax.tree.map(np.asarray, variables["params"])))
    return mj, variables, mt.eval()


def _both(mj, variables, mt, x, mode):
    want = np.asarray(mj.apply(variables, jnp.asarray(x), train=False, mode=mode))
    with torch.no_grad():
        got = mt(torch.from_numpy(x), mode=mode).numpy()
    return got, want


@pytest.mark.parametrize("mode", ["full", "features", "head"])
def test_f32_matches_jax(rng, mode):
    mj, variables, mt = _pair(rng)
    if mode == "head":
        x = rng.normal(size=(3, 32)).astype(np.float32)
    else:
        x = rng.normal(size=(3, 64, 64, 3)).astype(np.float32)
    got, want = _both(mj, variables, mt, x, mode)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_bf16_compute_and_stream_match_jax(rng):
    """bf16 matmuls and residual stream (the preset's setting): agreement to
    bf16 roundoff through two layers."""
    mj, variables, mt = _pair(
        rng,
        jax_kw={"compute_dtype": jnp.bfloat16, "stream_dtype": jnp.bfloat16},
        torch_kw={"compute_dtype": torch.bfloat16, "stream_dtype": torch.bfloat16},
    )
    x = rng.normal(size=(3, 64, 64, 3)).astype(np.float32)
    for mode in ("full", "features"):
        got, want = _both(mj, variables, mt, x, mode)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("size", [56, 96, 64])
def test_uint8_preprocess_matches_jax(rng, size):
    """Raw uint8 frames resized on the model's side: 56 -> 64 up, 96 -> 64
    down (the antialiased branch), 64 unchanged."""
    kw = {"preprocess_uint8": True}
    mj, variables, mt = _pair(rng, jax_kw=kw, torch_kw=kw)
    x = rng.integers(0, 256, size=(2, size, size, 3), dtype=np.uint8)
    for mode in ("full", "features"):
        got, want = _both(mj, variables, mt, x, mode)
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("shape", [(56, 56, 64, 64), (96, 96, 64, 64), (48, 80, 64, 40)])
def test_resize_matches_jax_image_resize(rng, shape):
    """The resize alone against ``jax.image.resize(bilinear, antialias)``,
    mixed directions per axis included, to float32 roundoff of 0..255."""
    h, w, oh, ow = shape
    x = rng.uniform(0, 255, size=(2, h, w, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, oh, ow, 3), "bilinear",
                                       antialias=True))
    got = resize_bilinear(torch.from_numpy(x), oh, ow).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    pix = jax_vit_pixel_values(jnp.asarray(x.astype(np.uint8)), size=64)
    np.testing.assert_allclose(pixel_values(torch.from_numpy(x.astype(np.uint8)), 64).numpy(),
                               np.asarray(pix), rtol=1e-5, atol=1e-5)


def test_full_is_head_of_features(rng):
    mt = vit_tiny(preprocess_uint8=True).eval()
    x = torch.from_numpy(rng.integers(0, 256, size=(3, 56, 56, 3), dtype=np.uint8))
    with torch.no_grad():
        full = mt(x)
        head = mt(mt(x, mode="features"), mode="head")
    torch.testing.assert_close(full, head, rtol=0, atol=0)


def test_bridge_and_head_set(rng):
    """The bridge covers every parameter; the frozen phase trains only the
    classifier, as the JAX regex marks it."""
    _, variables, mt = _pair(rng)
    sd = vit_params_from_jax(jax.tree.map(np.asarray, variables["params"]))
    assert set(sd) == set(mt.state_dict())
    n_jax = sum(np.asarray(v).size for v in jax.tree.leaves(variables["params"]))
    assert n_jax == sum(p.numel() for p in mt.parameters())
    assert {n for n, on in trainable_mask(mt, freeze=True).items() if on} == {
        "classifier.weight", "classifier.bias"}
    assert ViT.supports_head_mode


def test_vit_base_widths():
    """The preset's model: ViT-base, 197 tokens at 224x224."""
    m = ViT()
    assert m.num_patches + 1 == 197
    assert sum(p.numel() for p in m.parameters()) == 85_802_501
