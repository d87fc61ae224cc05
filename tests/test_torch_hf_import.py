"""The port's HF checkpoint import against ``transformers`` and the JAX
package: tiny random ``ASTConfig`` / ``ViTConfig`` models give the same f32
logits in HF, in the port (``models/hf_import.py``) and in JAX
(``convert_*`` + ``apply``); the swapped head is JAX's; the port's own
safetensors reader and writer against ``safetensors``; the ``.bin`` path;
``_pretrained_params``'s gate; and ``run_audio`` from a checkpoint."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file, save_file
from safetensors.torch import save_file as torch_save_file
from transformers import ASTConfig, ASTForAudioClassification, ViTConfig, ViTForImageClassification

from eav_tpu.models import hf_import as jax_hf
from eav_tpu.models.ast import AST as JaxAST
from eav_tpu.models.vit import ViT as JaxViT
from eav_tpu_torch.models import hf_import as H
from eav_tpu_torch.models.ast import ast_tiny
from eav_tpu_torch.models.vit import vit_tiny
from eav_tpu_torch.train import pipeline as P

HID, LAYERS, HEADS, MLP = 32, 2, 2, 64


@pytest.fixture(scope="module")
def hf_ast():
    cfg = ASTConfig(hidden_size=HID, num_hidden_layers=LAYERS, num_attention_heads=HEADS,
                    intermediate_size=MLP, patch_size=16, frequency_stride=10, time_stride=10,
                    max_length=128, num_mel_bins=128, num_labels=5,
                    attention_probs_dropout_prob=0.0, hidden_dropout_prob=0.0)
    torch.manual_seed(0)
    return ASTForAudioClassification(cfg).eval()


@pytest.fixture(scope="module")
def hf_vit():
    cfg = ViTConfig(hidden_size=HID, num_hidden_layers=LAYERS, num_attention_heads=HEADS,
                    intermediate_size=MLP, patch_size=16, image_size=64, num_labels=5,
                    attention_probs_dropout_prob=0.0, hidden_dropout_prob=0.0)
    torch.manual_seed(1)
    return ViTForImageClassification(cfg).eval()


def _port_ast(sd):
    m = ast_tiny(layers=LAYERS)
    m.load_state_dict(sd)
    return m.eval()


def test_ast_logits_match_hf_and_jax(hf_ast, rng):
    x = rng.normal(size=(2, 128, 128)).astype(np.float32)
    with torch.no_grad():
        ref = hf_ast(torch.from_numpy(x)).logits.numpy()
        got = _port_ast(H.convert_ast_state_dict(hf_ast.state_dict(), swap_head=False))(
            torch.from_numpy(x)).numpy()
    params = jax_hf.convert_ast_state_dict(hf_ast.state_dict(), num_layers=LAYERS,
                                           swap_head=False)
    jax_model = JaxAST(num_labels=5, hidden=HID, layers=LAYERS, heads=HEADS, mlp_dim=MLP,
                       max_frames=128, num_mel_bins=128)
    want = np.asarray(jax_model.apply({"params": params}, jnp.asarray(x), train=False))
    assert got.shape == ref.shape == (2, 5)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_vit_logits_match_hf_and_jax(hf_vit, rng):
    """NHWC frames in the port and JAX, NCHW in HF."""
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        ref = hf_vit(torch.from_numpy(x).permute(0, 3, 1, 2)).logits.numpy()
        m = vit_tiny(layers=LAYERS)
        m.load_state_dict(H.convert_vit_state_dict(hf_vit.state_dict(), swap_head=False))
        got = m.eval()(torch.from_numpy(x)).numpy()
    params = jax_hf.convert_vit_state_dict(hf_vit.state_dict(), num_layers=LAYERS,
                                           swap_head=False)
    jax_model = JaxViT(num_labels=5, hidden=HID, layers=LAYERS, heads=HEADS, mlp_dim=MLP,
                       patch_size=16, image_size=64)
    want = np.asarray(jax_model.apply({"params": params}, jnp.asarray(x), train=False))
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("kind", ["ast", "vit"])
def test_swapped_head_is_jaxs(hf_ast, hf_vit, kind):
    """The new head, drawn from ``default_rng(head_seed)``, equals JAX's
    (transposed); AST keeps the checkpoint's classifier LayerNorm."""
    sd = (hf_ast if kind == "ast" else hf_vit).state_dict()
    port = getattr(H, f"convert_{kind}_state_dict")(sd, num_labels=7, head_seed=3)
    jax_tree = getattr(jax_hf, f"convert_{kind}_state_dict")(sd, num_labels=7, head_seed=3,
                                                             num_layers=LAYERS)
    np.testing.assert_array_equal(port["classifier.weight"].numpy(),
                                  jax_tree["classifier"]["kernel"].T)
    np.testing.assert_array_equal(port["classifier.bias"].numpy(), jax_tree["classifier"]["bias"])
    assert port["classifier.weight"].shape == (7, HID)
    if kind == "ast":
        np.testing.assert_array_equal(port["classifier_ln.weight"].numpy(),
                                      sd["classifier.layernorm.weight"].numpy())


def test_inverse_renaming_round_trips(hf_ast, hf_vit):
    """``to_hf_state_dict`` gives back the checkpoint, q/k/v split."""
    for kind, model in (("ast", hf_ast), ("vit", hf_vit)):
        sd = model.state_dict()
        port = getattr(H, f"convert_{kind}_state_dict")(sd, swap_head=False)
        back = H.to_hf_state_dict(port, kind)
        assert set(back) == set(sd)
        for name, value in sd.items():
            assert torch.equal(back[name], value), name


def test_safetensors_reader_and_writer_match_the_library(tmp_path, rng):
    """The port reads what ``safetensors`` writes (every dtype the import can
    meet, bf16 included) and writes what it reads."""
    arrays = {"f32": rng.normal(size=(3, 4)).astype(np.float32),
              "f16": rng.normal(size=(5,)).astype(np.float16),
              "f64": rng.normal(size=(2, 1, 2)),
              "i64": np.arange(7, dtype=np.int64), "scalar": np.array(2.5, np.float32)}
    save_file(arrays, str(tmp_path / "a.safetensors"))
    got = H.read_safetensors(str(tmp_path / "a.safetensors"))
    assert set(got) == set(arrays)
    for name, value in arrays.items():
        np.testing.assert_array_equal(got[name].numpy(), value, err_msg=name)
        assert got[name].numpy().dtype == value.dtype
    bf = {"bf16": torch.randn(4, 3, generator=torch.Generator().manual_seed(0)).bfloat16()}
    torch_save_file(bf, str(tmp_path / "b.safetensors"))
    assert torch.equal(H.read_safetensors(str(tmp_path / "b.safetensors"))["bf16"], bf["bf16"])
    H.write_safetensors(str(tmp_path / "c.safetensors"),
                        {k: torch.from_numpy(np.asarray(v)) for k, v in arrays.items()})
    back = load_file(str(tmp_path / "c.safetensors"))
    for name, value in arrays.items():
        np.testing.assert_array_equal(back[name], value, err_msg=name)


def test_checkpoint_directory(tmp_path, hf_ast):
    """``model.safetensors`` first, else ``pytorch_model.bin``; neither, or a
    path that is no directory, raises."""
    sd = hf_ast.state_dict()
    torch.save(sd, str(tmp_path / "pytorch_model.bin"))
    loaded = H.load_state_dict_from_dir(str(tmp_path))
    assert all(torch.equal(loaded[k], sd[k]) for k in sd)
    H.write_safetensors(str(tmp_path / "model.safetensors"), {"only": torch.zeros(1)})
    assert set(H.load_state_dict_from_dir(str(tmp_path))) == {"only"}
    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError):
        H.load_state_dict_from_dir(str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError):
        H.load_state_dict_from_dir(str(tmp_path / "missing"))


@pytest.mark.parametrize("model,env", [("ast", "EAV_TPU_AST_CKPT"), ("vit", "EAV_TPU_VIT_CKPT")])
def test_pretrained_params_gate(tmp_path, monkeypatch, hf_ast, hf_vit, model, env):
    """Unset or empty: None. A directory with a checkpoint: the converted
    state dict, the same object from the cache. A directory without one, or
    a path that is none: FileNotFoundError, never random weights."""
    monkeypatch.delenv(env, raising=False)
    assert P._pretrained_params(model, 5) is None
    monkeypatch.setenv(env, "")
    assert P._pretrained_params(model, 5) is None
    hf = hf_ast if model == "ast" else hf_vit
    H.write_safetensors(str(tmp_path / "model.safetensors"), hf.state_dict())
    monkeypatch.setenv(env, str(tmp_path))
    cache = {}
    got = P._pretrained_params(model, 5, cache)
    assert P._pretrained_params(model, 5, cache) is got
    want = getattr(H, f"convert_{model}_state_dict")(hf.state_dict())
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
    os.makedirs(tmp_path / "empty")
    for bad in (tmp_path / "empty", tmp_path / "missing"):
        monkeypatch.setenv(env, str(bad))
        with pytest.raises(FileNotFoundError):
            P._pretrained_params(model, 5)


def test_run_audio_starts_from_the_checkpoint(tmp_path, monkeypatch, hf_ast, rng):
    """``run_audio`` with ``EAV_TPU_AST_CKPT``: after a frozen epoch the
    backbone is the checkpoint's, bit for bit, and the head moved off the
    swapped one by at most Adam's bound (lr a step)."""
    from test_torch_pipeline import _subject, _tiny_preset

    import dataclasses

    from eav_tpu_torch.core.config import PhaseConfig

    _subject(tmp_path / "EAV", rng)
    ckpt = tmp_path / "ckpt"
    os.makedirs(ckpt)
    torch.save(hf_ast.state_dict(), str(ckpt / "pytorch_model.bin"))
    monkeypatch.setenv("EAV_TPU_AST_CKPT", str(ckpt))
    base = _tiny_preset()
    kw = dict(base.finetune.model_kwargs, layers=LAYERS, compute_dtype=None, stream_dtype=None)
    preset = base.replace(finetune=dataclasses.replace(
        base.finetune, phases=(PhaseConfig(1, 5e-4, True),), model_kwargs=kw))
    pipes = P.ModalityPipelines(str(tmp_path / "EAV"), presets={"audio": preset}, device="cpu")
    res = pipes.run_audio(1)
    init = H.convert_ast_state_dict(hf_ast.state_dict())
    steps = 2  # 5 train segments in batches of 4
    for name, value in init.items():
        got = res.artifacts["params"][name]
        if name.startswith(("classifier.", "classifier_ln.")):
            assert float((got - value).abs().max()) <= steps * 5e-4 * 1.01, name
        else:
            assert torch.equal(got, value), name
