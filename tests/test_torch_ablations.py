"""The port's ablation and microbenchmark scripts on the CPU at tiny widths:
``eav_tpu_torch/scripts/{ast_ablation,ast_component_times,
flash_layout_experiment,vit_ablation,microbench,family_microbench,
eegnet_stacked_ablation,measure_mtcnn}.py``, against the JAX package where
the two compute the same thing.

The JAX scripts assert a TPU and most do their work at module level, so the
JAX side is built here from the package's functions on the same inputs: the
layout experiment's two sublayers through ``eav_tpu``'s ``flash_attention``
/ ``flash_attention_bh`` in interpret mode; the microbenchmark's attention
through ``flash_attention(..., interpret=True)`` and ``_reference_attention``
at the tolerances of ``tests/test_pallas_attention.py``; a Flax
``TransformerLayer`` carried across by the weight bridge for the component
timer's modules. ``measure_mtcnn``'s frames and random weights come from the
JAX script itself, loaded by path (its ``eav_tpu`` imports sit inside its
functions). The JAX side computes in float32 (``tests/conftest.py`` turns
on x64).
"""

import ast
import importlib.util
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eav_tpu_torch.scripts import ast_ablation as AA
from eav_tpu_torch.scripts import ast_component_times as AC
from eav_tpu_torch.scripts import bench as B
from eav_tpu_torch.scripts import eegnet_stacked_ablation as EA
from eav_tpu_torch.scripts import family_microbench as FB
from eav_tpu_torch.scripts import flash_layout_experiment as FL
from eav_tpu_torch.scripts import measure_mtcnn as MM
from eav_tpu_torch.scripts import microbench as MB
from eav_tpu_torch.scripts import vit_ablation as VA
from test_torch_parallel import one_thread  # noqa: F401  (one intra-op thread a test)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(hidden=32, layers=2, heads=2, mlp_dim=64)
EEGNET_TINY = dict(kern_length=16, f1=4, d=2, f2=8)
H100 = "NVIDIA H100 80GB HBM3"


def _keys(lines, want):
    for line in lines:
        assert set(line) == set(want), sorted(line)
        assert line["device"] == "cpu"
        if "device_ms" in line:
            assert line["device_ms"] is None  # no device clock off the card


def _jax_script_constant(name, constant):
    """A module-level constant of the JAX script ``scripts/<name>.py``,
    evaluated from its syntax tree (the script runs its work on import)."""
    with open(os.path.join(REPO, "scripts", f"{name}.py")) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == constant
                                                for t in node.targets):
            return eval(compile(ast.Expression(node.value), name, "eval"))
    raise KeyError(constant)


def test_peaks_are_the_h100s(monkeypatch):
    """TFLOP/s and MFU against the H100's published peaks for the type, and
    null off the card."""
    assert B.card_peak_flops(H100, "bfloat16") == 989e12
    assert B.card_peak_flops(H100, "float32") == 67e12
    with pytest.raises(ValueError, match="no published"):
        B.card_peak_flops(H100, "float16")
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: H100)
    card = types.SimpleNamespace(type="cuda")
    assert B.achieved(98.9e12, card) == {"tflops": 98.9, "mfu_pct": 10.0}
    assert B.achieved(6.7e12, card, "float32") == {"tflops": 6.7, "mfu_pct": 10.0}
    assert B.achieved(1e12, torch.device("cpu")) == {"tflops": None, "mfu_pct": None}


def test_ast_ablation_runs_at_tiny_widths():
    lines = AA.ablate("cpu", steps=1, batch=2, max_frames=128, **TINY)
    assert [(l["variant"], l["part"]) for l in lines] == [
        (f"{v}-bf16", p) for v in ("flash", "math") for p in ("fwd", "fwd_bwd", "step")]
    _keys(lines, {"variant", "part", "wall_ms", "device_ms", "samples_per_sec", "batch",
                  "device"})


def _jax_layer(x, hidden=32, heads=2, mlp=64):
    """(a Flax TransformerLayer's float32 output on ``x``, its parameters)."""
    from eav_tpu.models.transformer import TransformerLayer

    layer = TransformerLayer(hidden, heads, mlp, attn_impl="xla", dtype=jnp.float32)
    params = layer.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    return np.asarray(layer.apply({"params": params}, jnp.asarray(x))), params


def test_component_modules_are_the_models_and_match_jax():
    """The timed components are ``models/transformer.py``'s modules; a layer
    built from JAX's ``TransformerLayer`` through the weight bridge gives the
    same forward, and its two sublayer components compose to it."""
    from eav_tpu_torch.models.bridge import transformer_layer_params_from_jax
    from eav_tpu_torch.models.transformer import PatchProj, TransformerLayer

    built = {n: b() for n, (b, _) in AC.components(32, 2, 64, "float32").items()}
    assert isinstance(built.pop("patch_embed"), PatchProj)
    assert all(isinstance(m, TransformerLayer) for m in built.values())
    x = np.random.default_rng(0).normal(size=(2, 20, 32)).astype(np.float32)
    want, params = _jax_layer(x)
    sd = transformer_layer_params_from_jax(jax.tree.map(np.asarray, params))
    xt = torch.from_numpy(x)
    with torch.no_grad():
        for name in ("layer", "attn_flash", "attn_math", "mlp"):
            built[name].load_state_dict(sd)
        got = AC.apply("layer", built["layer"], xt)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        for attn in ("attn_flash", "attn_math"):
            composed = AC.apply("mlp", built["mlp"], AC.apply(attn, built[attn], xt))
            np.testing.assert_allclose(composed.numpy(), want, rtol=1e-5, atol=1e-5)


def test_component_times_run_at_tiny_widths():
    lines = AC.measure("cpu", steps=1, batch=2, tokens=20, frames=128, hidden=32, heads=2,
                       mlp=64)
    assert len(lines) == 2 * (1 + 2 * 4)  # patch_embed in float32; the rest in both streams
    _keys(lines, {"component", "stream", "part", "wall_ms", "device_ms", "device"})


B_, T_, H_, D_ = 2, 50, 2, 16


def _jax_layouts():
    """The JAX script's two sublayers at (B 2, T 50, H 2, D 16), through the
    Pallas kernels in interpret mode."""
    from eav_tpu.ops.pallas.attention import _pick_blocks, flash_attention, flash_attention_bh

    hid = H_ * D_

    def attn_bthd(x, wqkv, wout):
        qkv = jnp.einsum("btc,ckf->btkf", x, wqkv)
        q, k, v = (qkv[:, :, i, :].reshape(B_, T_, H_, D_) for i in range(3))
        return flash_attention(q, k, v, True).reshape(B_, T_, hid) @ wout

    def attn_bhtd(x, wqkv, wout):
        w = wqkv.reshape(hid, 3, H_, D_)
        _, _, t_pad = _pick_blocks(T_)
        qkv = jnp.einsum("btc,ckhd->kbhtd", x, w)
        qkv = jnp.pad(qkv, ((0, 0), (0, 0), (0, 0), (0, t_pad - T_), (0, 0)))
        q, k, v = (qkv[i].reshape(B_ * H_, t_pad, D_) for i in range(3))
        o = flash_attention_bh(q, k, v, T_, True)
        o = o.reshape(B_, H_, t_pad, D_)[:, :, :T_, :]
        return jnp.einsum("bhtd,hdc->btc", o, wout.reshape(H_, D_, hid))

    return {"attn_bthd": attn_bthd, "attn_bhtd": attn_bhtd}


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * np.abs(want).max())


def test_layouts_match_each_other_and_jax():
    """Loss and gradients with respect to Wqkv and Wout: the port's two
    layouts equal each other, and JAX's same two functions through its
    kernels in interpret mode, to 1e-5 relative."""
    x, wqkv, wout = FL.inputs("cpu", B_, T_, H_, D_, "float32")
    got = {n: FL.loss_and_grads(fn, x, wqkv, wout, H_) for n, fn in FL.LAYOUTS.items()}
    for a, b in zip(got["attn_bthd"], got["attn_bhtd"]):
        _close(a.numpy(), b.numpy())
    arrays = [jnp.asarray(t.numpy()) for t in (x, wqkv, wout)]
    for name, fn in _jax_layouts().items():
        loss = lambda x, wq, wo: jnp.sum(fn(x, wq, wo).astype(jnp.float32) ** 2)  # noqa: E731
        want_loss, want_grads = jax.value_and_grad(loss, argnums=(1, 2))(*arrays)
        for g, w in zip(got[name], (want_loss, *want_grads)):
            _close(g.numpy(), w)
    lines = FL.experiment("cpu", steps=1, batch=B_, tokens=T_, heads=H_, head_dim=D_,
                          dtype="float32")
    assert [l.get("layout") for l in lines[:2]] == ["attn_bthd", "attn_bhtd"]
    assert lines[-1]["rel"] < 1e-5


def test_vit_ablation_runs_at_tiny_widths():
    assert VA.FLOP_PER_SAMPLE == _jax_script_constant("vit_ablation", "FLOP_PER_SAMPLE")
    lines = VA.ablate("cpu", steps=1, batch=2, image=32, **TINY)
    steps = [l for l in lines if l.get("part") == "step"]
    assert [l["variant"] for l in steps] == list(VA.VARIANTS)
    _keys(steps, {"variant", "part", "wall_ms", "device_ms", "samples_per_sec", "tflops",
                  "mfu_pct", "device"})
    assert all(l["tflops"] is None for l in steps)  # no device rate off the card
    assert [l["component"] for l in lines[-2:]] == ["uint8 preprocess alone", "patch_embed[conv]"]


def test_microbench_attention_matches_jax():
    """At T 300 (B 1, H 2, D 16): the port's ``flash_attention`` through the
    plain versions against JAX's Pallas kernels in interpret mode and its
    ``_reference_attention``, values and the three gradients, at the
    tolerances of tests/test_pallas_attention.py."""
    from eav_tpu.ops.pallas.attention import _reference_attention, flash_attention as jax_flash
    from eav_tpu_torch.ops.attention import flash_attention

    q, k, v = MB.attention_inputs(300, 1, 2, 16, "float32", "cpu")
    out = flash_attention(q, k, v)
    qkv = [jnp.asarray(t.numpy()) for t in (q, k, v)]
    for want in (jax_flash(*qkv, True), _reference_attention(*qkv)):
        np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(MB.reference_attention(q, k, v).numpy(),
                               np.asarray(_reference_attention(*qkv)), rtol=2e-5, atol=2e-5)
    for port_fn, jax_fn in ((flash_attention, lambda *a: jax_flash(*a, True)),
                            (MB.reference_attention, _reference_attention)):
        got = MB.loss_and_grads(port_fn, q, k, v)
        loss = lambda *a: jnp.sum(jax_fn(*a).astype(jnp.float32) ** 2)  # noqa: E731
        want_loss, want_grads = jax.value_and_grad(loss, argnums=(0, 1, 2))(*qkv)
        np.testing.assert_allclose(float(got[0]), float(want_loss), rtol=2e-5)
        for g, w in zip(got[1:], want_grads):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4, atol=2e-4)


def test_microbench_runs_at_tiny_widths():
    lines = MB.run("all", device="cpu", steps=1, cases=[(300, 1, 2, 16, "float32")],
                   eegnet=dict(chans=4, samples=64, **EEGNET_TINY), eegnet_batch=8,
                   ast=dict(TINY, max_frames=128), ast_batch=2)
    assert [l["case"] for l in lines] == [
        "eegnet f32 bs256", "eegnet bf16 bs256", "ast f32 bs8", "ast bf16 bs8",
        "ast bf16+flash bs8", "ast f32+flash bs8", "attn fwd+bwd T=300 B=1 H=2 D=16 float32"]
    _keys(lines[:-1], {"case", "wall_ms", "device_ms", "samples_per_sec", "device"})
    attn = lines[-1]
    assert attn["math_ms"] > 0 and attn["flash_device_ms"] is None
    assert attn["launches_per_call"] == {"flash_fwd": 0, "flash_dkv": 0, "flash_dq": 0}
    assert MB.FLASH_CASES[0] == (4096, 2, 8, 64, "bfloat16")
    assert [c[0] for c in MB.LONG_CASES] == [16384, 32768]


def test_family_microbench_runs_at_tiny_widths():
    lines = FB.run("all", "cpu", 1, conformer=dict(chans=4, samples=100, num_layers=2),
                   conformer_shape=(4, 100), resnet_shape=(16, 16, 3))
    assert [(l["case"], l["dtype"]) for l in lines] == [
        ("conformer_eeg", "float32"), ("scnn_audio", "float32"),
        ("resnet_vision (f32)", "float32"), ("resnet_vision (bf16)", "bfloat16")]
    _keys(lines, {"case", "batch", "wall_ms", "device_ms", "samples_per_sec",
                  "gflop_per_step", "dtype", "tflops", "mfu_pct", "device"})
    assert all(l["gflop_per_step"] > 0 and l["tflops"] is None for l in lines)


def test_eegnet_ablation_temporal_modes_agree():
    """``conv`` and ``fft`` give the same stacked step loss in float32 (to
    its roundoff) from the same seeds and masks."""
    lines = EA.ablate("cpu", stack=2, iters=1, batch=4, chans=4, samples=64, **EEGNET_TINY)
    by = {l["variant"]: l for l in lines}
    assert set(by) == {"fft-f32", "fft-bf16", "conv-f32", "conv-bf16"}
    np.testing.assert_allclose(by["fft-f32"]["first_step_loss"],
                               by["conv-f32"]["first_step_loss"], rtol=1e-5)
    np.testing.assert_allclose(by["fft-bf16"]["first_step_loss"],
                               by["conv-bf16"]["first_step_loss"], rtol=2e-2)
    assert all(l["temporal_device_ms"] is None and l["stack"] == 2 for l in lines)


@pytest.fixture
def jax_mtcnn_script(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jax_cache"))
    spec = importlib.util.spec_from_file_location(
        "jax_measure_mtcnn", os.path.join(REPO, "scripts", "measure_mtcnn.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_mtcnn_frames_and_cascade_match_jax(jax_mtcnn_script, tmp_path):
    """``synth_face_frames`` equals the JAX script's array for array; on two
    120 x 160 frames, the JAX script's ``random_mtcnn_params(0)``, written
    as the converter writes it and read by the port's loader, give the same
    boxes in both cascades (at ``chip_smoke.py``'s cut thresholds, at which
    these random weights find faces)."""
    from eav_tpu.models.mtcnn import MTCNNDetector as JaxDetector, _flatten_tree
    from eav_tpu_torch.models.mtcnn import NETS, MTCNNDetector, load_mtcnn_params

    for n, h, w in ((3, 120, 160), (2, 270, 480)):
        np.testing.assert_array_equal(MM.synth_face_frames(n, h, w),
                                      jax_mtcnn_script.synth_face_frames(n, h, w))
    # traced as one program: the same values as its eager call, which
    # dispatches Flax's init op by op (16 s against 6 s on this host's CPU)
    trees = jax.jit(lambda: jax_mtcnn_script.random_mtcnn_params(0))()
    for net, tree in zip(NETS, trees):
        np.savez(tmp_path / f"{net}.npz", **_flatten_tree(jax.tree.map(np.asarray, tree)))
    thresholds = (0.5, 0.5, 0.35)
    frames = MM.synth_face_frames(2, 120, 160)
    want = JaxDetector(*trees, thresholds=thresholds, face_size=56).detect_batched(frames)
    got = MTCNNDetector(*load_mtcnn_params(str(tmp_path)), thresholds=thresholds,
                        face_size=56, device="cpu").detect_batched(frames)
    hits = 0
    for (gb, gp), (wb, wp) in zip(got, want, strict=True):
        assert (gb is None) == (wb is None)
        if wb is not None:
            hits += 1
            np.testing.assert_allclose(gb, wb, rtol=0, atol=0.02)
            assert abs(gp - wp) < 1e-4
    assert hits > 0, "no frame produced a detection"


def test_measure_mtcnn_runs_on_the_cpu():
    lines = MM.measure("cpu", frames=2, sizes=((120, 160),))
    assert [l["metric"] for l in lines] == ["mtcnn_batched_fps_160x120",
                                            "mtcnn_perframe_fps_160x120"]
    assert lines[0]["busy_pct"] is None and all(l["value"] > 0 for l in lines)
