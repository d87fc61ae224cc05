"""The reference equals the port's AST and ViT at tiny widths on the CPU, in
float32 with plain attention, on the weights the benchmark makes: logits,
features, and one training step's loss and gradients, each as the family
file gives it. (This test imports both; the reference itself imports
nothing of the port.)"""

import json

import pytest
import torch
import torch.nn.functional as F

from conftest import ROOT, TINY

from benchmark import common
from benchmark.harness import load_family
from benchmark.reference import shared
from benchmark.reference import transformer as reference


def tiny(name):
    cfg = json.loads((ROOT / f"benchmark/configs/{name}.json").read_text())
    for block, values in TINY[name].items():
        cfg[block].update(values)
    return cfg


def port_model(cfg):
    from eav_tpu_torch.models.ast import AST
    from eav_tpu_torch.models.vit import ViT

    widths = {k: v for k, v in cfg["model"].items() if k != "family"}
    if cfg["model"]["family"] == "ast":
        return AST(**widths, attn_impl="math")
    return ViT(**widths, attn_impl="math", preprocess_uint8=True)


@pytest.mark.parametrize("name", ["ast_base", "vit_base"])
def test_reference_equals_the_port_in_float32(name):
    cfg = tiny(name)
    fam = load_family(ROOT, cfg)
    weights = common.make_weights(fam, cfg["model"], 5, "cpu")
    model = port_model(cfg)
    model.load_state_dict(weights)  # strict: the same names and shapes
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        {k: s for k, (s, _, _) in fam.param_shapes(cfg["model"]).items()}
    x, y, _, _ = common.make_subject(cfg, 5, "cpu")
    x, y = x[:4], y[:4]
    seen = []
    fam.hidden_module(model).register_forward_hook(lambda m, args, out: seen.append(out))
    with torch.no_grad():
        torch.testing.assert_close(fam.features(x, weights, cfg["model"]),
                                   model(x, mode="features"), rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(fam.logits(x, weights, cfg["model"]), model(x),
                                   rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(fam.hidden(x, weights, cfg["model"]), seen[-1],
                                   rtol=1e-5, atol=1e-5)
    params = {n: w.clone().requires_grad_(True) for n, w in weights.items()}
    loss = F.cross_entropy(fam.logits(x, params, cfg["model"]), y)
    grads = torch.autograd.grad(loss, list(params.values()))
    port_loss = F.cross_entropy(model(x), y)
    port_loss.backward()
    torch.testing.assert_close(loss, port_loss, rtol=1e-6, atol=1e-6)
    named = dict(model.named_parameters())
    for n, g in zip(params, grads):
        torch.testing.assert_close(g, named[n].grad, rtol=1e-4, atol=1e-6)


def test_adamw_equals_torch():
    torch.manual_seed(0)
    p = {"w": torch.randn(5, 3)}
    q = torch.nn.Parameter(p["w"].clone())
    opt = torch.optim.AdamW([q], lr=1e-2, weight_decay=0.01)
    state = {}
    for _ in range(3):
        g = torch.randn(5, 3)
        shared.adamw_step(p, {"w": g}, state, 1e-2, 0.01)
        q.grad = g.clone()
        opt.step()
    torch.testing.assert_close(p["w"], q.detach(), rtol=1e-6, atol=1e-7)


def test_the_control_rounds_to_float8():
    x = torch.linspace(-3, 3, 101, requires_grad=True)
    y = reference._operand(x, "fp8")
    assert (y - x).abs().max() > 0 and (y - x).abs().max() < 3 * 2**-3
    y.sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))  # straight through
    assert reference._operand(x, "float32") is x
