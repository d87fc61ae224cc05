"""The family ``lfm2_moe`` at its tiny cut on the CPU: the benchmark's
reference copy equals the port in float32 (logits, features, the last
layer's output, one step's loss and gradients), checkpointed or not; the
family's ``param_shapes`` are the model's ``named_parameters`` and its state
dict, key for key; the configuration keeps the published config's numbers
and cuts only what ``reduced`` names; and the kernel work counts causal
attention as half the scores; the reference breaks a near-tie of the
routing as the port's recorded choice broke it, and only a near-tie. (This
test imports both; the reference imports nothing of the port.)"""

import json

import pytest
import torch
import torch.nn.functional as F

from conftest import ROOT, TINY

from benchmark import common, yardstick
from benchmark.harness import load_family, run_cell
from benchmark.reference import lfm2_moe as R

NAME = "lfm2_24b_a2b"


def config(tiny=True):
    cfg = json.loads((ROOT / f"benchmark/configs/{NAME}.json").read_text())
    if tiny:
        for block, values in TINY[NAME].items():
            cfg[block].update(values)
    return cfg


def port_model(cfg):
    from eav_tpu_torch.models.lfm2_moe import Lfm2Moe

    return Lfm2Moe(**{k: v for k, v in cfg["model"].items() if k != "family"})


def test_param_shapes_are_the_models_parameters_and_state_dict():
    cfg = config()
    fam, model = load_family(ROOT, cfg), port_model(cfg)
    shapes = fam.param_shapes(cfg["model"])
    assert list(shapes) == [n for n, _ in model.named_parameters()] == list(model.state_dict())
    for name, p in model.named_parameters():
        assert tuple(p.shape) == shapes[name][0], name
        kind, fan_in = shapes[name][1:]
        assert (kind == "kernel") == (fan_in is not None)


@pytest.mark.parametrize("grad", [False, True])
def test_reference_equals_the_port_in_float32(grad):
    """float32 both (the port with no compute dtype): 1e-5, the rounding of
    the same sums in another order; with ``grad`` the reference runs
    checkpointed (its layers and attention blocks recomputed)."""
    cfg = config()
    fam, m = load_family(ROOT, cfg), cfg["model"]
    weights = common.make_weights(fam, m, 7, "cpu")
    model = port_model(cfg)
    model.load_state_dict(weights)
    x, y, _, _ = common.make_subject(cfg, 7, "cpu")
    x, y = x[:4], y[:4]
    seen = []
    fam.hidden_module(model).register_forward_hook(lambda mod, args, out: seen.append(out))
    with torch.no_grad():
        torch.testing.assert_close(fam.logits(x, weights, m), model(x), rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(fam.features(x, weights, m), model(x, mode="features"),
                                   rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(fam.hidden(x, weights, m), seen[-1], rtol=1e-5, atol=1e-5)
    if not grad:
        return
    params = {n: w.clone().requires_grad_(True) for n, w in weights.items()}
    loss = F.cross_entropy(fam.head(fam.pool(fam.hidden(x, params, m), params, m), params, m), y)
    grads = torch.autograd.grad(loss, list(params.values()))
    port_loss = F.cross_entropy(model(x), y)
    port_loss.backward()
    torch.testing.assert_close(loss, port_loss, rtol=1e-6, atol=1e-6)
    named = dict(model.named_parameters())
    for n, g in zip(params, grads):
        scale = float(g.abs().max()) + 1e-12
        torch.testing.assert_close(g / scale, named[n].grad / scale, rtol=1e-5, atol=1e-5, msg=n)


def test_the_configuration_keeps_the_published_numbers():
    """The configuration's top level holds the published config's keys;
    its ``model`` block, which builds the port, holds them too, and cuts
    only ``reduced``'s keys: 10 of 40 layers and 8 of 64 experts held."""
    cfg = config(tiny=False)
    published = {k: v for k, v in cfg.items() if k in cfg["model"] and k not in cfg["reduced"]}
    assert {"hidden_size", "num_experts", "layer_types", "vocab_size"} <= set(published)
    assert all(cfg["model"][k] == v for k, v in published.items())
    assert cfg["reduced"] == ["layers", "experts_held"]
    assert cfg["model"]["layers"] == cfg["layers"] == 10 and cfg["num_hidden_layers"] == 40
    assert cfg["model"]["experts_held"] == cfg["experts_held"] == list(range(8))
    assert cfg["num_experts"] == 64 and cfg["subject"]["vocab"] == cfg["vocab_size"]


def test_the_kernel_work_counts_causal_attention_as_half_the_scores():
    cfg = config(tiny=False)
    fam, m = load_family(ROOT, cfg), cfg["model"]
    work = {(k, calls): (flop, nbytes)
            for k, flop, nbytes, calls in fam.kernel_work(m, [4, 4], True)}
    full = yardstick.attention_work("fwd", 4 * 32, 8192, 64)
    assert work[("flash_fwd", 2 * 2)] == (full[0] / 2, full[1])  # 2 batches x 2 attention layers
    flop, _ = work[("expert_gemm", 2 * 8)]  # 2 batches x 8 MoE layers
    assert flop == 3 * 6 * (4 * 8192 * 4 * 8 / 64) * 2048 * 1536
    assert fam.train_flops(m) == 3 * fam.forward_flops(m) > 0


def test_a_near_tie_is_broken_as_given_and_only_a_near_tie():
    """``select``: a given choice within ``tie`` of the k-th score is taken;
    one further off, a repeated expert or an id out of range is not."""
    scores = torch.tensor([[0.90, 0.50, 0.495, 0.10],
                           [0.90, 0.50, 0.40, 0.10],
                           [0.90, 0.50, 0.495, 0.10],
                           [0.90, 0.50, 0.495, 0.10]])
    given = torch.tensor([[0, 2], [0, 2], [2, 2], [0, -1]], dtype=torch.int8)
    got = R.select(scores, 2, given, tie=0.02).sort(-1).values
    assert got.tolist() == [[0, 2], [0, 1], [0, 1], [0, 1]]
    assert torch.equal(R.select(scores, 2, given, tie=0.0).sort(-1).values,
                       R.select(scores, 2).sort(-1).values)


def test_the_ports_choices_are_recorded_and_given_back():
    """The choices the family records from the port's model (``PortRoutes``)
    are each MoE layer's routing of that forward: a training forward's by
    its batch, an evaluation forward's by its rows and the head's bias."""
    cfg = config()
    fam, m = load_family(ROOT, cfg), cfg["model"]
    model = port_model(cfg)
    model.load_state_dict(common.make_weights(fam, m, 5, "cpu"))
    fam.hidden_module(model)
    moes = [mod for mod in model.modules() if type(mod).__name__ == "MoE"]
    inputs = []
    for mod in moes:
        mod.register_forward_hook(lambda mod, args, out: inputs.append(args[0]))
    x, _, te, _ = common.make_subject(cfg, 5, "cpu")
    model(x[:4]).sum().backward()  # a training forward
    with torch.no_grad():
        want = [mod.route(u.reshape(-1, u.shape[-1]))[0] for mod, u in zip(moes, inputs)]
        params = dict(model.state_dict())
        got = fam._PORT["routes"].given(x[:4], params)
        assert [g.long().tolist() for g in got] == [w.tolist() for w in want]
        inputs.clear()
        model(te[:8])  # an evaluation forward; the reference's block is rows 2-5
        rows = [mod.route(u.reshape(-1, u.shape[-1]))[0].view(8, -1, 2)[2:6].reshape(-1, 2)
                for mod, u in zip(moes, inputs)]
        got = fam._PORT["routes"].given(te[2:6], params)
        assert [g.long().tolist() for g in got] == [r.tolist() for r in rows]
        params["classifier.bias"] = params["classifier.bias"] + 1.0  # other weights
        assert fam._PORT["routes"].given(te[2:6], params) is None


def test_a_router_choosing_wrongly_is_not_correct(tiny_root, monkeypatch):
    """A port that routes each token to its experts ranked k+1 to 2k: the
    reference takes no such choice (each lies beyond a near-tie), and the
    run is not correct."""
    from eav_tpu_torch.ops.moe import MoE

    def wrong(self, u):
        scores = torch.sigmoid(F.linear(u.float(), self.gate.weight))
        idx = torch.topk(scores + self.expert_bias, 2 * self.top_k, dim=-1).indices[:, self.top_k:]
        w = scores.gather(1, idx)
        return idx, w / (w.sum(-1, keepdim=True) + 1e-6)

    torch.set_num_threads(2)
    monkeypatch.setattr(MoE, "route", wrong)
    result, info = run_cell("lfm2_24b_a2b.unfrozen", 2**31 + 37, 0.2, False, "cpu", root=tiny_root)
    assert result["correct"] is False and result["failed"] >= 1, info["readings"]
