"""LFM2-MoE on the CPU at a tiny size (hidden 64, 4 heads over 2 KV heads,
4 layers with one attention, 8 experts of which 4 are held, T 64): the port
against the plain reference ``reference/lfm2_moe.py`` (logits, loss, every
gradient and a ``Trainer`` step with AdamW), the causal plain versions of
K1-K3 against a masked softmax, token ids through the ``Trainer`` as int64,
the shares of the expert layer adding up to the whole layer, and the tally
of routed pairs."""

import math

import pytest
import torch
import torch.nn.functional as F

from eav_tpu_torch.core.config import get_preset
from eav_tpu_torch.core.optim import make_optimizer
from eav_tpu_torch.models.lfm2_moe import Lfm2Moe
from eav_tpu_torch.ops import attention as A
from eav_tpu_torch.ops import moe
from eav_tpu_torch.train.loop import Trainer
from eav_tpu_torch.train.pipeline import build_model
from reference import lfm2_moe as R

TINY = dict(vocab_size=97, hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
            num_attention_heads=4, num_key_value_heads=2,
            layer_types=["conv", "conv", "full_attention", "conv"], num_dense_layers=2,
            num_experts=8, num_experts_per_tok=2, norm_eps=1e-5, conv_L_cache=3,
            rope_parameters={"rope_theta": 1e6}, num_hidden_layers=4, experts_held=[1, 3, 4, 6])
T = 64


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def weights(cfg, seed=1):
    """Seeded random weights by the reference's shapes: kernels N(0,
    1/fan_in), norm scales 1 + N(0, 0.1), the rest N(0, 0.02)."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, (shape, kind, fan_in) in R.param_shapes(cfg).items():
        z = torch.randn(shape, generator=gen)
        out[name] = z / math.sqrt(fan_in) if kind == "kernel" else (
            1.0 + 0.1 * z if kind == "scale" else 0.02 * z)
    return out


def port(cfg=TINY, seed=1, bias=None, **kw):
    model = Lfm2Moe(**cfg, **kw)
    model.load_state_dict(weights(cfg, seed))  # strict: the parameters are the state dict
    if bias is not None:
        model.set_expert_bias(bias)
    return model


def ids(n=3, seed=2):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, TINY["vocab_size"], (n, T), generator=gen)


BIAS = 0.05 * torch.randn(8, generator=torch.Generator().manual_seed(9))


def test_the_parameters_are_the_state_dict_and_the_reference_shapes():
    model = port()
    names = [n for n, _ in model.named_parameters()]
    assert names == list(model.state_dict()) == list(R.param_shapes(TINY))
    assert all(tuple(p.shape) == R.param_shapes(TINY)[n][0] for n, p in model.named_parameters())
    buffers = {n for n, _ in model.named_buffers()}
    assert buffers and not buffers & set(model.state_dict())
    assert all(float(m.expert_bias.abs().max()) == 0 for m in model.modules()
               if isinstance(m, moe.MoE))


def test_port_equals_the_reference_in_float32():
    """Logits, the loss and every gradient with a nonzero expert bias, in
    float32 on the CPU: the same operations in another order (the short
    convolution as shifted products against ``conv1d``, the experts'
    grouped product against a loop, the flash plain versions against a
    blocked softmax), so they agree to float32's rounding, 1e-5 relative."""
    model, w = port(bias=BIAS), weights(TINY)
    x, y = ids(), torch.tensor([0, 3, 4])
    with torch.no_grad():
        torch.testing.assert_close(model(x), R.logits(x, w, TINY, expert_bias=BIAS), rtol=1e-5,
                                   atol=1e-5)
        torch.testing.assert_close(model(x, mode="head")[:0], model(x)[:0])  # shapes only
        feats = model(x, mode="features")
        torch.testing.assert_close(model(feats, mode="head"), model(x))
    params = {n: t.clone().requires_grad_(True) for n, t in w.items()}
    loss = F.cross_entropy(R.logits(x, params, TINY, expert_bias=BIAS), y)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    port_loss = F.cross_entropy(model(x), y)
    port_loss.backward()
    torch.testing.assert_close(port_loss, loss, rtol=1e-6, atol=1e-6)
    for name, p in model.named_parameters():
        scale = float(grads[name].abs().max()) + 1e-12
        torch.testing.assert_close(p.grad / scale, grads[name] / scale, rtol=1e-5, atol=1e-5,
                                   msg=name)
    gate = grads["model.layers.2.feed_forward.gate.weight"]
    assert float(gate.abs().max()) > 0  # the router learns through the weights


def test_a_trainer_step_with_adamw_equals_the_reference():
    """One ``Trainer.train_step`` (AdamW, decay 0.01) against torch's AdamW on
    the reference's gradients: after the step each parameter agrees to
    float32's rounding of one update (lr 1e-3: 1e-5 absolute) where its
    reference gradient is past float32's rounding of the sums that make it
    (1e-6); below that Adam's update g / (|g| + eps) is the rounding's, and
    only its bound, lr, holds."""
    cfg = get_preset("lfm2_moe_finetune").finetune
    model, w = port(bias=BIAS), weights(TINY)
    trainer = Trainer(model, cfg, device="cpu")
    opt = make_optimizer(model, cfg)
    for group in opt.param_groups:
        group["lr"] = 1e-3
    x, y = ids(4, seed=5), torch.tensor([1, 0, 2, 4])
    loss, _ = trainer.train_step(opt, x, y)
    params = {n: t.clone().requires_grad_(True) for n, t in w.items()}
    ref_opt = torch.optim.AdamW(params.values(), lr=1e-3, weight_decay=cfg.weight_decay)
    ref_loss = F.cross_entropy(R.logits(x, params, TINY, expert_bias=BIAS), y)
    ref_loss.backward()
    ref_opt.step()
    torch.testing.assert_close(loss, ref_loss.detach(), rtol=1e-6, atol=1e-6)
    checked = 0
    for name, p in model.named_parameters():
        ref = params[name]
        sound = ref.grad.abs() >= 1e-6
        checked += int(sound.sum())
        torch.testing.assert_close(p.detach()[sound], ref.detach()[sound], rtol=0, atol=1e-5,
                                   msg=name)
        assert float((p.detach() - ref.detach()).abs().max()) <= 2e-3 * 1.001, name
    assert checked > 0.5 * sum(p.numel() for p in model.parameters())


def test_causal_plain_versions_equal_a_masked_softmax():
    """K1-K3's plain versions with ``causal``, keys past ``t_real`` masked
    too, against autograd through softmax with the upper triangle at -inf:
    the same float32 arithmetic, 1e-5."""
    gen = torch.Generator().manual_seed(3)
    bh, t, t_real, d = 3, 40, 33, 16
    q, k, v, do = (torch.randn(bh, t, d, generator=gen) for _ in range(4))
    o, lse = A.flash_fwd(q, k, v, t_real, causal=True)
    di = (do * o).sum(-1)
    dk, dv = A.flash_dkv(q, k, v, do, lse, di, t_real, causal=True)
    dq = A.flash_dq(q, k, v, do, lse, di, t_real, causal=True)
    qr, kr, vr = (x.clone().requires_grad_(True) for x in (q, k, v))
    s = qr @ kr.transpose(1, 2) / math.sqrt(d)
    keys = torch.arange(t)
    masked = (keys[None, :] > keys[:, None]) | (keys[None, :] >= t_real)
    p = torch.softmax(s.masked_fill(masked, float("-inf")), dim=-1)
    want = p @ vr
    want.backward(do)
    torch.testing.assert_close(o, want.detach(), rtol=1e-5, atol=1e-5)
    lse_want = torch.logsumexp(s.detach().masked_fill(masked, float("-inf")), -1)
    torch.testing.assert_close(lse, lse_want, rtol=1e-5, atol=1e-5)
    for got, ref in ((dq, qr.grad), (dk, kr.grad), (dv, vr.grad)):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    non_causal, _ = A.flash_fwd(q, k, v, t_real)
    assert not torch.allclose(non_causal, o, atol=1e-3)  # the mode changes the answer


def test_grouped_query_attention_repeats_each_kv_head_over_its_group():
    """``flash_attention`` with 4 query heads over 2 K/V heads equals it on
    K and V repeated by hand (heads 0, 1 read K/V head 0), gradients summed
    back over each group."""
    gen = torch.Generator().manual_seed(4)
    q = torch.randn(2, 24, 4, 16, generator=gen, requires_grad=True)
    k, v = (torch.randn(2, 24, 2, 16, generator=gen, requires_grad=True) for _ in range(2))
    A.flash_attention(q, k, v, causal=True).square().sum().backward()
    got = [x.grad.clone() for x in (q, k, v)]
    for x in (q, k, v):
        x.grad = None
    A.flash_attention(q, k.repeat_interleave(2, 2), v.repeat_interleave(2, 2),
                      causal=True).square().sum().backward()
    for a, b in zip(got, (q.grad, k.grad, v.grad)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_token_ids_reach_the_embedding_as_int64():
    """Through ``predict``, ``extract_features`` and ``train_step`` the
    embedding sees the ids unchanged, int64 (a float32 cast would round ids
    past 2**24 and then fail the lookup)."""
    model = build_model(get_preset("lfm2_moe_finetune"), **TINY, compute_dtype=None,
                        stream_dtype=None)
    seen = []
    model.embed_tokens.register_forward_pre_hook(lambda m, args: seen.append(args[0]))
    trainer = Trainer(model, get_preset("lfm2_moe_finetune").finetune, device="cpu")
    x = ids(4)
    trainer.predict(x.numpy())
    trainer.extract_features(x)
    trainer.train_step(make_optimizer(model, trainer.cfg), x, torch.tensor([0, 1, 2, 3]))
    assert len(seen) == 3
    assert all(s.dtype == torch.int64 and torch.equal(s, x) for s in seen)
    assert trainer._to_device(x.numpy()).dtype == torch.int64
    assert trainer._to_device(x.float().numpy()).dtype == torch.float32


def test_the_shares_of_the_expert_layer_add_up_to_the_whole_layer():
    """One MoE layer on 3 x 64 tokens: the outputs of two disjoint halves
    of the experts (what two ranks of expert parallelism compute) summed
    equal the uncut reference layer with every expert, with the expert
    bias steering the choice (float32, 1e-5)."""
    gen = torch.Generator().manual_seed(6)
    full = dict(TINY, experts_held=None)
    w = weights(full, seed=6)
    pre = "model.layers.2.feed_forward."
    u = torch.randn(3, T, 64, generator=gen)
    want = R.moe(u, w, pre, full, BIAS)
    total = torch.zeros_like(want)
    for share in ([0, 2, 5, 7], [6, 1, 3, 4]):
        layer = moe.MoE(64, 32, 8, 2, share)
        layer.gate.weight.data.copy_(w[pre + "gate.weight"])
        for name in ("w1", "w3", "w2"):  # the share's experts, in its order
            getattr(layer, name).data.copy_(w[pre + name][share])
        layer.expert_bias.copy_(BIAS)
        with torch.no_grad():
            total += layer(u)
    torch.testing.assert_close(total, want, rtol=1e-5, atol=1e-5)
    assert float(want.abs().max()) > 0


def test_the_tally_counts_every_routed_pair():
    """A forward of B rows of T tokens counts B·T·k pairs in each MoE layer,
    held or not, on the experts the router chose."""
    model = port()
    moe.routed_pairs(reset=True)
    x = ids(3)
    with torch.no_grad():
        model(x)
    counts = moe.routed_pairs(reset=True)[("cpu", 8)]
    moes = sum(isinstance(m, moe.MoE) for m in model.modules())
    assert moes == 2 and int(counts.sum()) == 3 * T * TINY["num_experts_per_tok"] * moes
    layer = model.model.layers[2].feed_forward
    u = model.model.layers[2].ffn_norm(torch.zeros(1, 1, 64))
    assert counts.shape == (8,) and int(moe.routed_pairs()[("cpu", 8)].sum()) == 0
    with torch.no_grad():
        idx, w = layer.route(u.reshape(1, 64))
    assert idx.shape == (1, 2) and torch.allclose(w.sum(-1), torch.ones(1), atol=1e-5)


def test_the_reference_imports_nothing_of_the_program():
    """``reference/lfm2_moe.py`` (and the benchmark's module it names) loads
    no JAX, no ``eav_tpu`` and nothing of the port (top-level module names,
    in a fresh process)."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    code = ("import sys, json; sys.path.insert(0, %r); import reference.lfm2_moe; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))" % str(root))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True).stdout
    names = set(json.loads(out.strip().splitlines()[-1]))
    assert "reference" in names and "torch" in names
    assert not names & {"jax", "jaxlib", "flax", "eav_tpu", "eav_tpu_torch"}
