"""Plain PyTorch LFM2-MoE classifier in float32: the reference the port is
held against, by the benchmark (``benchmark/families/lfm2_moe.py``) and by
the port's tests (through ``reference/lfm2_moe.py`` at the repo's root,
which names this module). ``precision='fp8'`` is the comparison's control
(every matmul and convolution takes its operands rounded to float8,
``shared.operand``); while a gradient is taken, ``torch.utils.checkpoint``
wraps each layer and each block of attention's query rows, so that one
float32 gradient over a batch of 4 x 8,192 tokens fits on the card beside
the optimizer's state (in float32 without a gradient both change nothing).

Written from the equations of Liquid AI's ``lfm2_moe`` architecture (the
published ``config.json`` of LFM2-8B-A1B and LFM2-24B-A2B and the model
card's description), independent of the program under test: it imports no
JAX, no ``eav_tpu`` and nothing of the port, and computes in float32 with
TF32 off (``fp32_matmuls``). Parameters are a flat dict of tensors under the
names the port's ``state_dict`` uses (``param_shapes``).

- embedding: x = E[ids];
- layer i (the first ``layers`` of ``layer_types``): h = x + op(RMSNorm(x)),
  out = h + ffn(RMSNorm(h)), RMSNorm(x) = x / sqrt(mean(x^2) + eps) * g;
- 'conv': [B, C, x~] = split3(W_in u), y = C * conv(B * x~), op = W_out y,
  conv causal and depthwise over L = ``conv_L_cache`` positions, no bias
  (``torch.nn.functional.conv1d`` padded by L - 1 and cut to T);
- 'full_attention': q = RMSNorm_D(W_q u), k = RMSNorm_D(W_k u) per head,
  v = W_v u, RoPE (rotate-half, base theta) on q and k, causal
  softmax(q k^T / sqrt(D)) v with each KV head repeated over its
  H_q / H_kv query heads, then W_o; the scores in blocks of query rows;
- ffn: the first ``num_dense_layers`` layers W2(silu(W1 u) * W3 u); the
  others MoE: s = sigmoid(W_r u) over all experts, the top k of s + b
  (b the expert bias), w = s there, w / (sum w + 1e-6), out = sum over
  the selected experts held here of w_e W2_e(silu(W1_e u) * W3_e u); each
  expert a loop over the tokens that chose it; a near-tie of the selection
  may be broken as given (``select``);
- after the last layer the final RMSNorm (``embedding_norm``); the 5-way
  head reads its output at the last position (a Linear with bias).

Departures from the published model, each the benchmark's cut or its task:
only the first ``layers`` layers (a pipeline stage's share); each MoE layer
computes the share of the experts in ``experts_held`` (expert parallelism's
share), the rest of the sum is left out as the program leaves it out; the
language-model head is replaced by EAV's classifier on the last position;
the expert bias is an argument (zero unless given), not a weight; where
the caller gives each MoE layer's choices (``routes``), a token whose given
experts all score within ``tie`` of its k-th highest takes them (``select``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference.shared import PRECISIONS, fp32_matmuls  # noqa: F401
from benchmark.reference.shared import operand as _op

Q_BLOCK = 256  # query rows of the attention scores at a time


def _mm(a, b, precision):
    """a @ b with both operands at ``precision``."""
    return _op(a, precision) @ _op(b, precision)


def _ckpt(fn, *args):
    """``fn(*args)``, recomputed in the backward when a gradient is taken."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def layer_plan(model: dict) -> List[Tuple[str, bool]]:
    """(op, moe) of each layer kept: 'conv' or 'full_attention', and
    whether its ffn is the expert layer."""
    depth = model.get("layers") or model["num_hidden_layers"]
    return [(kind, i >= model["num_dense_layers"])
            for i, kind in enumerate(model["layer_types"][:depth])]


def held(model: dict) -> List[int]:
    return list(model.get("experts_held") or range(model["num_experts"]))


def param_shapes(model: dict) -> Dict[str, tuple]:
    """name -> (shape, kind, fan_in), in the port's ``named_parameters``
    order. Kinds: 'kernel' (fan_in its input width), 'scale' (a norm's
    weight), 'embed' (the token embedding), 'bias'."""
    h, vocab = model["hidden_size"], model["vocab_size"]
    heads, kv = model["num_attention_heads"], model["num_key_value_heads"]
    d, n_held = h // heads, len(held(model))
    out = {"embed_tokens.weight": ((vocab, h), "embed", None)}
    for i, (op, moe) in enumerate(layer_plan(model)):
        pre = f"model.layers.{i}."
        out[pre + "operator_norm.weight"] = ((h,), "scale", None)
        out[pre + "ffn_norm.weight"] = ((h,), "scale", None)
        if op == "conv":
            taps = model["conv_L_cache"]
            out[pre + "conv.in_proj.weight"] = ((3 * h, h), "kernel", h)
            out[pre + "conv.conv.weight"] = ((h, 1, taps), "kernel", taps)
            out[pre + "conv.out_proj.weight"] = ((h, h), "kernel", h)
        else:
            a = pre + "self_attn."
            out[a + "q_proj.weight"] = ((heads * d, h), "kernel", h)
            out[a + "k_proj.weight"] = ((kv * d, h), "kernel", h)
            out[a + "v_proj.weight"] = ((kv * d, h), "kernel", h)
            out[a + "out_proj.weight"] = ((h, heads * d), "kernel", heads * d)
            out[a + "q_layernorm.weight"] = ((d,), "scale", None)
            out[a + "k_layernorm.weight"] = ((d,), "scale", None)
        f = pre + "feed_forward."
        if moe:
            ffn = model["moe_intermediate_size"]
            out[f + "w1"] = ((n_held, ffn, h), "kernel", h)
            out[f + "w3"] = ((n_held, ffn, h), "kernel", h)
            out[f + "w2"] = ((n_held, h, ffn), "kernel", ffn)
            out[f + "gate.weight"] = ((model["num_experts"], h), "kernel", h)
        else:
            ffn = model["intermediate_size"]
            out[f + "w1.weight"] = ((ffn, h), "kernel", h)
            out[f + "w3.weight"] = ((ffn, h), "kernel", h)
            out[f + "w2.weight"] = ((h, ffn), "kernel", ffn)
    out["embedding_norm.weight"] = ((h,), "scale", None)
    out["classifier.weight"] = ((model.get("num_labels", 5), h), "kernel", h)
    out["classifier.bias"] = ((model.get("num_labels", 5),), "bias", None)
    return out


def rms_norm(x, g, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * g


def rope(x, theta):
    """(B, T, H, D) at positions 0..T-1, rotate-half form."""
    b, t, h, d = x.shape
    inv_freq = 1.0 / theta ** (torch.arange(0, d, 2, device=x.device).float() / d)
    ang = torch.arange(t, device=x.device).float()[:, None] * inv_freq[None, :]
    cos = torch.cat([ang.cos(), ang.cos()], -1)[None, :, None, :]
    sin = torch.cat([ang.sin(), ang.sin()], -1)[None, :, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return x * cos + torch.cat([-x2, x1], -1) * sin


def short_conv(u, p, pre, model, precision="float32"):
    t = u.shape[1]
    bcx = _mm(u, p[pre + "in_proj.weight"].T, precision)
    b, c, x = bcx.chunk(3, dim=-1)
    taps = model["conv_L_cache"]
    y = F.conv1d(_op((b * x).transpose(1, 2), precision), _op(p[pre + "conv.weight"], precision),
                 padding=taps - 1, groups=u.shape[-1])[..., :t].transpose(1, 2)
    return _mm(c * y, p[pre + "out_proj.weight"].T, precision)


def theta(model) -> float:
    return float(model.get("rope_parameters", {}).get("rope_theta", model.get("rope_theta", 1e6)))


def _attend(q, k, v, a, z, precision):
    """Query rows a..z-1 of causal softmax(q k^T / sqrt(D)) v, (B, H, ., D)."""
    t, d = k.shape[2], q.shape[-1]
    s = _mm(q[:, :, a:z], k.transpose(-1, -2), precision) / math.sqrt(d)
    keys = torch.arange(t, device=q.device)
    masked = keys[None, :] > keys[a:z, None]
    probs = torch.softmax(s.masked_fill(masked, float("-inf")), dim=-1)
    return _mm(probs, v, precision)


def attention(u, p, pre, model, precision="float32"):
    b, t, h = u.shape
    heads, kv = model["num_attention_heads"], model["num_key_value_heads"]
    d, eps = h // heads, model["norm_eps"]
    q = rms_norm(_mm(u, p[pre + "q_proj.weight"].T, precision).view(b, t, heads, d),
                 p[pre + "q_layernorm.weight"], eps)
    k = rms_norm(_mm(u, p[pre + "k_proj.weight"].T, precision).view(b, t, kv, d),
                 p[pre + "k_layernorm.weight"], eps)
    v = _mm(u, p[pre + "v_proj.weight"].T, precision).view(b, t, kv, d)
    q, k = rope(q, theta(model)), rope(k, theta(model))
    q = q.transpose(1, 2)  # (B, H, T, D)
    k = k.transpose(1, 2).repeat_interleave(heads // kv, dim=1)
    v = v.transpose(1, 2).repeat_interleave(heads // kv, dim=1)
    blocks = [_ckpt(_attend, q, k, v, a, min(a + Q_BLOCK, t), precision)
              for a in range(0, t, Q_BLOCK)]
    ctx = torch.cat(blocks, dim=2).transpose(1, 2).reshape(b, t, heads * d)
    return _mm(ctx, p[pre + "out_proj.weight"].T, precision)


def swiglu(u, w1, w3, w2, precision="float32"):
    return _mm(F.silu(_mm(u, w1.T, precision)) * _mm(u, w3.T, precision), w2.T, precision)


def select(scores, k, given=None, tie=0.0):
    """The top ``k`` of ``scores`` (N, E) -> (N, k) expert ids. With
    ``given`` (N, k) ids, a token takes those instead where they are k
    distinct experts each scoring within ``tie`` of the token's k-th highest
    score: a near-tie broken as ``given`` broke it (the program's choice,
    which the rounding of its inputs may put on the other side of the tie).
    A given choice further off is not taken."""
    top = torch.topk(scores, k, dim=-1)
    if given is None:
        return top.indices
    given = given.to(scores.device, torch.int64)
    valid = ((given >= 0) & (given < scores.shape[-1])).all(-1)
    given = given.clamp(0, scores.shape[-1] - 1)
    ordered = given.sort(-1).values
    distinct = (ordered[:, 1:] != ordered[:, :-1]).all(-1)
    near = (scores.gather(1, given) >= top.values[:, -1:] - tie).all(-1)
    return torch.where((valid & distinct & near)[:, None], given, top.indices)


def moe(u, p, pre, model, expert_bias=None, precision="float32", given=None, tie=0.0):
    """One MoE layer's share; ``given``, ``tie``: ``select``'s."""
    b, t, h = u.shape
    x = u.reshape(-1, h)
    s = torch.sigmoid(_mm(x, p[pre + "gate.weight"].T, precision))
    bias = torch.zeros_like(s[0]) if expert_bias is None else expert_bias
    idx = select(s.detach() + bias, model["num_experts_per_tok"], given, tie)
    w = s.gather(1, idx)
    if model.get("norm_topk_prob", True):
        w = w / (w.sum(-1, keepdim=True) + 1e-6)
    w = w * model.get("routed_scaling_factor", 1.0)
    out = torch.zeros_like(x)
    for j, e in enumerate(held(model)):
        rows, slot = (idx == e).nonzero(as_tuple=True)
        y = swiglu(x[rows], p[pre + "w1"][j], p[pre + "w3"][j], p[pre + "w2"][j], precision)
        out = out.index_add(0, rows, y * w[rows, slot, None])
    return out.view(b, t, h)


def layer(x, p, i, model, expert_bias=None, precision="float32", given=None, tie=0.0):
    op, is_moe = layer_plan(model)[i]
    pre, eps = f"model.layers.{i}.", model["norm_eps"]
    u = rms_norm(x, p[pre + "operator_norm.weight"], eps)
    if op == "conv":
        x = x + short_conv(u, p, pre + "conv.", model, precision)
    else:
        x = x + attention(u, p, pre + "self_attn.", model, precision)
    u = rms_norm(x, p[pre + "ffn_norm.weight"], eps)
    f = pre + "feed_forward."
    if is_moe:
        return x + moe(u, p, f, model, expert_bias, precision, given, tie)
    return x + swiglu(u, p[f + "w1.weight"], p[f + "w3.weight"], p[f + "w2.weight"], precision)


def hidden(ids, params, model, precision="float32", expert_bias=None, routes=None, tie=0.0):
    """The last layer's (B, T, hidden) output, before the final norm; each
    layer checkpointed while a gradient is taken. ``routes``: one (B·T, k)
    tensor of expert ids or None for each MoE layer in order, the choices
    ``select`` may take within ``tie``."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    plan = layer_plan(model)
    given = iter(routes or [None] * sum(m for _, m in plan))
    x = params["embed_tokens.weight"][ids]
    for i, (_, is_moe) in enumerate(plan):
        g = next(given) if is_moe else None
        x = _ckpt(lambda x, i=i, g=g: layer(x, params, i, model, expert_bias, precision, g, tie), x)
    return x


def pool(h, params, model):
    """The final norm's output at the last position, (B, hidden)."""
    return rms_norm(h[:, -1], params["embedding_norm.weight"], model["norm_eps"])


def head(pooled, params, model, precision="float32"):
    return _mm(pooled, params["classifier.weight"].T, precision) + params["classifier.bias"]


def features(ids, params, model, precision="float32", expert_bias=None, routes=None, tie=0.0):
    """(B, hidden): the final norm's output at the last position."""
    return pool(hidden(ids, params, model, precision, expert_bias, routes, tie), params, model)


def logits(ids, params, model, precision="float32", expert_bias: Optional[torch.Tensor] = None,
           routes=None, tie=0.0):
    """(B, num_labels) logits of (B, T) token ids."""
    return head(features(ids, params, model, precision, expert_bias, routes, tie), params, model,
                precision)
