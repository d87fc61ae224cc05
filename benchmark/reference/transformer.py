"""Plain PyTorch AST and ViT in float32, the benchmark's reference.

A frozen copy of the architectures' equations (Gong et al., arXiv:2104.01778;
Dosovitskiy et al., arXiv:2010.11929; HF ``ASTForAudioClassification`` and
``ViTForImageClassification``), written from the papers' description and
independent of the program under test: it imports nothing of it, and runs
with TF32 off (``fp32_matmuls``). Parameters are a flat dict of tensors
under the names the program's ``state_dict`` uses, so that the benchmark
can hand the same weights to both.

- AST: a (B, frames, mels) fbank is read as a (B, 1, mels, frames) image;
  16x16 patches at stride (10, 10), frequency-major; [CLS] and [distill]
  tokens; learned position embeddings; pre-LN layers; the final LayerNorm;
  pooled = (h[CLS] + h[distill]) / 2; head = LayerNorm + Linear.
- ViT: (B, H, W, 3) uint8 frames rescaled to (x / 255 - 0.5) / 0.5; 16x16
  patches at stride 16, row-major; [CLS]; position embeddings; pre-LN
  layers; the final LayerNorm on [CLS]; head = Linear.
- A layer: x + Attn(LN1(x)), then x + MLP(LN2(x)); attention with one fused
  q/k/v product (output rows q, k, v, each split into heads), softmax of
  QK^T / sqrt(D); MLP = fc2(GELU(fc1)), GELU exact (erf).

``precision='fp8'`` is the control of the benchmark's comparison: every
matmul and convolution takes its operands rounded to float8 e4m3
(``shared.operand``). Everything else stays float32. ``adamw_step`` and
``fp32_matmuls`` are every family's (``shared.py``).
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from benchmark.reference.shared import PRECISIONS, adamw_step, fp32_matmuls  # noqa: F401
from benchmark.reference.shared import operand as _operand


def param_shapes(model: dict) -> Dict[str, tuple]:
    """name -> (shape, kind) of a configuration's ``model`` block. Kinds:
    'kernel' (a weight with fan-in shape[1:]), 'bias', 'scale' (a LayerNorm
    weight), 'shift' (a LayerNorm bias), 'embed' (tokens, positions)."""
    h, mlp, p, labels = model["hidden"], model["mlp_dim"], model["patch_size"], model["num_labels"]
    out: Dict[str, tuple] = {}
    if model["family"] == "ast":
        rows = (model["num_mel_bins"] - p) // model["frequency_stride"] + 1
        cols = (model["max_frames"] - p) // model["time_stride"] + 1
        out["cls_token"] = ((1, 1, h), "embed")
        out["dist_token"] = ((1, 1, h), "embed")
        out["pos_embed"] = ((1, rows * cols + 2, h), "embed")
        out["patch_proj.weight"] = ((h, 1, p, p), "kernel")
    elif model["family"] == "vit":
        out["cls_token"] = ((1, 1, h), "embed")
        out["pos_embed"] = ((1, (model["image_size"] // p) ** 2 + 1, h), "embed")
        out["patch_proj.weight"] = ((h, 3, p, p), "kernel")
    else:
        raise ValueError(f"no reference for the family {model['family']!r}")
    out["patch_proj.bias"] = ((h,), "bias")
    for i in range(model["layers"]):
        pre = f"encoder.layer_{i}."
        out[pre + "ln1.weight"] = ((h,), "scale")
        out[pre + "ln1.bias"] = ((h,), "shift")
        out[pre + "attn.qkv.weight"] = ((3 * h, h), "kernel")
        out[pre + "attn.qkv.bias"] = ((3 * h,), "bias")
        out[pre + "attn.out.weight"] = ((h, h), "kernel")
        out[pre + "attn.out.bias"] = ((h,), "bias")
        out[pre + "ln2.weight"] = ((h,), "scale")
        out[pre + "ln2.bias"] = ((h,), "shift")
        out[pre + "fc1.weight"] = ((mlp, h), "kernel")
        out[pre + "fc1.bias"] = ((mlp,), "bias")
        out[pre + "fc2.weight"] = ((h, mlp), "kernel")
        out[pre + "fc2.bias"] = ((h,), "bias")
    out["final_ln.weight"] = ((h,), "scale")
    out["final_ln.bias"] = ((h,), "shift")
    if model["family"] == "ast":
        out["classifier_ln.weight"] = ((h,), "scale")
        out["classifier_ln.bias"] = ((h,), "shift")
    out["classifier.weight"] = ((labels, h), "kernel")
    out["classifier.bias"] = ((labels,), "bias")
    return out


def _linear(x, params, name, precision):
    w, b = params[name + ".weight"], params[name + ".bias"]
    return F.linear(_operand(x, precision), _operand(w, precision), b)


def _layer_norm(x, params, name, eps):
    return F.layer_norm(x, (x.shape[-1],), params[name + ".weight"], params[name + ".bias"], eps)


def _attention(x, params, pre, heads, precision):
    b, t, h = x.shape
    d = h // heads
    qkv = _linear(x, params, pre + "qkv", precision).view(b, t, 3, heads, d)
    q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))  # (B, heads, T, D)
    scores = torch.matmul(_operand(q, precision), _operand(k, precision).transpose(-1, -2))
    probs = torch.softmax(scores / math.sqrt(d), dim=-1)
    ctx = torch.matmul(_operand(probs, precision), _operand(v, precision))
    ctx = ctx.permute(0, 2, 1, 3).reshape(b, t, h)
    return _linear(ctx, params, pre + "out", precision)


def encoder(x, params, model, precision="float32"):
    """The pre-LN layers on (B, T, hidden) tokens."""
    eps = model["eps"]
    for i in range(model["layers"]):
        pre = f"encoder.layer_{i}."
        x = x + _attention(_layer_norm(x, params, pre + "ln1", eps), params, pre + "attn.",
                           model["heads"], precision)
        z = _layer_norm(x, params, pre + "ln2", eps)
        z = F.gelu(_linear(z, params, pre + "fc1", precision), approximate="none")
        x = x + _linear(z, params, pre + "fc2", precision)
    return x


def _patches(img, params, stride, precision):
    z = F.conv2d(_operand(img, precision), _operand(params["patch_proj.weight"], precision),
                 params["patch_proj.bias"], stride=stride)
    return z.flatten(2).transpose(1, 2)  # (B, rows*cols, hidden), row-major over (rows, cols)


def hidden(x, params, model, precision="float32"):
    """The last layer's (B, T, hidden) output of one batch, before the final
    LayerNorm."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    b = x.shape[0]
    if model["family"] == "ast":
        img = x.float().transpose(1, 2).unsqueeze(1)  # (B, 1, mels, frames)
        tok = _patches(img, params, (model["frequency_stride"], model["time_stride"]), precision)
        lead = [params["cls_token"].expand(b, -1, -1), params["dist_token"].expand(b, -1, -1)]
    else:
        if tuple(x.shape[1:3]) != (model["image_size"],) * 2:
            raise ValueError(f"frames of {tuple(x.shape[1:3])}, the model takes {model['image_size']}")
        img = ((x.float() / 255.0 - 0.5) / 0.5).permute(0, 3, 1, 2)  # NHWC -> NCHW
        tok = _patches(img, params, (model["patch_size"],) * 2, precision)
        lead = [params["cls_token"].expand(b, -1, -1)]
    return encoder(torch.cat([*lead, tok], dim=1) + params["pos_embed"], params, model, precision)


def pool(h, params, model):
    """The pooled (B, hidden) features of the last layer's output: the final
    LayerNorm, then [CLS] (ViT) or the mean of [CLS] and [distill] (AST)."""
    h = _layer_norm(h, params, "final_ln", model["eps"])
    if model["family"] == "ast":
        return (h[:, 0] + h[:, 1]) / 2.0
    return h[:, 0]


def head(pooled, params, model, precision="float32"):
    """(B, num_labels) logits of pooled features."""
    if model["family"] == "ast":
        pooled = _layer_norm(pooled, params, "classifier_ln", model["eps"])
    return _linear(pooled, params, "classifier", precision)


def features(x, params, model, precision="float32"):
    """The pooled (B, hidden) backbone output of one batch."""
    return pool(hidden(x, params, model, precision), params, model)


def logits(x, params, model, precision="float32"):
    """(B, num_labels) logits of one batch."""
    return head(features(x, params, model, precision), params, model, precision)
