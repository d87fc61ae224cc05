"""Weights across: the JAX package's Flax AST, ViT, EEGNet, EEG conformer,
fusion-head, SCNN and ResNetAttn parameters -> the port's state_dicts.

The port keeps the Flax names, so the mapping is mechanical:

- a Dense kernel (in, out) becomes a Linear weight (out, in);
- the fused qkv kernel (in, 3, hidden) becomes weight (3*hidden, in), rows
  ordered q, k, v, and its bias (3, hidden) becomes (3*hidden,);
- a conv kernel goes from HWIO to OIHW, a grouped one too (EEGNet's
  depthwise (C, 1, 1, 64) becomes (64, 1, C, 1)), a 1-D one from WIO to OIW;
- LayerNorm and BatchNorm ``scale``/``bias`` become ``weight``/``bias``, and
  BatchNorm's ``batch_stats`` ``mean``/``var`` its running stats;
- the EEG and SCNN heads read a flattened feature map: Flax flattens NHWC
  or NWC (position major), the port NCHW or NCW (feature major), so their
  input columns are permuted;
- ResNetAttn's Flax block ``layer{s}_{b}`` is torchvision's ``layer{s}.{b}``,
  its ``down_conv`` / ``down_bn`` are ``downsample.0`` / ``.1``;
- MTCNN's nets keep facenet_pytorch's names: a PReLU's ``alpha`` is its
  ``weight``, and the first dense layer of R-Net and O-Net reads facenet's
  (W, H, C) flatten where Flax reads (C, H, W).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _dense(sd: dict, prefix: str, tree: Mapping[str, Any]) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(tree["kernel"]).T)
    sd[f"{prefix}.bias"] = _t(tree["bias"])


def _norm(sd: dict, prefix: str, tree: Mapping[str, Any]) -> None:
    sd[f"{prefix}.weight"] = _t(tree["scale"])
    sd[f"{prefix}.bias"] = _t(tree["bias"])


def _conv(sd: dict, prefix: str, tree: Mapping[str, Any]) -> None:
    k = np.asarray(tree["kernel"])  # spatial dims, then in, out
    sd[f"{prefix}.weight"] = _t(k.transpose(k.ndim - 1, k.ndim - 2, *range(k.ndim - 2)))


def _batch_norm(sd: dict, prefix: str, params: Mapping[str, Any],
                stats: Mapping[str, Any]) -> None:
    _norm(sd, prefix, params)
    sd[f"{prefix}.running_mean"] = _t(stats["mean"])
    sd[f"{prefix}.running_var"] = _t(stats["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)


def _head_nchw(kernel, features: int) -> torch.Tensor:
    """A Dense kernel (positions*features, out) over an NHWC flatten -> the
    Linear weight (out, features*positions) over the NCHW flatten."""
    k = np.asarray(kernel)
    out = k.shape[1]
    k = k.reshape(-1, features, out).transpose(1, 0, 2).reshape(-1, out)
    return _t(k.T)


def transformer_layer_params_from_jax(layer: Mapping[str, Any], prefix: str = ""
                                      ) -> Dict[str, torch.Tensor]:
    """A Flax ``TransformerLayer`` tree -> the port's ``TransformerLayer``
    state_dict (names under ``prefix``): the fused (in, 3, hidden) qkv
    kernel as one (3·hidden, in) weight, rows ordered q, k, v."""
    sd: Dict[str, torch.Tensor] = {}
    _norm(sd, f"{prefix}ln1", layer["ln1"])
    qkv = layer["attn"]["qkv"]
    kernel = np.asarray(qkv["kernel"])  # (in, 3, hidden)
    sd[f"{prefix}attn.qkv.weight"] = _t(kernel.reshape(kernel.shape[0], -1).T)
    sd[f"{prefix}attn.qkv.bias"] = _t(np.asarray(qkv["bias"]).reshape(-1))
    _dense(sd, f"{prefix}attn.out", layer["attn"]["out"])
    _norm(sd, f"{prefix}ln2", layer["ln2"])
    _dense(sd, f"{prefix}fc1", layer["fc1"])
    _dense(sd, f"{prefix}fc2", layer["fc2"])
    return sd


def _backbone(params: Mapping[str, Any], tokens) -> Dict[str, torch.Tensor]:
    """The patch conv, the learned tokens named ``tokens``, the encoder and
    ``final_ln``: what AST and ViT share."""
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, "patch_proj", params["patch_proj"])
    sd["patch_proj.bias"] = _t(params["patch_proj"]["bias"])
    for name in tokens:
        sd[name] = _t(params[name])
    for layer_name, layer in params["encoder"].items():
        sd.update(transformer_layer_params_from_jax(layer, f"encoder.{layer_name}."))
    _norm(sd, "final_ln", params["final_ln"])
    return sd


def ast_params_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax AST params (nested mapping of arrays, e.g. ``variables['params']``
    as numpy) -> a state_dict that ``AST.load_state_dict`` takes strictly."""
    sd = _backbone(params, ("cls_token", "dist_token", "pos_embed"))
    _norm(sd, "classifier_ln", params["classifier_ln"])
    _dense(sd, "classifier", params["classifier"])
    return sd


def vit_params_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ViT params -> a state_dict that ``ViT.load_state_dict`` takes
    strictly (the patch kernel's input channels are RGB)."""
    sd = _backbone(params, ("cls_token", "pos_embed"))
    _dense(sd, "classifier", params["classifier"])
    return sd


def eegnet_params_from_jax(params: Mapping[str, Any],
                           batch_stats: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax EEGNet ``params`` and ``batch_stats`` -> a state_dict that
    ``EEGNet.load_state_dict`` takes strictly (either ``separable_mode``)."""
    sd: Dict[str, torch.Tensor] = {}
    for name in ("conv_temporal", "conv_depthwise", "conv_separable",
                 "conv_sep_depthwise", "conv_sep_pointwise"):
        if name in params:
            _conv(sd, name, params[name])
    for name in ("bn_temporal", "bn_depthwise", "bn_separable"):
        _batch_norm(sd, name, params[name], batch_stats[name])
    f2 = np.asarray(params["bn_separable"]["scale"]).shape[0]
    sd["head.weight"] = _head_nchw(params["head"]["kernel"], f2)
    sd["head.bias"] = _t(params["head"]["bias"])
    return sd


def conformer_params_from_jax(params: Mapping[str, Any],
                              batch_stats: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ConformerEEG ``params`` and ``batch_stats`` -> a state_dict that
    ``ConformerEEG.load_state_dict`` takes strictly."""
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, "conv_temporal", params["conv_temporal"])
    sd["spatial_proj"] = _t(params["spatial_proj"])
    layers = sorted((k for k in params if k.startswith("layer_")), key=lambda k: int(k[6:]))
    for i, name in enumerate(layers):
        layer, pre = params[name], f"layers.{i}"
        for w in ("wq", "wk", "wv"):
            sd[f"{pre}.attn.{w}.weight"] = _t(np.asarray(layer["attn"][w]["kernel"]).T)
        _norm(sd, f"{pre}.norm1", layer["norm1"])
        _dense(sd, f"{pre}.fc1", layer["fc1"])
        _dense(sd, f"{pre}.fc2", layer["fc2"])
        _norm(sd, f"{pre}.norm2", layer["norm2"])
    _batch_norm(sd, "bn", params["bn"], batch_stats["bn"])
    sd["head.weight"] = _head_nchw(params["head"]["kernel"], np.asarray(params["bn"]["scale"]).shape[0])
    return sd


def fusion_params_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax FusionHead params (either mode) -> a state_dict that
    ``FusionHead.load_state_dict`` takes strictly."""
    if "fc1" in params:
        sd: Dict[str, torch.Tensor] = {}
        _dense(sd, "fc1", params["fc1"])
        _dense(sd, "head", params["head"])
        return sd
    return {name: _t(params[name]) for name in ("log_temp", "weight", "bias")}


def scnn_params_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax SCNNAudio params -> a state_dict that ``SCNNAudio.load_state_dict``
    takes strictly (the head's rows go from w * 128 + c to c * 22 + w)."""
    sd: Dict[str, torch.Tensor] = {}
    for name in ("conv1", "conv2", "conv3", "conv4"):
        _conv(sd, name, params[name])
        sd[f"{name}.bias"] = _t(params[name]["bias"])
    sd["head.weight"] = _head_nchw(params["head"]["kernel"], 128)
    sd["head.bias"] = _t(params["head"]["bias"])
    return sd


def resnet_attn_params_from_jax(params: Mapping[str, Any],
                                batch_stats: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ResNetAttn ``params`` and ``batch_stats`` -> a state_dict that
    ``ResNetAttn.load_state_dict`` takes strictly."""
    sd: Dict[str, torch.Tensor] = {}
    bp, bs = params["backbone"], batch_stats["backbone"]
    _conv(sd, "backbone.conv1", bp["conv1"])
    _batch_norm(sd, "backbone.bn1", bp["bn1"], bs["bn1"])
    for name, block in bp.items():
        if not name.startswith("layer"):
            continue
        pre = "backbone." + name.replace("_", ".")
        for i in (1, 2, 3):
            _conv(sd, f"{pre}.conv{i}", block[f"conv{i}"])
            _batch_norm(sd, f"{pre}.bn{i}", block[f"bn{i}"], bs[name][f"bn{i}"])
        if "down_conv" in block:
            _conv(sd, f"{pre}.downsample.0", block["down_conv"])
            _batch_norm(sd, f"{pre}.downsample.1", block["down_bn"], bs[name]["down_bn"])
    for name in ("attn_fc1", "attn_fc2", "cls_fc1", "cls_fc2"):
        _dense(sd, name, params[name])
    return sd


# MTCNN: the net -> (its first dense layer, H, W, C of the conv output it reads)
_MTCNN_DENSE_SPATIAL = {"rnet": ("dense4", 3, 3, 64), "onet": ("dense5", 3, 3, 128)}


def mtcnn_params_from_jax(net: str, params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A Flax P-, R- or O-Net tree (``net`` is ``"pnet"``, ``"rnet"`` or
    ``"onet"``) -> a state_dict that the port's net, facenet_pytorch's too,
    takes strictly: conv kernels HWIO -> OIHW, dense kernels transposed, the
    first dense layer's columns from Flax's (C, H, W) order to facenet's
    (W, H, C), PReLU ``alpha`` -> ``weight``."""
    first_dense, h, w, c = _MTCNN_DENSE_SPATIAL.get(net, (None, 0, 0, 0))
    sd: Dict[str, torch.Tensor] = {}
    for name, leaf in params.items():
        if "alpha" in leaf:
            sd[f"{name}.weight"] = _t(leaf["alpha"])
            continue
        k = np.asarray(leaf["kernel"])
        if k.ndim == 4:
            _conv(sd, name, leaf)
        else:
            k = k.T  # (out, in)
            if name == first_dense:
                k = k.reshape(-1, c, h, w).transpose(0, 3, 2, 1).reshape(k.shape[0], -1)
            sd[f"{name}.weight"] = _t(k)
        sd[f"{name}.bias"] = _t(leaf["bias"])
    return sd
