"""Weights across: the JAX package's Flax AST parameters -> the port's state_dict.

The port keeps the Flax names, so the mapping is mechanical:

- a Dense kernel (in, out) becomes a Linear weight (out, in);
- the fused qkv kernel (in, 3, hidden) becomes weight (3*hidden, in), rows
  ordered q, k, v, and its bias (3, hidden) becomes (3*hidden,);
- the patch conv kernel goes from HWIO to OIHW;
- LayerNorm ``scale``/``bias`` become ``weight``/``bias``.
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


def ast_params_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax AST params (nested mapping of arrays, e.g. ``variables['params']``
    as numpy) -> a state_dict that ``AST.load_state_dict`` takes strictly."""
    sd: Dict[str, torch.Tensor] = {}
    sd["patch_proj.weight"] = _t(np.asarray(params["patch_proj"]["kernel"]).transpose(3, 2, 0, 1))
    sd["patch_proj.bias"] = _t(params["patch_proj"]["bias"])
    for name in ("cls_token", "dist_token", "pos_embed"):
        sd[name] = _t(params[name])
    for layer_name, layer in params["encoder"].items():
        pre = f"encoder.{layer_name}"
        _norm(sd, f"{pre}.ln1", layer["ln1"])
        qkv = layer["attn"]["qkv"]
        kernel = np.asarray(qkv["kernel"])  # (in, 3, hidden)
        sd[f"{pre}.attn.qkv.weight"] = _t(kernel.reshape(kernel.shape[0], -1).T)
        sd[f"{pre}.attn.qkv.bias"] = _t(np.asarray(qkv["bias"]).reshape(-1))
        _dense(sd, f"{pre}.attn.out", layer["attn"]["out"])
        _norm(sd, f"{pre}.ln2", layer["ln2"])
        _dense(sd, f"{pre}.fc1", layer["fc1"])
        _dense(sd, f"{pre}.fc2", layer["fc2"])
    _norm(sd, "final_ln", params["final_ln"])
    _norm(sd, "classifier_ln", params["classifier_ln"])
    _dense(sd, "classifier", params["classifier"])
    return sd
