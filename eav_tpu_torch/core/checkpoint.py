"""Nested dicts of arrays or tensors saved as ``<path>.npz``, the port of
``eav_tpu/core/checkpoint.py``'s npz form: leaves flattened under ``a/b/c``
keys, so each package reads the other's files. A trainer's state dict nests
as one level (``params/encoder.layer_0.ln1.weight``).

Tensors are saved as numpy arrays and come back as numpy arrays. The JAX
package writes an Orbax directory instead when Orbax is installed; the port
has no Orbax and refuses such a directory.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch


def _leaf(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _flatten(tree, prefix: str = "") -> dict:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        out[prefix.rstrip("/")] = _leaf(tree)
    return out


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for k, v in flat.items():
        node = tree
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def save_pytree(path: str, tree: Any) -> None:
    """Write ``tree`` (nested dicts whose leaves are arrays, tensors or
    numbers) to ``path + '.npz'``, through a temporary file renamed over it,
    so a reader never sees a partial checkpoint."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    try:
        np.savez(tmp, **_flatten(tree))
        os.replace(tmp, path + ".npz")
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_pytree(path: str) -> dict:
    """The nested dict of numpy arrays saved at ``path`` by either package's
    npz form. An Orbax directory at ``path`` (and no npz) raises
    ``ValueError``; nothing there raises ``FileNotFoundError``."""
    if os.path.exists(path + ".npz"):
        with np.load(path + ".npz") as z:
            return _unflatten({k: z[k] for k in z.files})
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is an Orbax checkpoint directory (the JAX package writes one when "
            "Orbax is installed); the port reads only the npz form, path + '.npz'")
    raise FileNotFoundError(f"no checkpoint at {path}.npz")
