"""What the families ``ast`` and ``vit`` share (``families/ast.py``,
``families/vit.py``): patch-embedded pre-LN encoders, whose plain reference
is ``reference/transformer.py`` and whose FLOPs and attention work are
``yardstick.py``'s. Each function takes the architecture those two modules
know (``arch``, 'ast' or 'vit') apart from the configuration's ``model``
block, so that a family file of another name can stand on them; a family
file binds it (``functools.partial``).
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Dict, List, Tuple

from benchmark import yardstick
from benchmark.common import batches
from benchmark.reference import transformer

# the flash kernels by the names their launches carry in a device trace and
# in the port's launch counters
FLASH = {"fwd": "flash_fwd", "dkv": "flash_dkv", "dq": "flash_dq"}


def _as(arch: str, model: dict) -> dict:
    return {**model, "family": arch}


def param_shapes(arch: str, model: dict) -> Dict[str, tuple]:
    """name -> (shape, kind, fan_in) in ``transformer.param_shapes``'s order;
    a kernel's fan-in is the product of its shape past the first axis, the
    other kinds have none."""
    return {n: (s, kind, math.prod(s[1:]) if kind == "kernel" else None)
            for n, (s, kind) in transformer.param_shapes(_as(arch, model)).items()}


def forward_flops(arch: str, model: dict) -> float:
    return yardstick.forward_flops(_as(arch, model))


def train_flops(arch: str, model: dict) -> float:
    return yardstick.train_flops(_as(arch, model))


def kernel_work(arch: str, model: dict, sizes: List[int],
                train: bool) -> List[Tuple[str, int, int, int]]:
    """[(kernel, FLOP, bytes, calls)]: the flash kernels' least work in one
    pass of every layer over batches of ``sizes``, one call a layer and
    batch: K1 (``flash_fwd``), and with ``train`` the backward's K2 and K3,
    at (B·H, T, D) from the model's shapes (``yardstick.attention_work``)."""
    d = yardstick.model_dims(_as(arch, model))
    kernels = ("fwd", "dkv", "dq") if train else ("fwd",)
    return [(FLASH[k], *yardstick.attention_work(k, b * d["heads"], d["tokens"], d["head_dim"]),
             n * d["layers"])
            for b, n in sorted(Counter(sizes).items()) for k in kernels]


def reference_blocks(arch: str, model: dict, n: int) -> List[Tuple[int, int]]:
    """The reference's forward over ``n`` rows in blocks whose float32
    (rows, heads, T, T) scores, three live at a time, fit in 4 GB."""
    d = yardstick.model_dims(_as(arch, model))
    return batches(n, max(1, int(4e9 // (3 * 4 * d["heads"] * d["tokens"] ** 2))))


def hidden(arch: str, x, params, model: dict, precision: str = "float32"):
    return transformer.hidden(x, params, _as(arch, model), precision)


def pool(arch: str, h, params, model: dict):
    return transformer.pool(h, params, _as(arch, model))


def head(arch: str, pooled, params, model: dict, precision: str = "float32"):
    return transformer.head(pooled, params, _as(arch, model), precision)


def features(arch: str, x, params, model: dict, precision: str = "float32"):
    return transformer.features(x, params, _as(arch, model), precision)


def logits(arch: str, x, params, model: dict, precision: str = "float32"):
    return transformer.logits(x, params, _as(arch, model), precision)


def hidden_module(model):
    """The port's module whose output is the last layer's, before the final
    LayerNorm."""
    return model.encoder
