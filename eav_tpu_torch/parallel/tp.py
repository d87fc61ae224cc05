"""Tensor parallelism of the AST/ViT encoder stack over the mesh's ``model``
axis (the port of ``eav_tpu/parallel/tp.py``), Megatron's partition:

- attention's fused qkv projection: column-parallel, each of q, k and v cut
  by heads (the weight's 3·hidden rows are laid out (3, heads, head_dim),
  ``models/transformer.py``; a contiguous cut of the rows would give the
  first rank all of q);
- attention's output projection: row-parallel (its input columns, the
  heads), its bias added once after the sum;
- the MLP's fc1 column-parallel, fc2 row-parallel (bias after the sum);
- everything else (LayerNorms, embeddings, the head) replicated.

The JAX package places the parameters with these shardings and XLA inserts
the collectives. Here ``apply_tp`` gives each rank its shards
(``shard_params_tp``) and makes each encoder layer issue the collectives
itself (``models/transformer.py``'s ``_EnterTP`` / ``_ReduceTP``), so a rank
computes attention over its heads alone: the flash kernels launch at
B·H/N. Every rank draws the same dropout masks (its generator seeded
alike); under a 2-D mesh each data rank keeps its rows of them
(``models/dropout.set_rows``).
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from eav_tpu_torch.models.transformer import TransformerLayer
from eav_tpu_torch.parallel.mesh import MODEL_AXIS, axis_group, axis_index, axis_size

# name -> (dim, blocks): ``dim`` is cut into ``blocks`` equal blocks and each
# block into the model axis's contiguous parts (JAX's rules,
# `eav_tpu/parallel/tp.py:29-36`, on torch's (out, in) weights)
_RULES = (
    (r"attn\.qkv\.weight$", (0, 3)),  # rows (3, heads, d): each of q, k, v by heads
    (r"attn\.qkv\.bias$", (0, 3)),
    (r"attn\.out\.weight$", (1, 1)),  # row-parallel: input columns
    (r"fc1\.weight$", (0, 1)),  # column-parallel: output rows
    (r"fc1\.bias$", (0, 1)),
    (r"fc2\.weight$", (1, 1)),  # row-parallel
)


def tp_spec(name: str) -> Optional[Tuple[int, int]]:
    """(dim, blocks) of a parameter split over the model axis, or None for
    a replicated one."""
    for rx, spec in _RULES:
        if re.search(rx, name):
            return spec
    return None


def shard_tensor(t: torch.Tensor, spec: Tuple[int, int], index: int, size: int) -> torch.Tensor:
    """Part ``index`` of ``size`` of ``t`` under ``spec``."""
    dim, blocks = spec
    if t.shape[dim] % (blocks * size):
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split into {blocks} x {size}")
    v = t.unflatten(dim, (blocks, t.shape[dim] // blocks))
    part = v.shape[dim + 1] // size
    return v.narrow(dim + 1, index * part, part).flatten(dim, dim + 1).contiguous()


def shard_params_tp(state_dict: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """This rank's entries of ``state_dict`` under the TP rules: its shard
    of every split parameter, every other entry as it is."""
    size, index = axis_size(mesh, MODEL_AXIS), axis_index(mesh, MODEL_AXIS)
    return {name: (shard_tensor(t, spec, index, size) if (spec := tp_spec(name)) else t)
            for name, t in state_dict.items()}


def apply_tp(model: nn.Module, mesh) -> nn.Module:
    """Makes every ``TransformerLayer`` of ``model`` tensor-parallel over
    the mesh's ``model`` axis, in place: its split parameters become this
    rank's shards (of the weights the model holds now) and its forward
    issues the collectives. Every rank must call it on equal weights.
    Returns ``model``."""
    size, group = axis_size(mesh, MODEL_AXIS), axis_group(mesh, MODEL_AXIS)
    shards = shard_params_tp(dict(model.named_parameters()), mesh)
    for name, layer in model.named_modules():
        if not isinstance(layer, TransformerLayer):
            continue
        if layer.attn.heads % size or layer.fc1.out_features % size:
            raise ValueError(f"{name}: {layer.attn.heads} heads and {layer.fc1.out_features} "
                             f"MLP units do not split over {size} ranks")
        layer.attn.heads //= size
        layer.attn.tp_group = group
    with torch.no_grad():
        for name, p in list(model.named_parameters()):
            if tp_spec(name) is not None:
                owner, attr = model.get_submodule(name.rsplit(".", 1)[0]), name.rsplit(".", 1)[1]
                setattr(owner, attr, nn.Parameter(shards[name], requires_grad=p.requires_grad))
    return model
