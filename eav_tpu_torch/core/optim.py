"""Freeze masks, the Adam(W) of the fine-tune protocol and max-norm projection.

The reference keeps ONE torch AdamW across the freeze -> unfreeze phases
(`Transformer_Audio.py:30,45-48`). Frozen parameters have
``requires_grad=False``, so their ``.grad`` stays None and AdamW skips them:
no moment update, no weight decay, and no advance of their step count, so
bias correction starts afresh when they unfreeze. ``torch.optim.AdamW`` with
``requires_grad`` toggled per phase is exactly the per-leaf-count update of
``eav_tpu/core/optim.py`` (``adam_update``). Weight decay is the reference's
effective torch default, 0.01 in the AST preset, on every trainable parameter;
``optimizer='adam'`` (the EEG presets) decays nothing.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Sequence, Tuple, Union

import torch
from torch import nn

from eav_tpu_torch.core.config import FinetuneConfig

# The head of the frozen phase (`Transformer_Audio.py:53-56`) on dotted
# parameter names: the same set as the JAX package's
# r"(^|/)(head|classifier(_ln)?)(/|$)" on '/'-joined paths. The models'
# ``head_mode_regex`` and the trainer's default share this one constant, so
# the frozen-feature cache gate compares like with like.
HEAD_REGEX = r"(^|\.)(head|classifier(_ln)?)(\.|$)"


def trainable_mask(model: nn.Module, freeze: bool, head_regex: str = HEAD_REGEX) -> Dict[str, bool]:
    """freeze=True -> only parameters whose name matches ``head_regex``
    train; freeze=False -> all train."""
    rx = re.compile(head_regex)
    return {
        name: (not freeze) or rx.search(name) is not None
        for name, _ in model.named_parameters()
    }


def set_trainable(model: nn.Module, freeze: bool, head_regex: str = HEAD_REGEX) -> None:
    """Set ``requires_grad`` from :func:`trainable_mask`."""
    mask = trainable_mask(model, freeze, head_regex)
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])


def make_optimizer(params: Union[nn.Module, Iterable[torch.Tensor]],
                   cfg: FinetuneConfig) -> torch.optim.AdamW:
    """One Adam(W) over every parameter (of a model, or the given leaves)
    for the whole fit; each phase sets its lr. 'adam' is AdamW without
    weight decay, as the JAX trainer passes weight_decay 0 for it
    (`eav_tpu/train/loop.py:341`). The update is element by element, so one
    optimizer over leaves stacked on a subject axis is one per subject."""
    if cfg.optimizer not in ("adamw", "adam"):
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    if isinstance(params, nn.Module):
        params = params.parameters()
    return torch.optim.AdamW(
        params, lr=cfg.phases[0].lr, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=cfg.weight_decay if cfg.optimizer == "adamw" else 0.0,
    )


@torch.no_grad()
def maxnorm_project(model: Union[nn.Module, Dict[str, torch.Tensor]],
                    rules: Sequence[Tuple[str, float, Tuple[int, ...]]],
                    batch_dims: int = 0) -> None:
    """Rescale in place each parameter whose name matches a rule's regex onto
    the L2 ball of radius ``maxnorm``, the norm taken over the rule's dims
    (per output unit): ``p *= min(1, maxnorm / max(norm, 1e-12))``, the JAX
    package's formula (`eav_tpu/core/optim.py:137-157`) for torch's
    ``renorm_`` hooks and post-step clamps. ``model`` may be a dict of named
    leaves with ``batch_dims`` leading axes (a subject stack), which shift
    the rules' dims."""
    compiled = [(re.compile(rx), mn, tuple(d + batch_dims for d in dims))
                for rx, mn, dims in rules]
    named = model.items() if isinstance(model, dict) else model.named_parameters()
    for name, p in named:
        for rx, mn, dims in compiled:
            if rx.search(name):
                norm = p.square().sum(dim=dims, keepdim=True).sqrt()
                p.mul_(torch.clamp(mn / norm.clamp_min(1e-12), max=1.0))
