"""The flagship forward step, the counterpart of ``__graft_entry__.entry``:

    forward, args = entry()
    logits = forward(*args)  # (8, 5)

AST-base (hidden 768, 12 layers, 12 heads, 1214 tokens), the model of the
``ast_finetune`` preset (bf16 compute and residual stream, attention
``'auto'``: the flash kernels on the card), at the reference's batch of 8
on a (8, 1024, 128) fbank of zeros, its weights drawn from seed 0. ``args``
is the eval-mode module and the input, both on ``device``; ``forward`` runs
the module under ``torch.no_grad``, so one call on the card launches K1
once a layer. ``dryrun_multichip`` is ``parallel/dryrun.py``'s.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch import nn


def entry(device="cuda", batch: int = 8, **model_kw) -> Tuple[Callable, Tuple[nn.Module, torch.Tensor]]:
    """-> ``(forward, (model, x))``; ``model_kw`` overrides the preset's
    model kwargs (the tests' small widths)."""
    from eav_tpu_torch.core.config import get_preset
    from eav_tpu_torch.core.device import resolve_device
    from eav_tpu_torch.train.pipeline import build_model

    dev = resolve_device(device)
    model = build_model(get_preset("ast_finetune"), **model_kw).to(dev).eval()
    x = torch.zeros(batch, *model.input_shape, device=dev)

    @torch.no_grad()
    def forward(model: nn.Module, x: torch.Tensor) -> torch.Tensor:
        return model(x)

    return forward, (model, x)
