"""Late fusion over the per-subject models' class scores, as
``eav_tpu/models/fusion.py``'s ``FusionHead`` (BASELINE.json config 5).

Each modality's fine-tuned model archives its per-trial logits; every
modality yields the same number of samples in the same class-stratified,
temporal order, so after the EAV split the k-th row of each archive is the
same interaction. The head maps (B, modalities, classes) raw logits to
(B, classes):

- ``mode='weighted'``: per-modality learned temperature and scalar weight on
  the log-softmax scores, summed, plus a class bias (about 20 parameters);
- ``mode='mlp'``: an MLP over the concatenated log-softmax scores, with
  dropout 0.3 in train mode.

Parameter names follow the Flax tree (``log_temp``, ``weight``, ``bias``;
``fc1``, ``head``); ``models/bridge.fusion_params_from_jax`` maps Flax
weights across.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from eav_tpu_torch.models.dropout import Dropout
from eav_tpu_torch.models.transformer import lecun_normal

MODES = ("weighted", "mlp")


class FusionHead(nn.Module):
    def __init__(self, num_classes: int = 5, num_modalities: int = 3, mode: str = "weighted",
                 hidden: int = 64, generator: Optional[torch.Generator] = None):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"mode {mode!r} not in {MODES}")
        self.num_modalities = num_modalities
        self.mode = mode
        self.dropout = 0.3 if mode == "mlp" else 0.0
        with torch.device("meta"):  # allocate once, below, without touching the global RNG
            if mode == "weighted":
                self.log_temp = nn.Parameter(torch.empty(num_modalities, 1))
                self.weight = nn.Parameter(torch.empty(num_modalities, 1))
                self.bias = nn.Parameter(torch.empty(num_classes))
            else:
                self.fc1 = nn.Linear(num_modalities * num_classes, hidden)
                self.drop = Dropout(self.dropout)
                self.head = nn.Linear(hidden, num_classes)
        self.to_empty(device="cpu")
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Flax's initializers: 'weighted' is deterministic (temperatures 1,
        weights 1, bias 0); 'mlp' draws LeCun-normal kernels on the CPU from
        ``generator`` (seed 0 when None), zero biases."""
        if self.mode == "weighted":
            self.log_temp.zero_()
            self.weight.fill_(1.0)
            self.bias.zero_()
            return
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        for m in (self.fc1, self.head):
            m.weight.copy_(lecun_normal(m.weight.shape, m.weight.shape[1], gen))
            m.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, num_modalities, num_classes) raw logits -> (B, num_classes)."""
        if self.mode == "weighted":
            scaled = F.log_softmax(x / torch.exp(self.log_temp), dim=-1)
            return (self.weight * scaled).sum(dim=1) + self.bias
        h = F.relu(self.fc1(F.log_softmax(x, dim=-1).flatten(1)))
        return self.head(self.drop(h))
