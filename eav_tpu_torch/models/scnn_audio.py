"""SCNN, the published audio CNN baseline on the 180-d handcrafted feature, as
in ``eav_tpu/models/scnn_audio.py`` (`CNN_torch/CNN_audio.py:10-37`, the
torch twin of the Keras notebook model behind the published 36.7% audio
accuracy):

- the (B, 180) feature as a length-180 sequence of one channel;
- Conv1d 1 -> 256 -> 128, kernel 5, 'same' padding, ReLU; dropout 0.1;
- MaxPool1d(8) in floor mode, 180 -> 22;
- Conv1d 128 -> 128 -> 128, ReLU; dropout 0.5;
- flatten 128 * 22 = 2816 -> Linear to the classes.

The port flattens NCW (channel major); the JAX package flattens NWC, so
``models/bridge.py`` permutes the head's input columns.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from eav_tpu_torch.models.dropout import Dropout
from eav_tpu_torch.models.transformer import lecun_normal


class SCNNAudio(nn.Module):
    def __init__(
        self,
        num_classes: int = 5,
        dropout_rates: Sequence[float] = (0.1, 0.5),
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.dropout = max(dropout_rates)
        with torch.device("meta"):  # allocate once, below, without touching the global RNG
            self.conv1 = nn.Conv1d(1, 256, 5, padding=2)
            self.conv2 = nn.Conv1d(256, 128, 5, padding=2)
            self.drop1 = Dropout(dropout_rates[0])
            self.conv3 = nn.Conv1d(128, 128, 5, padding=2)
            self.conv4 = nn.Conv1d(128, 128, 5, padding=2)
            self.drop2 = Dropout(dropout_rates[1])
            self.head = nn.Linear(128 * (180 // 8), num_classes)
        self.to_empty(device="cpu")
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Flax's initializers: LeCun-normal kernels (fan-in = in channels x
        width), zero biases; drawn on the CPU from ``generator`` (seed 0
        when None)."""
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        for m in self.modules():
            if isinstance(m, (nn.Conv1d, nn.Linear)):
                m.weight.copy_(lecun_normal(m.weight.shape, m.weight[0].numel(), gen))
                m.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 180) or (B, 1, 180) features -> (B, num_classes) logits."""
        if x.ndim == 2:
            x = x.unsqueeze(1)
        x = F.relu(self.conv1(x.float()))
        x = self.drop1(F.relu(self.conv2(x)))
        x = F.max_pool1d(x, 8)
        x = F.relu(self.conv3(x))
        x = self.drop2(F.relu(self.conv4(x)))
        return self.head(x.flatten(1))
