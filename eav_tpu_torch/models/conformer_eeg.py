"""EEG conformer (ShallowConvNet x Transformer hybrid), as
``eav_tpu/models/conformer_eeg.py`` has it (reference
`Transformer_torch/Transformer_EEG.py:14-148`, its per-filter loops as one
einsum):

- temporal conv Conv2d(1, 40, (1, 13)) valid, no bias             (`:118`)
- per-filter spatial projection: an einsum over a (40, 30) weight
  -> (B, T=488, 40) tokens                                         (`:24-35`)
- 12 post-norm transformer layers, embed 40, one head, the attention
  output keeps a V-residual (out + V, `:70-73`)
- BatchNorm -> square -> AvgPool((1, 35), stride (1, 7)) -> log-clamp
  power pooling (`:140-142`) -> fc 2600 -> 5, no bias (`:128`)
- the post-step fc renorm to 0.5 (`:196-199`) as ``maxnorm_rules``.

Attention is plain math: D 40 is no head size of the flash kernels, and the
JAX package computes it with einsums too. Layout NCHW; names follow the Flax
tree. The flatten before ``head`` is f-major (NCHW) where Flax's is t-major:
``models/bridge.py`` permutes the head's columns.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from eav_tpu_torch.models.dropout import Dropout
from eav_tpu_torch.models.norm import BatchNorm2d
from eav_tpu_torch.models.transformer import lecun_normal


class VResidualAttention(nn.Module):
    """Single-head attention with the reference's V-residual (`:50-73`); the
    scores are scaled by 1/sqrt(embed width)."""

    def __init__(self, embed: int = 40, qkv_dim: int = 40):
        super().__init__()
        self.wq = nn.Linear(embed, qkv_dim, bias=False)
        self.wk = nn.Linear(embed, qkv_dim, bias=False)
        self.wv = nn.Linear(embed, qkv_dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self.wq(x), self.wk(x), self.wv(x)
        probs = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(x.shape[-1]), dim=-1)
        return probs @ v + v


class PostNormLayer(nn.Module):
    """x = x + drop(norm1(attn(x))); x = x + drop(norm2(ffn(x))) (`:101-104`);
    LayerNorm eps 1e-5, torch's default (`Transformer_EEG.py:97-98`)."""

    def __init__(self, embed: int = 40, expansion: int = 4, drop: float = 0.5):
        super().__init__()
        self.attn = VResidualAttention(embed, embed)
        self.norm1 = nn.LayerNorm(embed, eps=1e-5)
        self.fc1 = nn.Linear(embed, embed * expansion)
        self.fc2 = nn.Linear(embed * expansion, embed)
        self.norm2 = nn.LayerNorm(embed, eps=1e-5)
        self.drop_attn, self.drop_ffn, self.drop_out = Dropout(drop), Dropout(drop), Dropout(drop)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.drop_attn(self.norm1(self.attn(x)))
        f = self.fc2(self.drop_ffn(F.relu(self.fc1(x))))
        return x + self.drop_out(self.norm2(f))


class ConformerEEG(nn.Module):
    def __init__(
        self,
        nb_classes: int = 5,
        chans: int = 30,
        samples: int = 500,
        filters: int = 40,
        kern: int = 13,
        num_layers: int = 12,
        dropout: float = 0.5,
        fc_maxnorm: float = 0.5,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.dropout = dropout
        self.fc_maxnorm = fc_maxnorm
        pooled = ((samples - kern + 1) - 35) // 7 + 1  # T 488 -> 65
        with torch.device("meta"):  # allocate once, below, without touching the global RNG
            self.conv_temporal = nn.Conv2d(1, filters, (1, kern), bias=False)
            self.spatial_proj = nn.Parameter(torch.empty(filters, chans))
            self.layers = nn.ModuleList(
                PostNormLayer(filters, drop=dropout) for _ in range(num_layers))
            self.bn = BatchNorm2d(filters, eps=1e-5, momentum=0.1)
            self.drop = Dropout(dropout)
            self.head = nn.Linear(pooled * filters, nb_classes, bias=False)  # 65 * 40 = 2600
        self.to_empty(device="cpu")
        self.reset_parameters(generator)

    @property
    def maxnorm_rules(self) -> Tuple[Tuple[str, float, Tuple[int, ...]], ...]:
        """The fc renorm: each output unit's weights to L2 norm <= 0.5."""
        return ((r"^head\.weight$", self.fc_maxnorm, (1,)),)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Flax's initializers (LeCun-normal kernels, the spatial projection's
        fan-in its first axis as Flax counts a 2-D kernel, zero biases, unit
        norms, fresh BN stats), drawn on the CPU from ``generator``."""
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                m.weight.copy_(lecun_normal(m.weight.shape, m.weight[0].numel(), gen))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.LayerNorm, nn.BatchNorm2d)):
                m.reset_parameters()
        self.spatial_proj.copy_(
            lecun_normal(self.spatial_proj.shape, self.spatial_proj.shape[0], gen))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, chans, samples) -> (B, nb_classes) logits."""
        x = self.conv_temporal(x.unsqueeze(1))  # (B, filters, chans, T)
        tokens = torch.einsum("bect,ec->bte", x, self.spatial_proj)  # (B, T, filters)
        for layer in self.layers:
            tokens = layer(tokens)
        h = self.bn(tokens.transpose(1, 2).unsqueeze(2))  # (B, filters, 1, T)
        h = F.avg_pool2d(h.square(), (1, 35), stride=(1, 7))  # (B, filters, 1, 65)
        h = self.drop(torch.log(h.clamp(1e-7, 1e4)))
        return self.head(h.flatten(1))
