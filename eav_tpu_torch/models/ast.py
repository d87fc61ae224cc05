"""AST (Audio Spectrogram Transformer), the audio model, as in
``eav_tpu/models/ast.py`` (HF ``ASTForAudioClassification`` architecture):

- input (B, 1024 frames, 128 mels) -> (B, 1, mels, frames) -> 16x16 patches
  at stride (10, 10) -> 12*101 = 1212 tokens in freq-major order;
- [CLS] + [distill] tokens + learned position embeddings (1214 tokens);
- pre-LN encoder; ``final_ln`` in float32; pooled = (h[CLS] + h[distill]) / 2;
- head = LayerNorm + Linear.

``compute_dtype`` is the encoder's matmul dtype; ``stream_dtype`` the residual
stream's (cast after the position embedding). The patch conv and everything
from ``final_ln`` on run in float32. Parameters are created on the CPU from a
``torch.Generator``; move the module with ``.to(device)``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from eav_tpu_torch.core.optim import HEAD_REGEX
from eav_tpu_torch.models.dropout import Dropout
from eav_tpu_torch.models.transformer import (
    PatchProj,
    TransformerEncoder,
    dense,
    layer_norm,
    lecun_normal,
)

MODES = ("full", "features", "head")


class AST(nn.Module):
    # The frozen phase trains only classifier_ln + classifier, so the trainer
    # may compute the pooled backbone features once and replay the frozen
    # epochs on them (train/loop.py). ``head_mode_regex`` is the trainable set
    # the 'head' mode covers; the trainer uses the cache only when its
    # head_regex is this same string.
    supports_head_mode = True
    head_mode_regex = HEAD_REGEX

    def __init__(
        self,
        num_labels: int = 5,
        hidden: int = 768,
        layers: int = 12,
        heads: int = 12,
        mlp_dim: int = 3072,
        patch_size: int = 16,
        frequency_stride: int = 10,
        time_stride: int = 10,
        num_mel_bins: int = 128,
        max_frames: int = 1024,
        eps: float = 1e-12,
        dropout: float = 0.0,
        attn_impl: str = "math",
        compute_dtype: Optional[torch.dtype] = None,
        remat: str = "none",
        stream_dtype: Optional[torch.dtype] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.hidden = hidden
        self.dropout = dropout
        self.stream_dtype = stream_dtype
        self.input_shape = (max_frames, num_mel_bins)  # one example: (frames, mels)
        rows = (num_mel_bins - patch_size) // frequency_stride + 1
        cols = (max_frames - patch_size) // time_stride + 1
        self.num_patches = rows * cols
        with torch.device("meta"):  # allocate once, below, without touching the global RNG
            self.patch_proj = PatchProj(1, hidden, patch_size, (frequency_stride, time_stride))
            self.cls_token = nn.Parameter(torch.empty(1, 1, hidden))
            self.dist_token = nn.Parameter(torch.empty(1, 1, hidden))
            self.pos_embed = nn.Parameter(torch.empty(1, self.num_patches + 2, hidden))
            self.pos_drop = Dropout(dropout)
            self.encoder = TransformerEncoder(
                hidden, layers, heads, mlp_dim, eps, dropout, attn_impl, compute_dtype, remat
            )
            self.final_ln = nn.LayerNorm(hidden, eps=eps)
            self.classifier_ln = nn.LayerNorm(hidden, eps=eps)
            self.classifier = nn.Linear(hidden, num_labels)
        self.to_empty(device="cpu")
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Flax's initializers: LeCun-normal kernels, zero biases, unit
        LayerNorm scales, zero CLS/distill tokens, N(0, 0.02) position
        embeddings. Values are drawn on the CPU from ``generator`` (seed 0
        when None) and copied to wherever the module lives."""
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        for m in self.modules():
            if isinstance(m, (nn.Linear, PatchProj)):
                m.weight.copy_(lecun_normal(m.weight.shape, m.weight[0].numel(), gen))
                m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        self.cls_token.zero_()
        self.dist_token.zero_()
        self.pos_embed.copy_(0.02 * torch.randn(self.pos_embed.shape, generator=gen))

    def forward(self, x: torch.Tensor, mode: str = "full") -> torch.Tensor:
        """'full': spectrogram -> logits; 'features': the pooled (B, hidden)
        backbone output; 'head': ``x`` is that pooled tensor -> logits.
        full(x) == head(features(x))."""
        if mode not in MODES:
            raise ValueError(f"mode {mode!r} not in {MODES}")
        if mode == "head":
            return self._head(x)
        b = x.shape[0]
        # (B, frames, mels) -> (B, 1, mels[freq], frames[time])
        x = self.patch_proj(x.transpose(1, 2).unsqueeze(1))
        x = x.flatten(2).transpose(1, 2)  # (B, rows*cols, hidden), freq-major
        x = torch.cat(
            [self.cls_token.expand(b, -1, -1), self.dist_token.expand(b, -1, -1), x], dim=1
        )
        x = self.pos_drop(x + self.pos_embed)
        if self.stream_dtype is not None:
            x = x.to(self.stream_dtype)
        x = self.encoder(x)
        x = layer_norm(x, self.final_ln, torch.float32)
        pooled = (x[:, 0] + x[:, 1]) / 2.0
        if mode == "features":
            return pooled
        return self._head(pooled)

    def _head(self, pooled: torch.Tensor) -> torch.Tensor:
        h = layer_norm(pooled, self.classifier_ln, torch.float32)
        return dense(h, self.classifier, torch.float32)


def ast_tiny(num_labels: int = 5, **kw) -> AST:
    """Small config for tests: the JAX package's ``ast_tiny`` widths."""
    defaults = dict(
        num_labels=num_labels, hidden=32, layers=2, heads=2, mlp_dim=64,
        patch_size=16, frequency_stride=10, time_stride=10,
        num_mel_bins=128, max_frames=128,
    )
    defaults.update(kw)
    return AST(**defaults)
