"""ViT image classifier, the vision model, as in ``eav_tpu/models/vit.py``
(HF ``ViTForImageClassification`` architecture):

- input (B, H, W, 3) NHWC -> 16x16 patches at stride 16 (row-major) ->
  196 tokens at 224x224, + [CLS] + learned position embeddings;
- pre-LN encoder (``models/transformer.py``); ``final_ln`` in float32;
- classifier = Linear on the CLS token.

``preprocess_uint8`` folds the ViTImageProcessor recipe into the model, so the
data stays uint8 up to the device: resize to ``image_size`` (the JAX package's
antialiased bilinear weights, ``ops/image.py``), then (x / 255 - 0.5) / 0.5.
The CLS token and position embeddings are float32; the stream is cast to
``stream_dtype`` after the position add. Attention is plain ('math') by
default, as the JAX preset keeps XLA attention at 197 tokens.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from eav_tpu_torch.core.optim import HEAD_REGEX
from eav_tpu_torch.models.ast import MODES
from eav_tpu_torch.models.dropout import Dropout
from eav_tpu_torch.models.transformer import (
    PatchProj,
    TransformerEncoder,
    dense,
    layer_norm,
    lecun_normal,
)
from eav_tpu_torch.ops.image import pixel_values


class ViT(nn.Module):
    # The frozen phase trains only the classifier (HF keeps final_ln in the
    # backbone), so the trainer may cache the CLS features (train/loop.py).
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
        image_size: int = 224,
        eps: float = 1e-12,
        dropout: float = 0.0,
        attn_impl: str = "math",
        compute_dtype: Optional[torch.dtype] = None,
        remat: str = "none",
        stream_dtype: Optional[torch.dtype] = None,
        preprocess_uint8: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.hidden = hidden
        self.image_size = image_size
        self.dropout = dropout
        self.stream_dtype = stream_dtype
        self.preprocess_uint8 = preprocess_uint8
        self.num_patches = (image_size // patch_size) ** 2
        with torch.device("meta"):  # allocate once, below, without touching the global RNG
            self.patch_proj = PatchProj(3, hidden, patch_size, (patch_size, patch_size))
            self.cls_token = nn.Parameter(torch.empty(1, 1, hidden))
            self.pos_embed = nn.Parameter(torch.empty(1, self.num_patches + 1, hidden))
            self.pos_drop = Dropout(dropout)
            self.encoder = TransformerEncoder(
                hidden, layers, heads, mlp_dim, eps, dropout, attn_impl, compute_dtype, remat
            )
            self.final_ln = nn.LayerNorm(hidden, eps=eps)
            self.classifier = nn.Linear(hidden, num_labels)
        self.to_empty(device="cpu")
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Flax's initializers (as ``AST.reset_parameters``): LeCun-normal
        kernels, zero biases, unit LayerNorm scales, a zero CLS token, N(0,
        0.02) position embeddings, drawn on the CPU from ``generator``."""
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        for m in self.modules():
            if isinstance(m, (nn.Linear, PatchProj)):
                m.weight.copy_(lecun_normal(m.weight.shape, m.weight[0].numel(), gen))
                m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        self.cls_token.zero_()
        self.pos_embed.copy_(0.02 * torch.randn(self.pos_embed.shape, generator=gen))

    def forward(self, x: torch.Tensor, mode: str = "full") -> torch.Tensor:
        """'full': (B, H, W, 3) frames -> logits; 'features': the post-final_ln
        CLS vector (B, hidden); 'head': ``x`` is that vector -> logits.
        full(x) == head(features(x))."""
        if mode not in MODES:
            raise ValueError(f"mode {mode!r} not in {MODES}")
        if mode == "head":
            return dense(x, self.classifier, torch.float32)
        b = x.shape[0]
        if self.preprocess_uint8:
            x = pixel_values(x, self.image_size)
        x = self.patch_proj(x.permute(0, 3, 1, 2))  # NHWC -> NCHW
        x = x.flatten(2).transpose(1, 2)  # (B, rows*cols, hidden), row-major patches
        x = torch.cat([self.cls_token.expand(b, -1, -1), x], dim=1)
        x = self.pos_drop(x + self.pos_embed)
        if self.stream_dtype is not None:
            x = x.to(self.stream_dtype)
        x = self.encoder(x)
        x = layer_norm(x[:, 0], self.final_ln, torch.float32)  # row-wise: the CLS row only
        if mode == "features":
            return x
        return dense(x, self.classifier, torch.float32)


def vit_tiny(num_labels: int = 5, **kw) -> ViT:
    """Small config for tests: the JAX package's ``vit_tiny`` widths."""
    defaults = dict(
        num_labels=num_labels, hidden=32, layers=2, heads=2, mlp_dim=64,
        patch_size=16, image_size=64,
    )
    defaults.update(kw)
    return ViT(**defaults)
