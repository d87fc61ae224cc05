"""ResNet50 + channel attention, the CNN video baseline, as in
``eav_tpu/models/resnet_attn.py`` (`CNN_torch/CNN_Vision.py:26-63`):

- a torchvision-layout ResNet50 without its head under ``backbone``: stem
  (7x7 conv, BN, ReLU, 3x3 max-pool) and [3, 4, 6, 3] bottlenecks with the
  v1.5 stride placement (stride 2 in the 3x3 conv), written out here with
  torchvision's module names (``conv1``, ``bn1``, ``layer{1..4}.{b}.conv{1,2,3}``
  / ``bn{1,2,3}`` / ``downsample.{0,1}``), so that a torchvision state dict
  loads by name;
- the reference's channel attention: shared ``attn_fc1`` / ``attn_fc2`` over
  the average- and max-pooled features, summed, and multiplied into the
  feature map with no sigmoid (a reference quirk kept for parity, `:49-61`);
- global average pool, ``cls_fc1`` 2048 -> 1024, ReLU, ``cls_fc2``.

Input (B, H, W, 3) NHWC, as in the JAX package. BatchNorm is torch's own
(``models/norm.BatchNorm2d``, momentum 0.1, eps 1e-5: unbiased running variance, the JAX package's
``TorchBatchNorm``), in its parameters' dtype whatever ``compute_dtype``:
float32 as built; a model cast with ``.double()`` runs in float64 throughout
but for the logits, which are float32 as in the JAX package. The freeze
protocol freezes only the backbone (`CNN_Vision.py:123-124`), so the trainer
takes ``HEAD_REGEX``; the frozen backbone still runs in train mode and its
running statistics move (`CNN_Vision.py:128-133`).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from eav_tpu_torch.models.transformer import dense, lecun_normal
from eav_tpu_torch.models.norm import BatchNorm2d

STAGES = (3, 4, 6, 3)


def _bn(n: int) -> BatchNorm2d:
    return BatchNorm2d(n, eps=1e-5, momentum=0.1)


class Bottleneck(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn2 = _bn(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = _bn(planes * 4)
        self.downsample = None
        if stride != 1 or inplanes != planes * 4:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes * 4, 1, stride=stride, bias=False), _bn(planes * 4))

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
        y = F.relu(_norm(self.bn1, _conv(self.conv1, x, dtype), dtype))
        y = F.relu(_norm(self.bn2, _conv(self.conv2, y, dtype), dtype))
        y = _norm(self.bn3, _conv(self.conv3, y, dtype), dtype)
        if self.downsample is not None:
            x = _norm(self.downsample[1], _conv(self.downsample[0], x, dtype), dtype)
        return F.relu(y + x)


def _conv(conv: nn.Conv2d, x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """A Flax ``nn.Conv(dtype=dtype)``: input and kernel in ``dtype`` (the
    kernel's own when None)."""
    dt = dtype or conv.weight.dtype
    return F.conv2d(x.to(dt), conv.weight.to(dt), stride=conv.stride, padding=conv.padding)


def _norm(bn: nn.BatchNorm2d, x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """BatchNorm in its parameters' dtype (float32 as built), the result in
    ``dtype`` (the parameters' when None)."""
    return bn(x.to(bn.weight.dtype)).to(dtype or bn.weight.dtype)


class ResNet50Backbone(nn.Module):
    """torchvision's resnet50 without avgpool and fc: NCHW in, (B, 2048,
    H/32, W/32) out."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = _bn(64)
        inplanes = 64
        for stage, blocks in enumerate(STAGES):
            planes = 64 * 2**stage
            layers = []
            for b in range(blocks):
                layers.append(Bottleneck(inplanes, planes, 2 if (stage > 0 and b == 0) else 1))
                inplanes = planes * 4
            setattr(self, f"layer{stage + 1}", nn.ModuleList(layers))

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        x = F.relu(_norm(self.bn1, _conv(self.conv1, x, dtype), dtype))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for stage in range(len(STAGES)):
            for block in getattr(self, f"layer{stage + 1}"):
                x = block(x, dtype)
        return x


class ResNetAttn(nn.Module):
    # freeze = the backbone only (`CNN_Vision.py:123`), on dotted names
    HEAD_REGEX = r"^(?!backbone\.)"

    def __init__(
        self,
        num_labels: int = 5,
        compute_dtype: Optional[torch.dtype] = None,
        image_size: int = 224,
        generator: Optional[torch.Generator] = None,
    ):
        """``compute_dtype``: the convolutions' and denses' dtype (None:
        the parameters' dtype, float32 as built: the preset). ``image_size``: the side the
        pipeline resizes frames to; the network itself takes any size."""
        super().__init__()
        self.compute_dtype = compute_dtype
        self.image_size = image_size
        with torch.device("meta"):  # allocate once, below, without touching the global RNG
            self.backbone = ResNet50Backbone()
            self.attn_fc1 = nn.Linear(2048, 2048)
            self.attn_fc2 = nn.Linear(2048, 2048)
            self.cls_fc1 = nn.Linear(2048, 1024)
            self.cls_fc2 = nn.Linear(1024, num_labels)
        self.to_empty(device="cpu")
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Flax's initializers: LeCun-normal kernels, zero biases, unit BN
        scales and fresh running stats; drawn on the CPU from ``generator``
        (seed 0 when None)."""
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                m.weight.copy_(lecun_normal(m.weight.shape, m.weight[0].numel(), gen))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()

    def attention(self, feats: torch.Tensor) -> torch.Tensor:
        """(B, 2048, h, w) -> the (B, 2048) channel weights: the shared MLP
        of the average- and of the max-pooled features, summed."""
        dt = self.compute_dtype

        def mlp(v):
            return dense(dense(v, self.attn_fc1, dt), self.attn_fc2, dt)

        return mlp(feats.mean(dim=(2, 3))) + mlp(feats.amax(dim=(2, 3)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> (B, num_labels) float32 logits."""
        dt = self.compute_dtype
        feats = self.backbone(x.permute(0, 3, 1, 2), dt)
        feats = feats * self.attention(feats)[:, :, None, None]
        h = F.relu(dense(feats.mean(dim=(2, 3)), self.cls_fc1, dt))
        return dense(h, self.cls_fc2, dt).float()


def convert_torchvision_resnet50(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A torchvision ``resnet50`` state dict -> the ``backbone.*`` entries of
    ``ResNetAttn``'s state dict, BatchNorm running stats included; the
    torchvision head (``fc.*``) is dropped, as the reference drops it. A
    missing or unknown backbone key raises ``KeyError``."""
    with torch.device("meta"):
        want = set(ResNet50Backbone().state_dict())
    got = {k for k in sd if not k.startswith("fc.")}
    if got != want:
        raise KeyError(f"not a torchvision resnet50 state dict: missing "
                       f"{sorted(want - got)[:5]}, unknown {sorted(got - want)[:5]}")
    return {f"backbone.{k}": torch.as_tensor(sd[k]).detach().to("cpu", copy=True)
            .to(torch.int64 if k.endswith("num_batches_tracked") else torch.float32)
            for k in sorted(got)}
