"""EEGNet, the EAV EEG baseline, as ``eav_tpu/models/eegnet.py`` has it.

Two variants of the reference:

- ``separable_mode='single'`` reproduces `CNN_torch/EEGNet_tor.py:15-67`
  (the variant of the published sweeps), whose "separable" conv is in fact
  one full (1, 16) convolution;
- ``separable_mode='true'`` reproduces `CNN_torch/CNN_EEG.py:7-67`
  (depthwise (1, 16) + pointwise (1, 1)).

EAV hyper-parameters: F1=8, D=8, F2=64, kernLength=300, Chans=30,
Samples=500 (`EEGNet_tor.py:159-160`). The layout is NCHW: (batch, features,
electrodes, time). Parameter names follow the Flax tree (``conv_temporal``,
``bn_temporal``, ``conv_depthwise``, ...); ``models/bridge.py`` maps Flax
weights across, including the head's columns (Flax flattens NHWC, w-major;
this model flattens NCHW, f-major). The max-norm constraints (the
reference's ``renorm_`` hooks, `EEGNet_tor.py:33-34,47-48`) are
``maxnorm_rules``, applied by the trainer after every optimizer step
(``core/optim.maxnorm_project``).

BatchNorm is torch's own (``models/norm.BatchNorm2d``, momentum 0.1 = Flax's 0.9,
eps 1e-5): the biased batch variance normalises, the unbiased one updates
``running_var``, which is the JAX package's ``TorchBatchNorm``. It runs in
float32 on the channel axis, the axis JAX normalises in NHWC.
``compute_dtype`` is the convolutions' dtype; BatchNorm and the head stay
float32.
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

SEPARABLE_MODES = ("single", "true")
TEMPORAL_MODES = ("conv", "fft")


def _same_pad(k: int) -> Tuple[int, int]:
    """Flax/XLA 'SAME' padding of a stride-1 kernel of width ``k``: the odd
    sample goes right (149 left, 150 right for k 300)."""
    return (k - 1) // 2, k // 2


def fft_correlate(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The (1, K) 'SAME' temporal correlation through the rFFT
    (``FFTTemporalConv``, `eegnet.py:31-65`): ``x`` (B, 1, C, T), ``weight``
    (F, 1, 1, K) -> (B, F, C, T) in float32. The transform length is the
    power of two at or above T + K, so the circular correlation does not
    wrap."""
    t, k = x.shape[-1], weight.shape[-1]
    n = 1 << math.ceil(math.log2(t + k))
    left = (k - 1) // 2
    z = F.pad(x[:, 0].float(), (left, n - t - left))
    spec = torch.fft.rfft(z, n)  # (B, C, n/2+1)
    w = torch.fft.rfft(weight[:, 0, 0].float(), n)  # (F, n/2+1)
    y = torch.fft.irfft(spec[:, None] * w.conj()[None, :, None, :], n)  # (B, F, C, n)
    return y[..., :t]


class EEGNet(nn.Module):
    def __init__(
        self,
        nb_classes: int = 5,
        chans: int = 30,
        samples: int = 500,
        dropout_rate: float = 0.5,
        kern_length: int = 300,
        f1: int = 8,
        d: int = 8,
        f2: int = 64,
        norm_rate: float = 1.0,
        norm_rate_dense: Optional[float] = None,
        separable_mode: str = "single",
        first_activation: bool = True,
        compute_dtype: Optional[torch.dtype] = None,
        temporal_mode: str = "conv",
        generator: Optional[torch.Generator] = None,
    ):
        """``norm_rate_dense``: the Keras EEGNet's max_norm(0.25) on the
        dense layer (`CNN_EEG_tf.py:56-57`); None = ``norm_rate``.
        ``first_activation``: the torch variant's ELU after the first BN
        (`EEGNet_tor.py:51-53`); the Keras one has none."""
        super().__init__()
        if separable_mode not in SEPARABLE_MODES:
            raise ValueError(f"separable_mode {separable_mode!r} not in {SEPARABLE_MODES}")
        if temporal_mode not in TEMPORAL_MODES:
            raise ValueError(f"temporal_mode {temporal_mode!r} not in {TEMPORAL_MODES}")
        self.norm_rate = norm_rate
        self.norm_rate_dense = norm_rate if norm_rate_dense is None else norm_rate_dense
        self.separable_mode = separable_mode
        self.first_activation = first_activation
        self.compute_dtype = compute_dtype
        self.temporal_mode = temporal_mode
        self.dropout = dropout_rate
        fd = f1 * d
        bn = lambda n: BatchNorm2d(n, eps=1e-5, momentum=0.1)  # noqa: E731
        with torch.device("meta"):  # allocate once, below, without touching the global RNG
            self.conv_temporal = nn.Conv2d(1, f1, (1, kern_length), bias=False)
            self.bn_temporal = bn(f1)
            self.conv_depthwise = nn.Conv2d(f1, fd, (chans, 1), groups=f1, bias=False)
            self.bn_depthwise = bn(fd)
            self.drop1 = Dropout(dropout_rate)
            if separable_mode == "true":
                self.conv_sep_depthwise = nn.Conv2d(fd, fd, (1, 16), groups=fd, bias=False)
                self.conv_sep_pointwise = nn.Conv2d(fd, f2, 1, bias=False)
            else:
                self.conv_separable = nn.Conv2d(fd, f2, (1, 16), bias=False)
            self.bn_separable = bn(f2)
            self.drop2 = Dropout(dropout_rate)
            # 64 * (500 // 4 // 8) = 960 features (`EEGNet_tor.py:43`)
            self.head = nn.Linear(f2 * (samples // 4 // 8), nb_classes)
        self.to_empty(device="cpu")
        self.reset_parameters(generator)

    @property
    def maxnorm_rules(self) -> Tuple[Tuple[str, float, Tuple[int, ...]], ...]:
        """(name regex, max norm, dims of the norm): the norm per output unit,
        as torch's ``renorm(p=2, dim=0)``; a conv weight is (out, in, kh, kw),
        a Linear weight (out, in)."""
        return (
            (r"^conv_depthwise\.weight$", self.norm_rate, (1, 2, 3)),
            (r"^head\.weight$", self.norm_rate_dense, (1,)),
        )

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Flax's initializers: LeCun-normal kernels (fan-in = the kernel's
        size per output unit), zero biases, unit BN scales, fresh running
        stats. Drawn on the CPU from ``generator`` (seed 0 when None)."""
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                m.weight.copy_(lecun_normal(m.weight.shape, m.weight[0].numel(), gen))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()

    def _conv(self, x: torch.Tensor, conv: nn.Conv2d, pad_w: bool = True) -> torch.Tensor:
        """A Flax ``nn.Conv(dtype=compute_dtype)``: input and kernel in the
        compute dtype, 'SAME' along time when ``pad_w``, else 'VALID'."""
        dt = self.compute_dtype or torch.float32
        if pad_w:
            x = F.pad(x, _same_pad(conv.kernel_size[1]))
        return F.conv2d(x.to(dt), conv.weight.to(dt), groups=conv.groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, chans, samples) -> (B, nb_classes) float32 logits."""
        x = x.unsqueeze(1)  # (B, 1, chans, samples)
        if self.temporal_mode == "fft":
            x = fft_correlate(x, self.conv_temporal.weight).to(self.compute_dtype or torch.float32)
        else:
            x = self._conv(x, self.conv_temporal)
        x = self.bn_temporal(x.float())
        if self.first_activation:
            x = F.elu(x)
        x = self._conv(x, self.conv_depthwise, pad_w=False)
        x = F.elu(self.bn_depthwise(x.float()))
        x = self.drop1(F.avg_pool2d(x, (1, 4)))
        if self.separable_mode == "true":
            x = self._conv(self._conv(x, self.conv_sep_depthwise), self.conv_sep_pointwise)
        else:
            x = self._conv(x, self.conv_separable)
        x = F.elu(self.bn_separable(x.float()))
        x = self.drop2(F.avg_pool2d(x, (1, 8)))
        return self.head(x.flatten(1).float())


def eegnet_keras(**kw) -> EEGNet:
    """The canonical Keras EEGNet as shipped in `CNN_tensorflow/CNN_EEG_tf.py`:
    true separable conv, no ELU after the first BN, dense max_norm 0.25."""
    defaults = dict(separable_mode="true", first_activation=False, norm_rate_dense=0.25)
    defaults.update(kw)
    return EEGNet(**defaults)
