"""BatchNorm whose batch may be split over ranks (``models/eegnet.py``,
``models/conformer_eeg.py`` and ``models/resnet_attn.py`` build theirs from
it; the JAX package's ``models/norm.py`` is torch's BatchNorm in Flax).

:class:`BatchNorm2d` is torch's ``nn.BatchNorm2d`` (the same parameters,
buffers and state-dict keys) until a data-parallel fit
(``Trainer.fit(mesh=)``) names the process group that holds the rest of the
batch in its ``group``. Then, in train mode, the statistics are the global
batch's, as in the one-process fit: the per-channel sums and element counts
are all-reduced, then the sums of squared deviations from the global mean,
each by ``_SumOverRanks``, whose backward all-reduces the gradient too
(every rank's loss depends on every rank's rows through the statistics;
``torch.distributed.nn.functional.all_reduce``, which torch now deprecates,
computes the same). The running stats take the unbiased variance over
the global count, the same on every rank. On a group of one rank the
global statistics are the local ones, and torch's own kernel runs.
``nn.SyncBatchNorm`` computes the same but refuses CPU tensors.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch import nn


class _SumOverRanks(torch.autograd.Function):
    """The sum of ``x`` over the ranks of ``group``, forward and backward."""

    @staticmethod
    def forward(x, group):
        total = x.clone()
        dist.all_reduce(total, group=group)
        return total

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, grad):
        total = grad.clone()
        dist.all_reduce(total, group=ctx.group)
        return total, None


class BatchNorm2d(nn.BatchNorm2d):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.group: Optional[dist.ProcessGroup] = None  # set by a data-parallel fit

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.group is None or not self.training or dist.get_world_size(self.group) == 1:
            return super().forward(x)
        return self._global_forward(x)

    def _global_forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[1]
        dims = [0, *range(2, x.dim())]
        shape = (1, c) + (1,) * (x.dim() - 2)
        head = _SumOverRanks.apply(torch.cat([x.sum(dims), x.new_full((1,), x.numel() // c)]),
                                   self.group)
        count = head[-1].detach()
        mean = head[:-1] / count
        dev = x - mean.view(shape)
        var = _SumOverRanks.apply(dev.square().sum(dims), self.group) / count  # biased
        y = dev * torch.rsqrt(var + self.eps).view(shape)
        if self.affine:
            y = y * self.weight.view(shape) + self.bias.view(shape)
        if self.track_running_stats:
            with torch.no_grad():
                self.num_batches_tracked.add_(1)
                f = (self.momentum if self.momentum is not None
                     else 1.0 / float(self.num_batches_tracked))
                self.running_mean.mul_(1 - f).add_(mean, alpha=f)
                self.running_var.mul_(1 - f).add_(var * count / (count - 1), alpha=f)
        return y


def set_group(model: nn.Module, group: Optional[dist.ProcessGroup]) -> None:
    """Every BatchNorm of ``model`` takes its train-mode statistics over
    ``group`` (None: over its own input). A torch BatchNorm that is not
    :class:`BatchNorm2d` raises: it would normalise by local statistics."""
    for name, m in model.named_modules():
        if isinstance(m, BatchNorm2d):
            m.group = group
        elif group is not None and isinstance(m, nn.modules.batchnorm._BatchNorm):
            raise TypeError(f"{name} is a {type(m).__name__}: a data-parallel fit needs "
                            "eav_tpu_torch.models.norm.BatchNorm2d")
