"""Dropout whose masks come from an explicit ``torch.Generator``, the one
dropout of every model of the port.

``nn.Dropout`` draws from the global RNG. The trainer instead gives every
:class:`Dropout` of its model one generator on its device, seeded per fit
(:func:`set_generator`), so that a fit is deterministic under its seed. The
mask is Flax's: keep each element with probability 1 - p and scale the kept
ones by 1 / (1 - p).

A stacked fit (``parallel/subject.py``) runs one model over S subjects under
``torch.func.vmap``, where one generator would draw one mask for all of them.
There each subject's masks are drawn outside the vmapped call, from that
subject's own generator, and handed in as the ``mask`` buffer (a bool tensor
of the input's shape) through ``functional_call``; a Dropout with a mask
uses it and draws nothing. :func:`record_dropouts` finds, for a batch, which
Dropouts a forward draws for and at what shapes, in the forward's order.

A data-parallel fit (``Trainer.fit(mesh=)``) gives each rank some rows of
every batch. There each Dropout's ``rows`` (:func:`set_rows`) names them:
the mask is drawn for the whole batch, as the one-process fit draws it, from
the generator every rank seeded alike, and the rank keeps its rows, so each
row gets the mask it gets in the one-process fit. The model ranks of a
tensor-parallel encoder draw the same masks (``parallel/tp.py``).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch
from torch import nn


class Dropout(nn.Module):
    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.generator: Optional[torch.Generator] = None  # None: the global RNG
        self.register_buffer("mask", None, persistent=False)  # set only by functional_call
        self.record: Optional[List[Tuple["Dropout", torch.Size]]] = None
        self.rows: Optional[Tuple[int, int, int]] = None  # (lo, hi, batch): set_rows

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if self.mask is not None:
            keep = self.mask
        elif self.record is not None:
            self.record.append((self, x.shape))
            return x
        else:
            keep = self.draw(x.shape, x.device)
        return x * keep / (1.0 - self.p)

    def draw(self, shape, device, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """A keep-mask for an input of ``shape``, from ``generator`` (default
        this Dropout's); with ``rows`` (lo, hi, n), rows lo:hi of the mask of
        the whole batch of n rows."""
        gen = generator or self.generator
        if self.rows is None:
            return torch.rand(shape, generator=gen, device=device) >= self.p
        lo, hi, n = self.rows
        if shape[0] != hi - lo:
            raise ValueError(f"a Dropout input of {shape[0]} rows, not the batch's {hi - lo}: "
                             "a split batch needs the batch on the first axis")
        return (torch.rand((n, *shape[1:]), generator=gen, device=device) >= self.p)[lo:hi]

    def needs_mask(self) -> bool:
        """Whether a call now would draw a mask of its own."""
        return self.training and self.p != 0.0 and self.mask is None and self.record is None

    def extra_repr(self) -> str:
        return f"p={self.p}"


def set_generator(model: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Every :class:`Dropout` in ``model`` draws its masks from ``generator``."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator


def set_rows(model: nn.Module, rows: Optional[Tuple[int, int, int]]) -> None:
    """Every :class:`Dropout` in ``model`` keeps rows ``lo:hi`` of the masks
    of a batch of ``n`` rows (``rows`` = (lo, hi, n); None: the whole input)."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rows = rows


def record_dropouts(model: nn.Module, forward: Callable[[], object]) -> List[Tuple[str, torch.Size]]:
    """Runs ``forward`` (a forward of ``model``) with the active Dropouts
    drawing nothing and passing their input through -> (module name, input
    shape) of each of their calls, in the forward's order. A Dropout called
    twice in one forward raises: one ``mask`` buffer serves one call."""
    names = {m: n for n, m in model.named_modules() if isinstance(m, Dropout)}
    calls: List[Tuple[Dropout, torch.Size]] = []
    for m in names:
        m.record = calls
    try:
        forward()
    finally:
        for m in names:
            m.record = None
    if len({m for m, _ in calls}) != len(calls):
        raise RuntimeError("a Dropout is called twice in one forward; one mask serves one call")
    return [(names[m], shape) for m, shape in calls]
