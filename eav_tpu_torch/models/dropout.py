"""Dropout whose masks come from an explicit ``torch.Generator``, the one
dropout of every model of the port.

``nn.Dropout`` draws from the global RNG. The trainer instead gives every
:class:`Dropout` of its model one generator on its device, seeded per fit
(:func:`set_generator`), so that a fit is deterministic under its seed. The
mask is Flax's: keep each element with probability 1 - p and scale the kept
ones by 1 / (1 - p).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn


class Dropout(nn.Module):
    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.generator: Optional[torch.Generator] = None  # None: the global RNG

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.generator, device=x.device) >= self.p
        return x * keep / (1.0 - self.p)

    def extra_repr(self) -> str:
        return f"p={self.p}"


def set_generator(model: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Every :class:`Dropout` in ``model`` draws its masks from ``generator``."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator


def replay_generators(fn: Callable, module: nn.Module) -> Callable:
    """``fn`` for ``torch.utils.checkpoint``: the checkpoint restores the
    global RNG before it recomputes ``fn`` in the backward, but not an
    explicit generator. The first call records the state of the generators
    of ``module``'s dropouts; a later call (the recompute) draws from that
    state, the same masks, and leaves the generators as it found them."""
    gens = list({id(m.generator): m.generator for m in module.modules()
                 if isinstance(m, Dropout) and m.generator is not None}.values())
    if not gens:
        return fn
    states = []

    def run(*args):
        if not states:
            states.extend(g.get_state() for g in gens)
            return fn(*args)
        after = [g.get_state() for g in gens]
        for g, s in zip(gens, states):
            g.set_state(s)
        try:
            return fn(*args)
        finally:
            for g, s in zip(gens, after):
                g.set_state(s)

    return run
