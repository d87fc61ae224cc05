"""Faults planted in the timed path, each of which the comparison has to
catch where a driver's ``FAULTS`` names it
(``benchmark/tests/test_bench_faults.py``, ``control.py``):

- ``unchanged``: each training step returns the model's state unchanged (the
  parameters are put back after the optimizer's step);
- ``half_batch``: half of each batch is left out; a training step takes the
  mean loss over the rest, a features pass repeats the rest's rows;
- ``answer``: one answer altered where it is produced: the first row of
  every output of the model a ``Trainer`` holds, whatever its class, logits
  (training) or features (a pass), comes out negated; the model's own
  ``forward`` is replaced, so a step captured into a CUDA graph replays
  the negation and the model's forward hooks see it;
- ``dk_negated`` (planted by ``control.py`` on the card only, where the
  flash kernels run): the attention backward's dK comes out negated, a
  gradient of the right size and the wrong direction.

The exchange between chips is not among them: every cell runs on one chip.
"""

from __future__ import annotations

import contextlib
import weakref
from typing import Iterator

import torch


@contextlib.contextmanager
def plant(name: str) -> Iterator[None]:
    """The fault ``name`` in the port's ``Trainer`` inside the block."""
    from eav_tpu_torch.ops.attention import FlashAttentionBackward
    from eav_tpu_torch.train.loop import Trainer

    step, apply, init = Trainer.train_step, Trainer._apply, Trainer.__init__
    backward = FlashAttentionBackward.forward
    answered = []  # weak references to the models whose forward was replaced

    def unchanged(self, opt, x, y, *args, **kw):
        before = [p.detach().clone() for p in self.model.parameters()]
        out = step(self, opt, x, y, *args, **kw)
        with torch.no_grad():
            for p, b in zip(self.model.parameters(), before):
                p.copy_(b)
        return out

    def half_step(self, opt, x, y, *args, **kw):
        h = max(1, len(y) // 2)
        return step(self, opt, x[:h], y[:h], *args, **kw)

    def half_apply(self, x, mode):
        if mode != "features":
            return apply(self, x, mode)
        h = max(1, -(-len(x) // 2))
        out = apply(self, x[:h], mode)
        return torch.cat([out, out])[: len(x)]

    def answering(self, model, *args, **kw):
        init(self, model, *args, **kw)
        forward = self.model.forward

        def altered(*a, **k):
            out = forward(*a, **k)
            return torch.cat([-out[:1], out[1:]])

        self.model.forward = altered
        answered.append(weakref.ref(self.model))

    def dk_negated(*args):
        dq, dk, dv = backward(*args)
        return dq, -dk, dv

    patches = {"unchanged": {Trainer: {"train_step": unchanged}},
               "half_batch": {Trainer: {"train_step": half_step, "_apply": half_apply}},
               "answer": {Trainer: {"__init__": answering}},
               "dk_negated": {FlashAttentionBackward: {"forward": staticmethod(dk_negated)}}}[name]
    for cls, attrs in patches.items():
        for attr, fn in attrs.items():
            setattr(cls, attr, fn)
    try:
        yield
    finally:
        Trainer.train_step, Trainer._apply, Trainer.__init__ = step, apply, init
        FlashAttentionBackward.forward = staticmethod(backward)
        for ref in answered:
            model = ref()
            if model is not None:
                del model.forward
