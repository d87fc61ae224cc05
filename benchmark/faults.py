"""Faults planted in the timed path, each of which the comparison has to
catch (``benchmark/tests/test_bench_faults.py``, ``control.py``):

- ``unchanged``: each training step returns the model's state unchanged (the
  parameters are put back after the optimizer's step);
- ``half_batch``: half of each batch is left out; a training step takes the
  mean loss over the rest, a features pass repeats the rest's rows;
- ``answer``: one answer altered where it is produced: the first row of the
  model's every output, logits (training) or features (a pass), comes out
  negated;
- ``dk_negated`` (planted by ``control.py`` on the card only, where the
  flash kernels run): the attention backward's dK comes out negated, a
  gradient of the right size and the wrong direction.

The exchange between chips is not among them: every cell runs on one chip.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch

FAULTS = {"unfrozen_epochs": ("unchanged", "half_batch", "answer"),
          "features_pass": ("half_batch", "answer")}


@contextlib.contextmanager
def plant(name: str) -> Iterator[None]:
    """The fault ``name`` in the port's ``Trainer`` inside the block."""
    from eav_tpu_torch.models.ast import AST
    from eav_tpu_torch.models.vit import ViT
    from eav_tpu_torch.ops.attention import FlashAttentionBackward
    from eav_tpu_torch.train.loop import Trainer

    step, apply = Trainer.train_step, Trainer._apply
    backward = FlashAttentionBackward.forward
    forwards = {m: m.forward for m in (AST, ViT)}

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

    def answering(forward):
        def altered(self, x, mode="full"):
            out = forward(self, x, mode)
            return torch.cat([-out[:1], out[1:]])
        return altered

    def dk_negated(*args):
        dq, dk, dv = backward(*args)
        return dq, -dk, dv

    patches = {"unchanged": {Trainer: {"train_step": unchanged}},
               "half_batch": {Trainer: {"train_step": half_step, "_apply": half_apply}},
               "answer": {m: {"forward": answering(f)} for m, f in forwards.items()},
               "dk_negated": {FlashAttentionBackward: {"forward": staticmethod(dk_negated)}}}[name]
    for cls, attrs in patches.items():
        for attr, fn in attrs.items():
            setattr(cls, attr, fn)
    try:
        yield
    finally:
        Trainer.train_step, Trainer._apply = step, apply
        FlashAttentionBackward.forward = staticmethod(backward)
        for m, f in forwards.items():
            m.forward = f
