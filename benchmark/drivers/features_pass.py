"""Driver of the ``features_pass`` mix: the frozen phase's backbone pass.

A unit is one pass over a subject: the train split, then the test split,
through ``Trainer.extract_features`` at the evaluation batch (the last
batch of each split partial), forward only, in eval mode; the pass ends in
a fence. Set-up builds the trainer and warms up each batch size that a
pass takes: one full and one partial batch of each split.

Every pass's features are kept. Once the window has closed the reference
computes every row's features in float32, and each row of each pass is
judged by its gap: the norm of its difference from the reference's row over
the norm of the reference's row.
"""

from __future__ import annotations

import math

import torch

from benchmark import common
from benchmark.reference import transformer as reference


class Program:
    """The port's trainer on one subject, from the seed."""

    def __init__(self, ctx):
        self.ctx = ctx
        cfg, dev = ctx.config, ctx.device
        self.trainer = common.build_trainer(cfg, dev)
        ctx.mark("trainer")
        self.trainer.model.load_state_dict(common.make_weights(cfg["model"], ctx.seed, dev))
        ctx.mark("weights")
        tr_x, _, te_x, _ = common.make_subject(cfg, ctx.seed, dev)
        self.splits = (tr_x, te_x)
        ctx.mark("data")
        self.outputs = []
        ebs = cfg["protocol"]["eval_batch_size"]
        for x in self.splits:
            self.trainer.extract_features(x[:common.one_of_each(len(x), ebs)])
        ctx.mark("warmup")

    def _pass(self):
        out = []
        for x in self.splits:
            with self.ctx.rec.call("extract_features"):
                out.append(self.trainer.extract_features(x))
        common.fence(self.ctx.device)
        return out

    def unit(self, index: int) -> dict:
        self.outputs.append(self._pass())
        ebs = self.ctx.config["protocol"]["eval_batch_size"]
        sizes = [b - a for x in self.splits for a, b in common.batches(len(x), ebs)]
        n = sum(len(x) for x in self.splits)
        return {"train_samples": 0, "eval_samples": n,
                "flops": common.flops_of(self.ctx.config, 0, n),
                "attention": common.attention_calls(self.ctx.config, sizes, ("fwd",))}

    def release(self) -> dict:
        """The evidence, every pass's features; the trainer and the data go."""
        passes = [torch.cat(p) for p in self.outputs]
        del self.trainer, self.splits, self.outputs
        return {"passes": passes}


def reference_evidence(ctx, evidence=None, precision: str = "float32") -> dict:
    """Every row's features, computed by the reference at ``precision`` in
    blocks of rows; the program's ``evidence`` is not read."""
    cfg, dev, model = ctx.config, ctx.device, ctx.config["model"]
    params = common.make_weights(model, ctx.seed, dev)
    tr_x, _, te_x, _ = common.make_subject(cfg, ctx.seed, dev)
    out = []
    with torch.no_grad(), reference.fp32_matmuls():
        for x in (tr_x, te_x):
            for a, b in common.reference_blocks(model, len(x)):
                out.append(reference.features(x[a:b], params, model, precision))
    return {"passes": [torch.cat(out)]}


def compare(ctx, evidence: dict, ref: dict) -> dict:
    """The number compared: the worst row's feature gap over every row of
    every pass."""
    r = ref["passes"][0]
    norm = r.norm(dim=-1)
    worst = max((float(((p.to(r.device) - r).norm(dim=-1) / norm).max())
                 for p in evidence["passes"]), default=math.inf)
    return {"feature_gap": worst if math.isfinite(worst) else math.inf}
