"""Driver of the ``unfrozen_epochs`` mix: the fine-tune's unfrozen phase.

A unit is one epoch: the train split in the epoch's shuffled order through
``Trainer.train_step`` at the protocol's batch (the last batch partial),
then the test split through ``Trainer.predict`` at the evaluation batch,
which returns the logits to the host and so fences the epoch.

Set-up builds the one trainer and optimizer the window uses and warms up
each batch size an epoch takes: one training step of each (rows from the
end of epoch 0's order), then ``Trainer.predict`` over one full and one
partial evaluation batch. The window's epoch 0 follows. The evidence for
``correct``, all of it from the same trainer:

- the trajectory: the warm-up's steps and the window's first
  ``compared_steps`` steps, each step's loss, and each parameter's change
  over them (copied on the card as the window passes, read after it);
- the first step's logits and last-layer output (hooks on the model and
  on the family's ``hidden_module``): the forward's error from the same
  weights;
- the window's first evaluation: ``Trainer.predict``'s logits of the test
  split at the end of epoch 0, judged against the reference's from the
  weights the program held then (copied on the card as the window passes:
  the one number taken from the program's state; the trajectory checks how
  it got there).

Later epochs run the same calls on other rows; the comparison reads epoch
0, where the readings behind its limits were taken (PERF.md §2).

The reference follows the trajectory from the same weights and rows in
float32 with its own AdamW.

Why the last layer's output too: the loss and the change norms are
dominated by one draw per seed, the forward's shift of the logits, which
scales every leaf's gradient alike; the first step's hidden rows, every
token of every row of its batch, measure the forward's error steadily
(PERF.md §2).
"""

from __future__ import annotations

import math
import statistics

import torch
import torch.nn.functional as F

from benchmark import common
from benchmark.reference import shared

# the faults of ``faults.py`` this mix's comparison has to catch
FAULTS = ("unchanged", "half_batch", "answer")
# a leaf's elements whose reference gradient lies under this share of the
# median leaf's RMS gradient move under Adam by round-off alone (a key's
# bias under softmax), and are left out of the change
NOUGHT = 1e-3


def trajectory(ctx) -> list:
    """The row indices of each compared step: one warm-up step of each
    batch size of an epoch (the rows at the end of epoch 0's order), then
    the first ``compared_steps`` batches of epoch 0."""
    n, bs = ctx.config["subject"]["train"], ctx.config["protocol"]["batch_size"]
    perm = common.batch_order(ctx.seed, 0, n)
    sizes = list(dict.fromkeys(b - a for a, b in common.batches(n, bs)))
    at, warm = n - sum(sizes), []
    for s in sizes:
        warm.append(perm[at: at + s])
        at += s
    window = [perm[a:b] for a, b in common.batches(n, bs)[:ctx.traffic["compared_steps"]]]
    return warm + window


class Program:
    """The port's trainer on one subject, from the seed."""

    def __init__(self, ctx):
        from eav_tpu_torch.core.optim import make_optimizer, set_trainable

        self.ctx = ctx
        cfg, dev = ctx.config, ctx.device
        self.trainer = common.build_trainer(cfg, dev)
        ctx.mark("trainer")
        model = self.trainer.model
        self.weights = common.make_weights(ctx.family, cfg["model"], ctx.seed, dev)
        model.load_state_dict(self.weights)
        ctx.mark("weights")
        set_trainable(model, False, self.trainer.head_regex)  # the unfrozen phase
        self.opt = make_optimizer(model, self.trainer.cfg)
        for group in self.opt.param_groups:
            group["lr"] = cfg["protocol"]["unfrozen_lr"]
        model.train()
        ctx.mark("optimizer")
        self.tr_x, self.tr_y, self.te_x, _ = common.make_subject(cfg, ctx.seed, dev)
        ctx.mark("data")
        self.evidence = {"losses": [], "hidden": [], "logits": []}
        hooks = [m.register_forward_hook(
            lambda module, args, out, key=key: self.evidence[key].append(out.detach().float().clone()))
            for m, key in ((ctx.family.hidden_module(model), "hidden"), (model, "logits"))]
        warm = trajectory(ctx)[:-ctx.traffic["compared_steps"]]
        for rows in warm:
            self.evidence["losses"].append(self._step(rows.to(dev)))
            for hook in hooks:
                hook.remove()
        ebs = cfg["protocol"]["eval_batch_size"]
        with ctx.rec.call("predict"):
            self.trainer.predict(self.te_x[:common.one_of_each(len(self.te_x), ebs)])
        ctx.mark("warmup")

    def _step(self, idx: torch.Tensor) -> torch.Tensor:
        with self.ctx.rec.call("train_step"):
            loss, _ = self.trainer.train_step(self.opt, self.tr_x[idx], self.tr_y[idx])
        return loss

    def unit(self, index: int) -> dict:
        """Epoch ``index``; epoch 0 keeps its first steps' losses, the
        parameters after them and the weights and logits of its evaluation,
        without a fence."""
        ctx = self.ctx
        n, bs = len(self.tr_x), ctx.config["protocol"]["batch_size"]
        perm = common.batch_order(ctx.seed, index, n).to(ctx.device)
        compared = ctx.traffic["compared_steps"] if index == 0 else 0
        sizes = []
        for s, (a, b) in enumerate(common.batches(n, bs)):
            loss = self._step(perm[a:b])
            sizes.append(b - a)
            if s < compared:
                self.evidence["losses"].append(loss)
            if s == compared - 1:
                self.evidence["after"] = [p.detach().clone() for p in self.trainer.model.parameters()]
        if index == 0:
            self.evidence["eval_weights"] = {
                name: t.detach().clone() for name, t in self.trainer.model.state_dict().items()}
        with ctx.rec.call("predict"):
            logits = self.trainer.predict(self.te_x)
        if index == 0:
            self.evidence["eval"] = logits
        evals = [b - a for a, b in common.batches(len(self.te_x),
                                                  ctx.config["protocol"]["eval_batch_size"])]
        fam, model = ctx.family, ctx.config["model"]
        return {"train_samples": n, "eval_samples": len(self.te_x),
                "flops": common.flops_of(fam, model, n, len(self.te_x)),
                "work": fam.kernel_work(model, sizes, True) + fam.kernel_work(model, evals, False)}

    def release(self) -> dict:
        """The evidence; the trainer, its optimizer and the data go."""
        ev = self.evidence
        named = [n for n, _ in self.trainer.model.named_parameters()]
        out = {"losses": [float(x) for x in ev["losses"]], "hidden": ev["hidden"],
               "logits": ev["logits"], "eval": torch.as_tensor(ev.get("eval")),
               "delta": {n: p - self.weights[n] for n, p in zip(named, ev.get("after", []))},
               "eval_weights": ev.get("eval_weights", {})}
        del self.trainer, self.opt, self.tr_x, self.tr_y, self.te_x, self.weights, self.evidence
        return out


def reference_evidence(ctx, evidence=None, precision: str = "float32") -> dict:
    """The trajectory, taken by the reference at ``precision`` from the same
    weights, rows and order; and the test split's logits from the weights of
    the ``evidence``'s evaluation (without one, from the weights the
    trajectory ends on)."""
    cfg, dev, model, fam = ctx.config, ctx.device, ctx.config["model"], ctx.family
    proto = cfg["protocol"]
    weights = common.make_weights(fam, model, ctx.seed, dev)
    params = {n: w.clone().requires_grad_(True) for n, w in weights.items()}
    tr_x, tr_y, te_x, _ = common.make_subject(cfg, ctx.seed, dev)
    state, losses, first, grad0 = {}, [], {}, None
    with shared.fp32_matmuls():
        for idx in trajectory(ctx):
            idx = idx.to(dev)
            h = fam.hidden(tr_x[idx], params, model, precision)
            z = fam.head(fam.pool(h, params, model), params, model, precision)
            first = first or {"hidden": [h.detach()], "logits": [z.detach()]}
            loss = F.cross_entropy(z, tr_y[idx])
            grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
            grad0 = grad0 or grads
            shared.adamw_step(params, grads, state, proto["unfrozen_lr"], proto["weight_decay"])
            losses.append(float(loss.detach()))
        del state, grads
        final = {n: p.detach() for n, p in params.items()}
        judged = final if evidence is None else evidence["eval_weights"]
        with torch.no_grad():
            z = torch.cat([fam.logits(te_x[a:b], judged, model, precision)
                           for a, b in fam.reference_blocks(model, len(te_x))])
    return {"losses": losses, **first, "grad0": grad0, "eval": z, "eval_weights": final,
            "delta": {n: p - weights[n] for n, p in final.items()}}


def row_gap(prog: list, ref: list) -> float:
    """The worst row's gap of an output (logits, or the last layer's output
    with every token a row): the norm of the row's difference over the
    larger of the reference row's norm and the median row's; outputs of
    other shapes read infinite."""
    if len(prog) != len(ref) or any(p.shape != r.shape for p, r in zip(prog, ref)):
        return math.inf
    p, r = torch.cat(prog).flatten(0, -2), torch.cat(ref).flatten(0, -2)
    norm = r.norm(dim=-1)
    gap = float(((p.to(r.device, r.dtype) - r).norm(dim=-1) / norm.clamp_min(norm.median())).max())
    return gap if math.isfinite(gap) else math.inf


def compare(ctx, evidence: dict, ref: dict) -> dict:
    """The readings: the worst step's loss gap (relative); over each leaf's
    change, leaving out the elements whose reference gradient is nought,
    the worst leaf's gap of the change's norm (``common.leaf_norm_gaps``)
    and of the change itself (the norm of the difference, over the larger
    of the reference change's norm and the median leaf's); the first step's
    worst hidden row and logit row; the evaluation's worst logit row.
    Beside them each step's loss gap, the median leaf's gaps, the worst
    leaves and the elements left out. The cell's limits file says which
    are compared."""
    losses = evidence["losses"]
    if len(losses) != len(ref["losses"]) or set(evidence["delta"]) != set(ref["delta"]):
        return {}
    steps = [common.relative_gap(p, r, abs(r)) for p, r in zip(losses, ref["losses"])]
    rms = {n: float(g.norm()) / math.sqrt(g.numel()) for n, g in ref["grad0"].items()}
    floor = NOUGHT * statistics.median(rms.values())
    prog, refc, diff, left_out = {}, {}, {}, 0
    for n, g in ref["grad0"].items():
        keep = g.abs() >= floor
        left_out += int(keep.numel() - keep.sum())
        p, r = evidence["delta"][n].to(g.device)[keep], ref["delta"][n][keep]
        prog[n], refc[n], diff[n] = float(p.norm()), float(r.norm()), float((p - r).norm())
    changes = common.leaf_norm_gaps(prog, refc)
    median = statistics.median(refc.values())
    dirs = {n: common.relative_gap(diff[n], 0.0, max(refc[n], median)) for n in refc}
    dirs = {n: g if math.isfinite(g) else math.inf for n, g in dirs.items()}
    return {"loss_gap": max(steps), "change_gap": max(changes.values()),
            "change_dir_gap": max(dirs.values()),
            "hidden_gap": row_gap(evidence["hidden"], ref["hidden"]),
            "logit_gap": row_gap(evidence["logits"], ref["logits"]),
            "eval_gap": row_gap([evidence["eval"]], [ref["eval"]]),
            "change_gap_median": statistics.median(changes.values()),
            "change_dir_gap_median": statistics.median(dirs.values()),
            "step_loss_gaps": steps, "change_leaf": max(changes, key=changes.get),
            "change_dir_leaf": max(dirs, key=dirs.get), "left_out": left_out}
