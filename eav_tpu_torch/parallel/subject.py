"""Subject-parallel training: S independent per-subject fine-tunes as one
stacked program on one card (``eav_tpu/parallel/subject.py``).

Every subject's parameters, buffers (BatchNorm's running stats) and Adam
state are stacked on a leading subject axis (``torch.func.stack_module_state``
over S copies of the model), and each train step is one call of the model
under ``torch.func.vmap`` through ``functional_call``: one launch sequence
for S subjects where serial fits pay S. The loss is the sum over subjects of
each subject's mean cross-entropy, so one ``backward()`` gives each subject
its own gradient, and one Adam(W) over the stacked leaves is S optimizers
(the update is element by element; a frozen leaf gets no gradient and its
step count does not advance).

Each subject keeps ``Trainer.fit``'s contract at its own seed:

- init: a CPU generator seeded ``seeds[s]`` runs ``reset_parameters``, then
  draws the subject's batch order each epoch; ``init_params`` (a full or
  partial state_dict stacked on the subject axis) overlays the fresh init,
  and unknown keys raise;
- batches: each subject gathers its own indices from the stacked (S, n, ...)
  tensors; the last batch runs at its true size;
- phases: freeze -> unfreeze, the sticky eval mode per epoch, the
  frozen-feature cache where ``Trainer`` takes it, max-norm projected per
  subject after every step (the rules' dims shift by the subject axis);
- dropout: one device generator per subject, seeded ``seeds[s]``. Before
  each step every active Dropout's mask is drawn for every subject from
  that subject's generator, in the forward's order, at the step's shapes
  (``models/dropout.record_dropouts`` finds them), and the masks enter the
  vmapped call as batched ``mask`` buffers: subject s gets the masks its
  serial fit draws;
- ``keep_epoch_logits``: (S, epochs, n_test, classes).

The JAX package's TPU and XLA workarounds are left out: ``mesh`` and
``_mesh_for`` (one card here; the multi-device farm is a later item of the
port), and ``epochs_per_call``, ``epc_target_seconds`` and
``_quantize_chunk`` (they chunk one XLA program to bound a call's time).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call, stack_module_state, vmap

from eav_tpu_torch.core.config import FinetuneConfig
from eav_tpu_torch.core.device import deterministic_algorithms
from eav_tpu_torch.core.optim import HEAD_REGEX, make_optimizer, maxnorm_project, trainable_mask
from eav_tpu_torch.models.dropout import record_dropouts, set_generator
from eav_tpu_torch.train.loop import Trainer


def stacked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          compat_softmax: bool = False) -> torch.Tensor:
    """Each subject's mean cross-entropy (train/loop.py ``cross_entropy``)
    of (S, b, classes) logits -> (S,), through one NLL loss over the S * b
    rows (under vmap the loss decomposes into a gather whose backward is a
    ``scatter_add``, which torch does not promise to be deterministic on
    CUDA)."""
    z = logits.float()
    if compat_softmax:
        z = z.softmax(-1)
    per_row = F.cross_entropy(z.flatten(0, 1), labels.flatten(), reduction="none")
    return per_row.view(labels.shape).mean(1)


class StackedResult(NamedTuple):
    params: Dict[str, torch.Tensor]  # the state_dicts stacked on the subject axis, on the CPU
    history: Dict[str, np.ndarray]  # (subjects, epochs)
    outputs_test: np.ndarray  # (subjects, n_test, classes), the final phase's
    epoch_logits: Optional[np.ndarray] = None  # (subjects, epochs, n_test, classes)


@dataclass
class Stack:
    """S subjects' fit state, each tensor stacked on a leading subject axis."""

    params: Dict[str, torch.Tensor]  # leaves the optimizer updates
    buffers: Dict[str, torch.Tensor]  # BatchNorm's running stats
    dropout_gens: List[torch.Generator]  # on the device, subject s's seeded seeds[s]
    order_gens: List[torch.Generator]  # on the CPU: the init, then each epoch's batch order
    opt: torch.optim.Optimizer


class SubjectParallelTrainer:
    """Stacked fits of ``model`` (any model ``Trainer`` takes) under one
    ``FinetuneConfig``, on ``device`` (``"cuda"`` unless the caller passes
    another); ``deterministic`` as for ``Trainer``. The trainer flags
    ``l1_reg``, ``l2_reg`` and ``compat_batch_mean_acc`` (no preset sets
    them) are serial only and raise here."""

    def __init__(self, model: nn.Module, cfg: FinetuneConfig, head_regex: str = HEAD_REGEX,
                 device="cuda", deterministic: bool = False):
        if cfg.l1_reg or cfg.l2_reg or cfg.compat_batch_mean_acc:
            raise ValueError("l1_reg, l2_reg and compat_batch_mean_acc are not supported "
                             "in stacked fits")
        self.inner = Trainer(model, cfg, head_regex, device, deterministic)
        self.model = self.inner.model  # the module functional_call runs
        set_generator(self.model, None)  # a stacked forward draws no mask itself
        self.cfg = cfg
        self.device = self.inner.device
        self._dropout_calls: Dict[Tuple, List[Tuple[str, torch.Size]]] = {}

    def init_stack(self, seeds: Sequence[int],
                   init_params: Optional[Dict[str, torch.Tensor]] = None) -> Stack:
        """Fresh per-subject state: subject s initialised from ``seeds[s]`` as
        ``Trainer.fit`` does, then ``init_params[k][s]`` loaded over it."""
        copies, order_gens = [], []
        for s, seed in enumerate(seeds):
            gen = torch.Generator().manual_seed(seed)
            m = copy.deepcopy(self.model)
            m.reset_parameters(gen)
            if init_params is not None:
                given = {k: v[s] for k, v in init_params.items()}
                unexpected = m.load_state_dict(given, strict=False).unexpected_keys
                if unexpected:
                    raise KeyError(f"init_params keys not in the model: {sorted(unexpected)}")
            copies.append(m)
            order_gens.append(gen)
        params, buffers = stack_module_state(copies)
        return Stack(params, buffers,
                     [torch.Generator(device=self.device).manual_seed(s) for s in seeds],
                     order_gens, make_optimizer(params.values(), self.cfg))

    def _apply(self, state: Tuple[Dict[str, torch.Tensor], ...], x: torch.Tensor,
               mode: str) -> torch.Tensor:
        """The model on (S, b, ...) ``x`` with subject s's tensors from the
        dicts of ``state`` -> (S, b, classes)."""
        kwargs = {} if mode == "full" else {"mode": mode}

        def one(state, x):
            return functional_call(self.model, state, (x,), kwargs)

        return vmap(one)(state, x)

    @torch.no_grad()
    def _eval(self, state, x: torch.Tensor, mode: str) -> torch.Tensor:
        """Eval-mode outputs for whole (S, n, ...) splits, in batches."""
        self.model.eval()
        n = x.shape[1]
        bs = min(self.cfg.eval_batch_size, n)
        return torch.cat([self._apply(state, x[:, i : i + bs], mode) for i in range(0, n, bs)], 1)

    def _masks(self, stack: Stack, x: torch.Tensor, mode: str) -> Dict[str, torch.Tensor]:
        """Every active Dropout's keep-mask for this step, (S, *shape) bool,
        subject s's drawn from its own generator in the forward's order."""
        if not self.model.training:
            return {}
        key = (tuple(x.shape[1:]), mode)
        calls = self._dropout_calls.get(key)
        if calls is None:  # one unbatched forward of subject 0 finds them
            first = ({k: v[0] for k, v in stack.params.items()},
                     {k: v[0].clone() for k, v in stack.buffers.items()})
            kwargs = {} if mode == "full" else {"mode": mode}
            with torch.no_grad():
                calls = record_dropouts(self.model, lambda: functional_call(
                    self.model, first, (x[0],), kwargs))
            self._dropout_calls[key] = calls
        masks = {}
        for name, shape in calls:
            drop = self.model.get_submodule(name)
            masks[f"{name}.mask"] = torch.stack([drop.draw(shape, self.device, g)
                                                 for g in stack.dropout_gens])
        return masks

    def train_step(self, stack: Stack, x: torch.Tensor, y: torch.Tensor, mode: str = "full"):
        """One optimizer step of every subject on its batch (x (S, b, ...),
        y (S, b)), in the mode (train or eval) the model is in, then the
        max-norm projection -> (loss (S,), correct count (S,)) on the device."""
        masks = self._masks(stack, x, mode)
        logits = self._apply((stack.params, stack.buffers, masks), x, mode)
        loss = stacked_cross_entropy(logits, y, self.cfg.compat_softmax)
        stack.opt.zero_grad(set_to_none=True)
        loss.sum().backward()
        stack.opt.step()
        if self.inner.maxnorm_rules:
            maxnorm_project(stack.params, self.inner.maxnorm_rules, batch_dims=1)
        return loss.detach(), (logits.detach().argmax(-1) == y).sum(1)

    def predict(self, x, params: Dict[str, torch.Tensor]) -> np.ndarray:
        """Eval-mode logits (S, n, classes) of stacked splits (S, n, ...) under
        a stacked state_dict (``StackedResult.params``)."""
        state = {k: v.to(self.device) for k, v in params.items()}
        return self._eval((state,), self.inner._to_device(x), "full").cpu().numpy()

    def fit_stacked(self, data, seeds: Optional[Sequence[int]] = None,
                    init_params: Optional[Dict[str, torch.Tensor]] = None) -> StackedResult:
        """``data`` = (tr_x, tr_y, te_x, te_y), each stacked (S, n, ...);
        subject s is fit at ``seeds[s]`` (default s). ``init_params``: a
        stacked, possibly partial state_dict (e.g. one checkpoint broadcast
        to every subject)."""
        with deterministic_algorithms(self.inner.deterministic):
            return self._fit(data, seeds, init_params)

    def _fit(self, data, seeds, init_params) -> StackedResult:
        cfg = self.cfg
        tr_x, te_x = self.inner._to_device(data[0]), self.inner._to_device(data[2])
        tr_y, te_y = (torch.as_tensor(np.asarray(a), dtype=torch.long, device=self.device)
                      for a in (data[1], data[3]))
        n_subjects, n_train = tr_x.shape[:2]
        seeds = list(seeds) if seeds is not None else list(range(n_subjects))
        if len(seeds) != n_subjects:
            raise ValueError(f"{len(seeds)} seeds for {n_subjects} subjects")
        stack = self.init_stack(seeds, init_params)
        bs = min(cfg.batch_size, n_train)
        rows = torch.arange(n_subjects, device=self.device)[:, None]

        hist = {"loss": [], "train_acc": [], "test_acc": []}
        epoch_logits = []
        te_logits = None
        for phase in cfg.phases:
            mask = trainable_mask(self.model, phase.freeze, self.inner.head_regex)
            for name, p in stack.params.items():
                p.requires_grad_(mask[name])
            for group in stack.opt.param_groups:
                group["lr"] = phase.lr
            state = (stack.params, stack.buffers)
            if phase.freeze and self.inner._frozen_cache_ok():
                mode = "head"
                px, pe = self._eval(state, tr_x, "features"), self._eval(state, te_x, "features")
            else:
                mode, px, pe = "full", tr_x, te_x
            for epoch in range(phase.epochs):
                self.model.train(not (cfg.compat_sticky_eval and epoch > 0))
                if cfg.shuffle:
                    perm = torch.stack([torch.randperm(n_train, generator=g)
                                        for g in stack.order_gens]).to(self.device)
                else:
                    perm = torch.arange(n_train, device=self.device).expand(n_subjects, -1)
                losses, correct = [], []
                for i in range(0, n_train, bs):  # last batch at its true size
                    idx = perm[:, i : i + bs]
                    loss, corr = self.train_step(stack, px[rows, idx], tr_y[rows, idx], mode)
                    losses.append(loss)
                    correct.append(corr)
                te_logits = self._eval(state, pe, mode)
                hist["loss"].append(torch.stack(losses, 1).mean(1))
                hist["train_acc"].append(torch.stack(correct, 1).sum(1) / n_train)
                hist["test_acc"].append((te_logits.argmax(-1) == te_y).float().mean(1))
                if cfg.keep_epoch_logits:
                    epoch_logits.append(te_logits)
        history = {k: torch.stack(v, 1).float().cpu().numpy() for k, v in hist.items()}
        params = {k: v.detach().to("cpu", copy=True)
                  for k, v in {**stack.params, **stack.buffers}.items()}
        kept = torch.stack(epoch_logits, 1).float().cpu().numpy() if epoch_logits else None
        return StackedResult(params, history, te_logits.float().cpu().numpy(), kept)
