"""The two-phase fine-tune trainer (``eav_tpu/train/loop.py``'s ``JitTrainer``
contract: ``fit``, ``predict``, ``extract_features``, ``TrainResult``).

Protocol, as in the JAX trainer and the reference (`Transformer_Audio.py`):

- batches in shuffled order (a ``torch.Generator`` seeded per fit), the last
  partial batch at its true size (DataLoader ``drop_last=False``);
- freeze -> unfreeze with ONE AdamW whose lr each phase sets; frozen
  parameters do not advance their step count (core/optim.py);
- a full test-set evaluation after every epoch; the final phase's test
  logits are ``outputs_test``;
- the frozen-feature cache: a frozen phase of a model with a
  features/head split runs on the pooled backbone features computed once
  (``_frozen_cache_ok`` says when that is the same math);
- the model's ``maxnorm_rules`` (EEGNet, the EEG conformer) projected after
  every optimizer step;
- ``compat_softmax`` (the loss of softmax(logits)) and
  ``compat_sticky_eval`` (a phase's epochs after its first train with the
  model in eval mode), the reference's quirks the EEG presets replicate;
- dropout masks from one generator on the trainer's device, seeded per fit
  (``models/dropout.py``), so a fit repeats under its seed on the CPU; on
  the card, torch's backward kernels may sum in another order each run, and
  ``deterministic=True`` runs the fit under
  ``torch.use_deterministic_algorithms`` (``core/device.py``) so that it
  repeats there too;
- ``keep_epoch_logits``: every epoch's test logits in ``epoch_logits``;
- ``l1_reg`` / ``l2_reg``: the Keras SCNN's l1_l2 penalties, added to the
  loss over every kernel (``kernel_penalty``), frozen ones included;
- ``compat_batch_mean_acc``: the history's accuracies as the mean of
  per-batch accuracies (the reference vision trainers' metric), train and
  test alike;
- ``checkpoint_dir``: the state after each phase (weights and BN stats, the
  Adam moments and step counts, both generators) saved as
  ``<dir>/phase<N>.npz`` (``core/checkpoint.py``) beside a fingerprint of the
  configuration; a rerun resumes after the last phase written, and refuses
  a directory written under another configuration.

PyTorch runs eagerly, so the JAX trainer's XLA and TPU devices (phase
programs compiled with ``lax.scan``, chunked epochs, device placement
helpers) have no counterpart. Evaluation slices the last batch instead of
padding it; evaluation is pure, so the logits are the same.
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import asdict
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from eav_tpu_torch.core.config import FinetuneConfig
from eav_tpu_torch.core.device import deterministic_algorithms, resolve_device
from eav_tpu_torch.core.optim import HEAD_REGEX, make_optimizer, maxnorm_project, set_trainable
from eav_tpu_torch.models.dropout import set_generator


class TrainResult(NamedTuple):
    params: Dict[str, torch.Tensor]  # the trained state_dict, copied to the CPU
    history: Dict[str, np.ndarray]  # per-epoch loss, train_acc, test_acc
    outputs_test: np.ndarray  # (n_test, num_classes) final-phase logits
    # (epochs, n_test, num_classes) with cfg.keep_epoch_logits
    epoch_logits: Optional[np.ndarray] = None


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  compat_softmax: bool = False) -> torch.Tensor:
    """Mean cross-entropy in float32 (the JAX trainer's weighted mean with
    unit weights). ``compat_softmax`` replicates the reference's double
    softmax (a Softmax layer feeding CrossEntropyLoss, `EEGNet_tor.py:44,66`
    + `:81`): the CE of log_softmax(softmax(logits))."""
    z = logits.float()
    if compat_softmax:
        z = z.softmax(-1)
    return F.cross_entropy(z, labels)


KERNEL_MODULES = (nn.Linear, nn.modules.conv._ConvNd)


def kernel_penalty(model: nn.Module, l1: float, l2: float) -> torch.Tensor:
    """``l1 * sum |k| + l2 * sum k^2`` over the weights the JAX trainer calls
    ``kernel`` (`eav_tpu/train/loop.py:321-329`): those of every Linear and
    convolution (``KERNEL_MODULES``; the transformers' ``PatchProj`` is one).
    Biases, norm scales, tokens, position embeddings and free parameters
    (the conformer's ``spatial_proj``, the fusion head's) are not kernels."""
    kernels = [m.weight for m in model.modules() if isinstance(m, KERNEL_MODULES)]
    total = torch.zeros((), device=kernels[0].device)
    if l1:
        total = total + l1 * sum(k.abs().sum() for k in kernels)
    if l2:
        total = total + l2 * sum(k.square().sum() for k in kernels)
    return total


class Trainer:
    """Two-phase fine-tune runner for a model with the (B, ...) ->
    (B, num_classes) contract and a ``reset_parameters(generator)`` method;
    its optional ``maxnorm_rules`` are projected after every step."""

    def __init__(self, model: nn.Module, cfg: FinetuneConfig,
                 head_regex: str = HEAD_REGEX, device="cuda", deterministic: bool = False):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.cfg = cfg
        self.head_regex = head_regex
        self.deterministic = deterministic
        self.maxnorm_rules = tuple(getattr(model, "maxnorm_rules", ()))

    def _frozen_cache_ok(self) -> bool:
        """A frozen phase may run on cached backbone features only when that
        is the same math: the model declares the split, the trainer's
        head_regex IS the model's head set (a superset would decay parameters
        the head never touches), the backbone is deterministic (no dropout),
        no max-norm projection touches frozen parameters, and no l1/l2
        penalty sums over the backbone's kernels."""
        return bool(
            self.cfg.cache_frozen_features
            and getattr(self.model, "supports_head_mode", False)
            and self.head_regex == getattr(self.model, "head_mode_regex", None)
            and getattr(self.model, "dropout", 1.0) == 0.0
            and not self.maxnorm_rules
            and not self.cfg.l1_reg
            and not self.cfg.l2_reg
        )

    def _apply(self, x: torch.Tensor, mode: str) -> torch.Tensor:
        """The model on ``x``; only a model with a features/head split takes
        a ``mode``."""
        return self.model(x) if mode == "full" else self.model(x, mode=mode)

    def _to_device(self, x) -> torch.Tensor:
        """On the trainer's device: uint8 frames stay uint8 (a model with
        ``preprocess_uint8`` converts them), everything else is float32."""
        x = torch.as_tensor(x)
        return x.to(self.device, x.dtype if x.dtype == torch.uint8 else torch.float32)

    @torch.no_grad()
    def _batched_apply(self, x: torch.Tensor, batch_size: Optional[int], mode: str) -> torch.Tensor:
        self.model.eval()
        n = x.shape[0]
        bs = min(batch_size or self.cfg.eval_batch_size, n)
        return torch.cat([self._apply(x[i : i + bs], mode) for i in range(0, n, bs)])

    def _load(self, params) -> None:
        if params is not None:
            self.model.load_state_dict(params)

    def predict(self, x, params=None, batch_size: Optional[int] = None) -> np.ndarray:
        """Eval-mode logits for a whole split; ``params`` (e.g.
        ``TrainResult.params``) is loaded first when given."""
        self._load(params)
        return self._batched_apply(self._to_device(x), batch_size, "full").cpu().numpy()

    def extract_features(self, x, params=None, batch_size: Optional[int] = None) -> torch.Tensor:
        """Pooled backbone features (mode='features') for a whole split, on
        the trainer's device."""
        self._load(params)
        return self._batched_apply(self._to_device(x), batch_size, "features")

    def train_step(self, opt: torch.optim.Optimizer, x: torch.Tensor, y: torch.Tensor,
                   mode: str = "full"):
        """One optimizer step on one batch, in the mode (train or eval) the
        model is in, then the max-norm projection -> (loss, correct count),
        both still on the device."""
        cfg = self.cfg
        logits = self._apply(x, mode)
        loss = cross_entropy(logits, y, cfg.compat_softmax)
        if cfg.l1_reg or cfg.l2_reg:  # Keras l1_l2 (the audio notebook's SCNN)
            loss = loss + kernel_penalty(self.model, cfg.l1_reg, cfg.l2_reg)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if self.maxnorm_rules:
            maxnorm_project(self.model, self.maxnorm_rules)
        return loss.detach(), (logits.detach().argmax(-1) == y).sum()

    def _train_acc(self, correct: torch.Tensor, n: int, bs: int) -> torch.Tensor:
        """An epoch's train accuracy from its per-batch correct counts (the
        last axis; a stacked fit's lead with subjects): over samples, or
        with ``compat_batch_mean_acc`` the mean over batches of each batch's
        accuracy (the last, partial batch weighs as a whole)."""
        if not self.cfg.compat_batch_mean_acc:
            return correct.sum(-1) / n
        sizes = torch.full_like(correct, bs, dtype=torch.float32)
        sizes[..., -1] = n - bs * (correct.shape[-1] - 1)
        return (correct / sizes).mean(-1)

    def _test_acc(self, logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Test accuracy over samples (the last axis of ``y``), or with
        ``compat_batch_mean_acc`` the mean over eval batches
        (``eval_batch_size``) of their accuracies."""
        hit = (logits.argmax(-1) == y).float()
        if not self.cfg.compat_batch_mean_acc:
            return hit.mean(-1)
        bs = min(self.cfg.eval_batch_size, hit.shape[-1])
        return torch.stack([c.mean(-1) for c in hit.split(bs, -1)], -1).mean(-1)

    def _ckpt_fingerprint(self, tr_shape, te_shape) -> str:
        """Hash of what decides a fit's trajectory given its data: the whole
        FinetuneConfig, the max-norm rules, the head regex and the split
        shapes (the JAX trainer's ``_ckpt_fingerprint``)."""
        blob = json.dumps({
            "cfg": asdict(self.cfg),
            "maxnorm": [list(r[:2]) + [list(r[2])] for r in self.maxnorm_rules],
            "head_regex": self.head_regex,
            "train_shape": list(tr_shape),
            "test_shape": list(te_shape),
        }, sort_keys=True, default=str)
        return hashlib.sha1(blob.encode()).hexdigest()[:16]

    def fit(self, data, seed: Optional[int] = None,
            init_params: Optional[Dict[str, torch.Tensor]] = None,
            checkpoint_dir: Optional[str] = None) -> TrainResult:
        """``data`` = (tr_x, tr_y, te_x, te_y), arrays or tensors. The model
        is re-initialized from ``seed`` (default ``cfg.seed``);
        ``init_params`` (a possibly partial state_dict, e.g. pretrained
        weights) then replaces the matching parameters. Unknown keys raise.
        With the trainer's ``deterministic``, the fit runs under
        ``torch.use_deterministic_algorithms(True)``.

        ``checkpoint_dir``: the state after each phase is saved there, and a
        fit that finds phases saved resumes after the last one; its history
        then holds the phases it ran (none: one NaN loss and the restored
        model's test accuracy). A directory written under another
        configuration or split shape raises ``ValueError``."""
        with deterministic_algorithms(self.deterministic):
            return self._fit(data, seed, init_params, checkpoint_dir)

    def _phase_state(self, opt: torch.optim.Optimizer, gen: torch.Generator,
                     dropout_gen: torch.Generator) -> dict:
        """What a phase leaves for the next one, as a tree of tensors."""
        names = {p: n for n, p in self.model.named_parameters()}
        return {
            "params": dict(self.model.state_dict()),
            "opt": {names[p]: dict(st) for p, st in opt.state.items()},
            "rng": {"batch": gen.get_state(), "dropout": dropout_gen.get_state()},
        }

    def _restore_phase_state(self, state: dict, opt: torch.optim.Optimizer,
                             gen: torch.Generator, dropout_gen: torch.Generator) -> None:
        self.model.load_state_dict({k: torch.from_numpy(v) for k, v in state["params"].items()})
        params = dict(self.model.named_parameters())
        saved = opt.state_dict()
        index = {id(p): i for i, p in enumerate(opt.param_groups[0]["params"])}
        saved["state"] = {index[id(params[n])]: {k: torch.from_numpy(v) for k, v in st.items()}
                          for n, st in state.get("opt", {}).items()}
        opt.load_state_dict(saved)
        gen.set_state(torch.from_numpy(state["rng"]["batch"]))
        dropout_gen.set_state(torch.from_numpy(state["rng"]["dropout"]))

    def _fit(self, data, seed, init_params, checkpoint_dir) -> TrainResult:
        cfg = self.cfg
        tr_x, te_x = self._to_device(data[0]), self._to_device(data[2])
        tr_y = torch.as_tensor(np.asarray(data[1]).reshape(-1), dtype=torch.long, device=self.device)
        te_y = torch.as_tensor(np.asarray(data[3]).reshape(-1), dtype=torch.long, device=self.device)
        n_train = tr_x.shape[0]
        seed = cfg.seed if seed is None else seed
        gen = torch.Generator().manual_seed(seed)  # init and batch order, on the CPU
        dropout_gen = torch.Generator(device=self.device).manual_seed(seed)
        set_generator(self.model, dropout_gen)
        self.model.reset_parameters(gen)
        if init_params is not None:
            unexpected = self.model.load_state_dict(init_params, strict=False).unexpected_keys
            if unexpected:
                raise KeyError(f"init_params keys not in the model: {sorted(unexpected)}")
        opt = make_optimizer(self.model, cfg)
        bs = min(cfg.batch_size, n_train)

        start_phase = 0
        if checkpoint_dir is not None:
            from eav_tpu_torch.core.checkpoint import load_pytree

            fp = self._ckpt_fingerprint(tr_x.shape, te_x.shape)
            fp_path = os.path.join(checkpoint_dir, "fingerprint.txt")
            if os.path.exists(fp_path):
                with open(fp_path) as f:
                    saved_fp = f.read().strip()
                if saved_fp != fp:
                    raise ValueError(
                        f"checkpoint_dir {checkpoint_dir} was written under another "
                        f"configuration (fingerprint {saved_fp} != {fp}: FinetuneConfig, "
                        "max-norm rules, head regex or split shapes changed); refusing to "
                        "resume: name a fresh directory or delete the stale checkpoints")
            for i in range(len(cfg.phases) - 1, -1, -1):
                path = os.path.join(checkpoint_dir, f"phase{i}")
                if os.path.exists(path + ".npz"):
                    self._restore_phase_state(load_pytree(path), opt, gen, dropout_gen)
                    start_phase = i + 1
                    break

        hist = {"loss": [], "train_acc": [], "test_acc": []}
        epoch_logits = []
        te_logits = None
        for phase_idx, phase in enumerate(cfg.phases):
            if phase_idx < start_phase:
                continue
            set_trainable(self.model, phase.freeze, self.head_regex)
            for group in opt.param_groups:
                group["lr"] = phase.lr
            if phase.freeze and self._frozen_cache_ok():
                mode = "head"
                px, pe = self.extract_features(tr_x), self.extract_features(te_x)
            else:
                mode, px, pe = "full", tr_x, te_x
            for epoch in range(phase.epochs):
                # Trainer_uni's sticky eval mode: after the phase's first
                # epoch, train with dropout off and BN on its running stats
                self.model.train(not (cfg.compat_sticky_eval and epoch > 0))
                if cfg.shuffle:
                    perm = torch.randperm(n_train, generator=gen).to(self.device)
                else:
                    perm = torch.arange(n_train, device=self.device)
                losses, correct = [], []
                for i in range(0, n_train, bs):  # last batch at its true size
                    idx = perm[i : i + bs]
                    loss, corr = self.train_step(opt, px[idx], tr_y[idx], mode)
                    losses.append(loss)
                    correct.append(corr)
                te_logits = self._batched_apply(pe, None, mode)
                hist["loss"].append(torch.stack(losses).mean())
                hist["train_acc"].append(self._train_acc(torch.stack(correct), n_train, bs))
                hist["test_acc"].append(self._test_acc(te_logits, te_y))
                if cfg.keep_epoch_logits:
                    epoch_logits.append(te_logits)
            if checkpoint_dir is not None:
                from eav_tpu_torch.core.checkpoint import save_pytree

                save_pytree(os.path.join(checkpoint_dir, f"phase{phase_idx}"),
                            self._phase_state(opt, gen, dropout_gen))
                if not os.path.exists(fp_path):
                    with open(fp_path, "w") as f:
                        f.write(fp + "\n")
        set_trainable(self.model, False)
        params = {k: v.detach().to("cpu", copy=True) for k, v in self.model.state_dict().items()}
        if not hist["loss"]:
            # every phase was restored: the result of the restored model
            outputs_test = self.predict(te_x)
            acc = float((outputs_test.argmax(-1) == te_y.cpu().numpy()).mean())
            history = {"loss": np.array([np.nan]), "train_acc": np.array([np.nan]),
                       "test_acc": np.array([acc])}
            return TrainResult(params, history, outputs_test, None)
        history = {k: torch.stack(v).float().cpu().numpy() for k, v in hist.items()}
        kept = torch.stack(epoch_logits).float().cpu().numpy() if epoch_logits else None
        return TrainResult(params, history, te_logits.float().cpu().numpy(), kept)
