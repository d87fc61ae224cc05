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
- ``keep_epoch_logits``: every epoch's test logits in ``epoch_logits``.

PyTorch runs eagerly, so the JAX trainer's XLA and TPU devices (phase
programs compiled with ``lax.scan``, chunked epochs, device placement
helpers) have no counterpart. Evaluation slices the last batch instead of
padding it; evaluation is pure, so the logits are the same.
"""

from __future__ import annotations

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
        and no max-norm projection touches frozen parameters."""
        return bool(
            self.cfg.cache_frozen_features
            and getattr(self.model, "supports_head_mode", False)
            and self.head_regex == getattr(self.model, "head_mode_regex", None)
            and getattr(self.model, "dropout", 1.0) == 0.0
            and not self.maxnorm_rules
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
        logits = self._apply(x, mode)
        loss = cross_entropy(logits, y, self.cfg.compat_softmax)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if self.maxnorm_rules:
            maxnorm_project(self.model, self.maxnorm_rules)
        return loss.detach(), (logits.detach().argmax(-1) == y).sum()

    def fit(self, data, seed: Optional[int] = None,
            init_params: Optional[Dict[str, torch.Tensor]] = None) -> TrainResult:
        """``data`` = (tr_x, tr_y, te_x, te_y), arrays or tensors. The model
        is re-initialized from ``seed`` (default ``cfg.seed``);
        ``init_params`` (a possibly partial state_dict, e.g. pretrained
        weights) then replaces the matching parameters. Unknown keys raise.
        With the trainer's ``deterministic``, the fit runs under
        ``torch.use_deterministic_algorithms(True)``."""
        with deterministic_algorithms(self.deterministic):
            return self._fit(data, seed, init_params)

    def _fit(self, data, seed, init_params) -> TrainResult:
        cfg = self.cfg
        tr_x, te_x = self._to_device(data[0]), self._to_device(data[2])
        tr_y = torch.as_tensor(np.asarray(data[1]).reshape(-1), dtype=torch.long, device=self.device)
        te_y = torch.as_tensor(np.asarray(data[3]).reshape(-1), dtype=torch.long, device=self.device)
        n_train = tr_x.shape[0]
        seed = cfg.seed if seed is None else seed
        gen = torch.Generator().manual_seed(seed)  # init and batch order, on the CPU
        set_generator(self.model, torch.Generator(device=self.device).manual_seed(seed))
        self.model.reset_parameters(gen)
        if init_params is not None:
            unexpected = self.model.load_state_dict(init_params, strict=False).unexpected_keys
            if unexpected:
                raise KeyError(f"init_params keys not in the model: {sorted(unexpected)}")
        opt = make_optimizer(self.model, cfg)
        bs = min(cfg.batch_size, n_train)

        hist = {"loss": [], "train_acc": [], "test_acc": []}
        epoch_logits = []
        te_logits = None
        for phase in cfg.phases:
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
                hist["train_acc"].append(torch.stack(correct).sum() / n_train)
                hist["test_acc"].append((te_logits.argmax(-1) == te_y).float().mean())
                if cfg.keep_epoch_logits:
                    epoch_logits.append(te_logits)
        set_trainable(self.model, False)
        history = {k: torch.stack(v).float().cpu().numpy() for k, v in hist.items()}
        params = {k: v.detach().to("cpu", copy=True) for k, v in self.model.state_dict().items()}
        kept = torch.stack(epoch_logits).float().cpu().numpy() if epoch_logits else None
        return TrainResult(params, history, te_logits.float().cpu().numpy(), kept)
