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
  (``_frozen_cache_ok`` says when that is the same math).

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
from eav_tpu_torch.core.device import resolve_device
from eav_tpu_torch.core.optim import HEAD_REGEX, make_optimizer, set_trainable


class TrainResult(NamedTuple):
    params: Dict[str, torch.Tensor]  # the trained state_dict, copied to the CPU
    history: Dict[str, np.ndarray]  # per-epoch loss, train_acc, test_acc
    outputs_test: np.ndarray  # (n_test, num_classes) final-phase logits


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy in float32 (the JAX trainer's weighted mean with
    unit weights)."""
    return F.cross_entropy(logits.float(), labels)


class Trainer:
    """Two-phase fine-tune runner for a model with the (B, ...) ->
    (B, num_classes) contract and a ``reset_parameters(generator)`` method."""

    def __init__(self, model: nn.Module, cfg: FinetuneConfig,
                 head_regex: str = HEAD_REGEX, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.cfg = cfg
        self.head_regex = head_regex

    def _frozen_cache_ok(self) -> bool:
        """A frozen phase may run on cached backbone features only when that
        is the same math: the model declares the split, the trainer's
        head_regex IS the model's head set (a superset would decay parameters
        the head never touches), and the backbone is deterministic (no
        dropout)."""
        return bool(
            self.cfg.cache_frozen_features
            and getattr(self.model, "supports_head_mode", False)
            and self.head_regex == getattr(self.model, "head_mode_regex", None)
            and getattr(self.model, "dropout", 1.0) == 0.0
        )

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
        return torch.cat([self.model(x[i : i + bs], mode=mode) for i in range(0, n, bs)])

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
        """One optimizer step on one batch -> (loss, correct count), both
        still on the device."""
        self.model.train()
        logits = self.model(x, mode=mode)
        loss = cross_entropy(logits, y)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach(), (logits.detach().argmax(-1) == y).sum()

    def fit(self, data, seed: Optional[int] = None,
            init_params: Optional[Dict[str, torch.Tensor]] = None) -> TrainResult:
        """``data`` = (tr_x, tr_y, te_x, te_y), arrays or tensors. The model
        is re-initialized from ``seed`` (default ``cfg.seed``);
        ``init_params`` (a possibly partial state_dict, e.g. pretrained
        weights) then replaces the matching parameters. Unknown keys raise."""
        cfg = self.cfg
        tr_x, te_x = self._to_device(data[0]), self._to_device(data[2])
        tr_y = torch.as_tensor(np.asarray(data[1]).reshape(-1), dtype=torch.long, device=self.device)
        te_y = torch.as_tensor(np.asarray(data[3]).reshape(-1), dtype=torch.long, device=self.device)
        n_train = tr_x.shape[0]
        gen = torch.Generator().manual_seed(cfg.seed if seed is None else seed)
        self.model.reset_parameters(gen)
        if init_params is not None:
            unexpected = self.model.load_state_dict(init_params, strict=False).unexpected_keys
            if unexpected:
                raise KeyError(f"init_params keys not in the model: {sorted(unexpected)}")
        opt = make_optimizer(self.model, cfg)
        bs = min(cfg.batch_size, n_train)

        hist = {"loss": [], "train_acc": [], "test_acc": []}
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
            for _ in range(phase.epochs):
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
        set_trainable(self.model, False)
        history = {k: torch.stack(v).float().cpu().numpy() for k, v in hist.items()}
        params = {k: v.detach().to("cpu", copy=True) for k, v in self.model.state_dict().items()}
        return TrainResult(params, history, te_logits.float().cpu().numpy())
