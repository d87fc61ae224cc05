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

``fit(mesh=)`` is data parallelism over the mesh's ``data`` axis (the JAX
trainer's ``mesh``, `Transformer_Vision.py:82-83`'s ``nn.DataParallel``):
each rank runs the same fit on its contiguous share of every batch
(``DataShards``) and the fit equals the one-process fit (to roundoff):

- every rank draws the same batch order from the same seeded generator;
  the last partial batch splits unevenly (5 rows over 2 ranks: 3 and 2);
- each rank's loss is its rows' share of the global batch's mean
  (mean · local rows / batch rows; the l1/l2 penalty on the first rank
  only), and the gradients are all-reduced as a SUM: the global batch's
  gradient, whatever the shares (DDP's default, the mean of local means,
  weighs the rows of a smaller share more);
- dropout masks are drawn for the whole batch and each rank keeps its rows
  (``models/dropout.set_rows``); BatchNorm normalises by the global batch's
  statistics (``models/norm.BatchNorm2d``);
- parameters and Adam state start equal (the same seed) and stay equal
  (the same summed gradient, the same max-norm); the frozen-feature cache
  and every evaluation compute each rank's share of the rows and
  all-gather them, so every rank holds the same logits;
- only the group's rank 0 writes ``checkpoint_dir``.

PyTorch runs eagerly, so the JAX trainer's XLA and TPU devices (phase
programs compiled with ``lax.scan``, chunked epochs, device placement
helpers) have no counterpart. Evaluation slices the last batch instead of
padding it; evaluation is pure, so the logits are the same.

On a CUDA device ``train_step`` runs the whole step (forward, loss,
backward, AdamW, max-norm) as one replayed CUDA graph, so the card no
longer waits for the host to launch it kernel by kernel. Each distinct
step (``Trainer._graph_key``: the batch's shapes, the mode, the trainable
set, the optimizer and its settings, the dropout generators) runs eagerly
the first time, on the side stream the capture uses (torch's recipe for
capturing a whole network: AdamW's state and the stream's cuBLAS
workspace are made outside any graph); the second call captures it and
replays it once, later calls replay it. No step is taken twice or left
out, so a fit's trajectory is the eager one's. The step stays eager off
the card, in a data-parallel fit (its all-reduce), while a forward or
backward hook is registered or anomaly mode is on (their Python would run
at capture only), with an optimizer torch cannot capture (one without a
``capturable`` setting), and when a Dropout draws from a generator off
the card, which no graph can register. On the card the trainer makes its
AdamW ``capturable`` at its first step (``make_capturable``), whether that
step is then captured or kept eager (a hook, anomaly mode, a data-parallel
fit): a fit's numbers do not depend on how its steps run, and a
data-parallel fit at world 1 equals the single-card fit bit for bit. What
steps an AdamW outside ``Trainer`` (the stacked trainer, the scripts)
keeps the plain one, which launches fewer kernels.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import json
import os
import threading
import weakref
from dataclasses import asdict
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from eav_tpu_torch.core.config import FinetuneConfig
from eav_tpu_torch.core.device import deterministic_algorithms, resolve_device
from eav_tpu_torch.core.optim import HEAD_REGEX, make_optimizer, maxnorm_project, set_trainable
from eav_tpu_torch.models.dropout import Dropout, set_generator, set_rows
from eav_tpu_torch.models.norm import set_group
from eav_tpu_torch.ops.attention import add_launches, tally_launches
from eav_tpu_torch.parallel.mesh import DATA_AXIS, axis_group, axis_index, axis_size, share
from eav_tpu_torch.utils.profiling import span

GRAPH_CAPTURE = "trainer.graph_capture"  # the span of a step's capture
GRAPH_REPLAY = "trainer.graph_replay"  # the span of a graph's replay
_SIDE = threading.local()  # each thread's side stream, by device (Trainer._side_stream)


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


def writes_files() -> bool:
    """Whether this process writes a fit's files: no process group, or its
    rank 0."""
    return not dist.is_initialized() or dist.get_rank() == 0


class DataShards:
    """A fit's share of the mesh's ``data`` axis: this rank's ``index`` of
    ``size`` and the axis's ``group``. Without a mesh (or without a data
    axis) one shard holds everything and nothing is communicated."""

    def __init__(self, mesh=None):
        self.group = axis_group(mesh, DATA_AXIS)
        self.size = axis_size(mesh, DATA_AXIS)
        self.index = axis_index(mesh, DATA_AXIS)

    def rows(self, n: int):
        """(lo, hi): this rank's contiguous rows of a batch of ``n``."""
        return share(n, self.size, self.index)

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the axis, in place."""
        if self.group is not None:
            dist.all_reduce(t, group=self.group)
        return t

    def sum_grads_(self, model: nn.Module) -> None:
        """Every parameter's gradient summed over the axis, one all-reduce a
        dtype."""
        if self.group is None:
            return
        by_dtype: Dict[torch.dtype, list] = {}
        for p in model.parameters():
            if p.grad is not None:
                by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
        for grads in by_dtype.values():
            flat = self.sum_(torch.cat([g.reshape(-1) for g in grads]))
            for g, part in zip(grads, flat.split([g.numel() for g in grads])):
                g.copy_(part.view_as(g))

    def gather(self, fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        """``fn(x)`` for a row-wise ``fn``: each rank computes its share of
        the rows and every rank gets all of them, in order."""
        if self.group is None:
            return fn(x)
        lo, hi = self.rows(len(x))
        part = fn(x[lo:hi]) if hi > lo else fn(x[:1])[:0]
        pad = -(-len(x) // self.size)  # the longest share
        buf = torch.zeros((pad, *part.shape[1:]), dtype=part.dtype, device=part.device)
        buf[: len(part)] = part
        parts = [torch.empty_like(buf) for _ in range(self.size)]
        dist.all_gather(parts, buf, group=self.group)
        counts = [hi - lo for lo, hi in (share(len(x), self.size, i) for i in range(self.size))]
        return torch.cat([p[:c] for p, c in zip(parts, counts)])


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


def _hooked(model: nn.Module) -> bool:
    """Whether a forward or backward hook (or pre-hook) is registered on any
    module of ``model`` or for every module: a captured step would run its
    Python once, at capture, and never at a replay."""
    m = torch.nn.modules.module
    if (m._global_forward_hooks or m._global_forward_pre_hooks or m._global_backward_hooks
            or m._global_backward_pre_hooks):
        return True
    return any(mod._forward_hooks or mod._forward_pre_hooks or mod._backward_hooks
               or mod._backward_pre_hooks for mod in model.modules())


def _graph_generators(model: nn.Module) -> Optional[Tuple[torch.Generator, ...]]:
    """The generators the model's Dropouts draw this step's masks from,
    each to be registered with a graph so that its replays advance them as
    eager steps do (the default CUDA generator, a Dropout's None, is
    registered by the capture itself); None where one cannot be, a
    generator off the card."""
    gens: list = []
    for mod in model.modules():
        if isinstance(mod, Dropout) and mod.needs_mask() and mod.generator is not None:
            if mod.generator.device.type != "cuda":
                return None
            if all(mod.generator is not g for g in gens):
                gens.append(mod.generator)
    return tuple(gens)


def make_capturable(opt: torch.optim.Optimizer) -> None:
    """Set ``capturable`` on each param group of ``opt`` (torch's AdamW:
    step counts on the parameters' device and no host synchronisation in
    its step, so a CUDA graph can capture it), moving the step counts an
    earlier step left on the host beside their parameters. Its update is
    the same algorithm, its bias correction now computed on the device in
    float32. An optimizer without the setting is left as it is."""
    if "capturable" not in opt.defaults:
        return
    for group in opt.param_groups:
        if group["capturable"]:
            continue
        group["capturable"] = True
        for p in group["params"]:
            step = opt.state.get(p, {}).get("step")
            if torch.is_tensor(step) and step.device != p.device:
                opt.state[p]["step"] = step.to(p.device)


def _drop_graphs_of(trainer_ref: "weakref.ref[Trainer]", _opt) -> None:
    """An optimizer's ``load_state_dict`` hook: new state outdates the
    trainer's graphs. The trainer is held weakly, so that the optimizer
    keeps no trainer, and no graph's memory, alive."""
    trainer = trainer_ref()
    if trainer is not None:
        trainer.drop_graphs()


class StepGraph:
    """One training step, known from its first (eager) run and captured as
    a CUDA graph at its second: its optimizer, the static input buffers
    each replay's batch is copied into, the graph (None until captured),
    its static outputs (loss, correct count) and the flash kernel launches
    it makes (``ops/attention.tally_launches``)."""

    def __init__(self, x: torch.Tensor, y: torch.Tensor, opt: torch.optim.Optimizer):
        self.x, self.y = x.clone(), y.clone()
        self.opt = opt
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs: Tuple[torch.Tensor, ...] = ()
        self.launches: Dict = {}


class Trainer:
    """Two-phase fine-tune runner for a model with the (B, ...) ->
    (B, num_classes) contract and a ``reset_parameters(generator)`` method;
    its optional ``maxnorm_rules`` are projected after every step.

    ``step_counts``: the training steps this trainer ran eagerly, captured
    (and replayed once) and replayed (the module docstring)."""

    def __init__(self, model: nn.Module, cfg: FinetuneConfig,
                 head_regex: str = HEAD_REGEX, device="cuda", deterministic: bool = False):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.cfg = cfg
        self.head_regex = head_regex
        self.deterministic = deterministic
        self.maxnorm_rules = tuple(getattr(model, "maxnorm_rules", ()))
        self._shards = DataShards()  # a fit's (fit(mesh=)); one shard outside a fit
        self.step_counts = {"eager": 0, "captured": 0, "replayed": 0}
        self._graphs: Dict[tuple, StepGraph] = {}  # by _graph_key
        self._hooks: Dict[int, object] = {}  # id(optimizer) -> its load_state_dict hook
        self._pool = None  # the memory pool the trainer's graphs share, from the first capture

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
        ``preprocess_uint8`` converts them), int64 token ids stay int64 (a
        model's embedding reads them), everything else is float32."""
        x = torch.as_tensor(x)
        keep = x.dtype in (torch.uint8, torch.int64)
        return x.to(self.device, x.dtype if keep else torch.float32)

    @torch.no_grad()
    def _batched_apply(self, x: torch.Tensor, batch_size: Optional[int], mode: str) -> torch.Tensor:
        with span("trainer.evaluate"):
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
                   mode: str = "full", batch_rows: Optional[int] = None):
        """One optimizer step on one batch, in the mode (train or eval) the
        model is in, then the max-norm projection -> (loss, correct count),
        both still on the device and the caller's to keep. In a
        data-parallel fit ``x`` is this rank's share of a batch of
        ``batch_rows`` rows: the loss is the share's part of the batch's
        mean, and the gradients are summed over the data axis before the
        step. On the card a step runs eagerly, or is captured as a CUDA
        graph, or replays one (the module docstring; ``step_counts``). Its
        spans: ``trainer.train_step`` holding, in an eager step or a
        capture, ``trainer.forward``, ``trainer.backward``,
        ``trainer.optimizer`` (timed on the card when not capturing) and
        ``trainer.maxnorm``; ``trainer.graph_capture`` around a capture and
        ``trainer.graph_replay`` around a replay."""
        with span("trainer.train_step"):
            if self.device.type == "cuda":
                make_capturable(opt)
            key = self._graph_key(opt, x, y, mode, batch_rows)
            if key is None:
                self.step_counts["eager"] += 1
                return self._step(opt, x, y, mode, batch_rows)
            graph = self._graphs.get(key)
            if graph is None:
                self.step_counts["eager"] += 1
                out = self._warm_up(opt, x, y, mode, batch_rows)
                self._graphs[key] = StepGraph(x, y, opt)
                if id(opt) not in self._hooks:  # new optimizer state outdates the graphs
                    self._hooks[id(opt)] = opt.register_load_state_dict_post_hook(
                        functools.partial(_drop_graphs_of, weakref.ref(self)))
                return out
            if graph.graph is None:
                self.step_counts["captured"] += 1
                self._capture(graph, mode, batch_rows)
            else:
                self.step_counts["replayed"] += 1
            return self._replay(graph, x, y)

    def _step(self, opt: torch.optim.Optimizer, x: torch.Tensor, y: torch.Tensor, mode: str,
              batch_rows: Optional[int]):
        """The step's body, run eagerly or under capture -> (loss, correct)."""
        cfg = self.cfg
        with span("trainer.forward"):
            logits = self._apply(x, mode)
            loss = cross_entropy(logits, y, cfg.compat_softmax)
            n, total = len(y), batch_rows or len(y)
            if total != n:  # a share of the batch: sum over ranks = the batch's mean
                loss = loss * (n / total) if n else logits.sum() * 0.0
            if (cfg.l1_reg or cfg.l2_reg) and self._shards.index == 0:
                # Keras l1_l2 (the audio notebook's SCNN), once over the data axis
                loss = loss + kernel_penalty(self.model, cfg.l1_reg, cfg.l2_reg)
        with span("trainer.backward"):
            opt.zero_grad(set_to_none=True)
            loss.backward()
            self._shards.sum_grads_(self.model)
        with span("trainer.optimizer", device=True):
            opt.step()
        if self.maxnorm_rules:
            with span("trainer.maxnorm"):
                maxnorm_project(self.model, self.maxnorm_rules)
        return loss.detach(), (logits.detach().argmax(-1) == y).sum()

    def _graph_key(self, opt: torch.optim.Optimizer, x: torch.Tensor, y: torch.Tensor,
                   mode: str, batch_rows: Optional[int]) -> Optional[tuple]:
        """What a captured step depends on besides the values of its inputs
        and state, or None where the step must run eagerly (the module
        docstring). Anything the graph bakes in is here: the batch's shapes
        and types, the mode and train/eval, the rows' share, the optimizer
        and each of its group's settings (the lr among them), the
        trainable set, the generators, the deterministic mode, the loss's
        flags. The optimizer and the generators are held by identity, so
        none is taken for another while its steps are known."""
        if (self.device.type != "cuda" or self._shards.group is not None
                or torch.is_anomaly_enabled()
                or not all(g.get("capturable") for g in opt.param_groups)
                or _hooked(self.model)):
            return None
        generators = _graph_generators(self.model)
        if generators is None:
            return None
        cfg = self.cfg
        return (tuple(x.shape), x.dtype, tuple(y.shape), y.dtype, mode, self.model.training,
                batch_rows or len(y), opt,
                tuple(tuple((k, v) for k, v in g.items() if k != "params")
                      for g in opt.param_groups),
                tuple(p.requires_grad for p in self.model.parameters()),
                generators, torch.are_deterministic_algorithms_enabled(),
                cfg.compat_softmax, cfg.l1_reg, cfg.l2_reg)

    def _side_stream(self) -> torch.cuda.Stream:
        """The stream of the warm-ups and captures, after it has waited for
        the current stream's work: one a thread and device, so that the
        trainers a thread makes one after another share its cuBLAS
        workspaces and cached blocks, and no two threads capture on one
        stream."""
        current = torch.cuda.current_stream(self.device)
        streams = vars(_SIDE)
        if current.device not in streams:
            streams[current.device] = torch.cuda.Stream(current.device)
        streams[current.device].wait_stream(current)
        return streams[current.device]

    def _warm_up(self, opt, x, y, mode, batch_rows):
        """A step's first run: eager, on the side stream its capture will
        use."""
        side = self._side_stream()
        with torch.cuda.stream(side):
            out = self._step(opt, x, y, mode, batch_rows)
        torch.cuda.current_stream(self.device).wait_stream(side)
        return out

    def _capture(self, graph: StepGraph, mode: str, batch_rows: Optional[int]) -> None:
        """The step captured into ``graph`` on the side stream, from its
        static inputs; nothing runs until the graph replays. ``thread_local``
        capture, so that other threads (a farm's prefetch and workers) may
        use the card meanwhile. The trainer's graphs share one memory pool,
        which holds one step's memory however many steps are captured: it
        is safe because they replay one at a time on one stream, and what a
        capture leaves allocated in the pool is read only inside that
        graph's own replay or right after it (the gradients, which each
        step makes anew; the static outputs, copied out at once). Before the
        pool's first capture (once a fit) the card's cached blocks are
        freed: a capture cannot free them when it needs memory, and they
        hold the pools of graphs dropped before, which nothing else frees
        while the cache can serve the eager steps (a sweep's earlier fits)."""
        opt, cuda_graph = graph.opt, torch.cuda.CUDAGraph()
        side = self._side_stream()
        if self._pool is None:
            torch.cuda.empty_cache()
        with span(GRAPH_CAPTURE), torch.cuda.stream(side), tally_launches(side) as tally:
            for gen in _graph_generators(self.model):
                cuda_graph.register_generator_state(gen)
            cuda_graph.capture_begin(pool=self._pool, capture_error_mode="thread_local")
            try:
                outputs = self._step(opt, graph.x, graph.y, mode, batch_rows)
            except BaseException:
                with contextlib.suppress(RuntimeError):  # the capture's own error, if any
                    cuda_graph.capture_end()
                raise
            cuda_graph.capture_end()
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph.graph, graph.outputs, graph.launches = cuda_graph, outputs, tally
        self._pool = cuda_graph.pool()

    def _replay(self, graph: StepGraph, x: torch.Tensor, y: torch.Tensor):
        """The graph run on ``x`` and ``y`` -> fresh copies of its outputs."""
        graph.x.copy_(x)
        graph.y.copy_(y)
        with span(GRAPH_REPLAY):
            graph.graph.replay()
        add_launches(graph.launches)
        return tuple(t.clone() for t in graph.outputs)

    def drop_graphs(self) -> None:
        """Forget every captured step; each graph's memory goes with it and
        with the gradients it left on the parameters. Called when the
        optimizer's state is replaced (its ``load_state_dict``) and at the
        end of every fit; the next call of a step runs it eagerly again."""
        for graph in self._graphs.values():
            if graph.graph is not None:
                graph.opt.zero_grad(set_to_none=True)
        for handle in self._hooks.values():
            handle.remove()
        self._graphs.clear()
        self._hooks.clear()
        self._pool = None

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
            checkpoint_dir: Optional[str] = None, mesh=None) -> TrainResult:
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
        configuration or split shape raises ``ValueError``.

        ``mesh`` (``parallel/mesh.make_mesh``) with a ``data`` axis: every
        rank of the axis calls ``fit`` on the same data and seed, and fits
        its share of each batch (the module docstring); every rank returns
        the same result."""
        self._shards = DataShards(mesh)
        set_group(self.model, self._shards.group)
        try:
            with deterministic_algorithms(self.deterministic):
                return self._fit(data, seed, init_params, checkpoint_dir)
        finally:
            self.drop_graphs()
            self._shards = DataShards()
            set_group(self.model, None)
            set_rows(self.model, None)

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
        shards = self._shards
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
                with span("fit.frozen_cache"):
                    px, pe = (shards.gather(
                        lambda part: self._batched_apply(part, None, "features"), x)
                        for x in (tr_x, te_x))
            else:
                mode, px, pe = "full", tr_x, te_x
            for epoch in range(phase.epochs):
                with span("fit.epoch"):
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
                        lo, hi = shards.rows(len(idx))  # this rank's share
                        if shards.group is not None:
                            set_rows(self.model, (lo, hi, len(idx)))
                        loss, corr = self.train_step(opt, px[idx[lo:hi]], tr_y[idx[lo:hi]], mode,
                                                     batch_rows=len(idx))
                        losses.append(loss)
                        correct.append(corr)
                    te_logits = shards.gather(
                        lambda part: self._batched_apply(part, None, mode), pe)
                    hist["loss"].append(shards.sum_(torch.stack(losses)).mean())
                    correct = shards.sum_(torch.stack(correct))
                    hist["train_acc"].append(self._train_acc(correct, n_train, bs))
                    hist["test_acc"].append(self._test_acc(te_logits, te_y))
                    if cfg.keep_epoch_logits:
                        epoch_logits.append(te_logits)
            if checkpoint_dir is not None and writes_files():
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
