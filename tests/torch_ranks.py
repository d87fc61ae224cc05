"""Rank functions for the port's multi-process tests
(``tests/test_torch_distributed.py``, ``tests/test_torch_dryrun.py``).
``eav_tpu_torch.parallel.distributed.spawn`` pickles them by name, so they
live in a module of their own that imports neither JAX nor a test file.
Each runs on every rank of a gloo group on the CPU and returns numpy."""

import numpy as np
import torch
import torch.distributed as dist

from eav_tpu_torch.core.config import FinetuneConfig, PhaseConfig
from eav_tpu_torch.models.ast import ast_tiny
from eav_tpu_torch.models.dropout import set_generator
from eav_tpu_torch.models.eegnet import EEGNet
from eav_tpu_torch.models.vit import vit_tiny
from eav_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, SUBJECT_AXIS, make_mesh
from eav_tpu_torch.train.loop import DataShards, Trainer, cross_entropy

EEGNET_TINY = dict(chans=4, samples=64, kern_length=16, f1=4, d=2, f2=8)
EEG_CFG = FinetuneConfig(model="eeg", batch_size=8, optimizer="adam", weight_decay=0.0,
                         phases=(PhaseConfig(3, 1e-2, False),), compat_softmax=True)
VIT_CFG = FinetuneConfig(model="vit", batch_size=6, optimizer="adamw", weight_decay=0.01,
                         phases=(PhaseConfig(2, 1e-3, True), PhaseConfig(2, 1e-3, False)),
                         eval_batch_size=4)
TP_MODEL = dict(heads=4, hidden=64, mlp_dim=128)


def eeg_data(seed=0):
    """29 train rows at batch 8: the last batch of 5 splits 3 / 2."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(29, 4, 64)).astype(np.float32), rng.integers(0, 5, 29),
            rng.normal(size=(11, 4, 64)).astype(np.float32), rng.integers(0, 5, 11))


def vit_data(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, size=(15, 32, 32, 3), dtype=np.uint8), rng.integers(0, 5, 15),
            rng.integers(0, 256, size=(7, 32, 32, 3), dtype=np.uint8), rng.integers(0, 5, 7))


def eeg_model():
    return EEGNet(**EEGNET_TINY, dropout_rate=0.25)


def vit_model():
    return vit_tiny(hidden=32, layers=1, heads=2, mlp_dim=64, patch_size=8, image_size=32,
                    preprocess_uint8=True)


def fit_result(res):
    return {"logits": res.outputs_test, "history": res.history,
            "params": {k: v.numpy() for k, v in res.params.items()}}


def plant(fault):
    """A fault of a data-parallel fit, planted in this process:
    ``local_mean``: each rank's loss its rows' mean and the gradients
    averaged (DDP's default); ``local_bn``: BatchNorm over the rank's rows."""
    from eav_tpu_torch.train import loop

    if fault == "local_mean":
        step = Trainer.train_step
        Trainer.train_step = lambda self, opt, x, y, mode="full", batch_rows=None: step(
            self, opt, x, y, mode)
        sum_grads = DataShards.sum_grads_

        def mean_grads(self, model):
            sum_grads(self, model)
            for p in model.parameters():
                if p.grad is not None:
                    p.grad /= self.size

        DataShards.sum_grads_ = mean_grads
    elif fault == "local_bn":
        loop.set_group = lambda model, group: None


def dp_fits(rank, faults=()):
    """EEGNet (dropout, BatchNorm, the uneven last batch) and ViT on uint8
    frames (the frozen-feature cache, then unfrozen) fit over a data axis of
    every rank; then EEGNet under each planted fault."""
    torch.set_num_threads(1)
    mesh = make_mesh(((DATA_AXIS, -1),), "cpu")
    out = {"eeg": fit_result(Trainer(eeg_model(), EEG_CFG, device="cpu").fit(
               eeg_data(), seed=3, mesh=mesh)),
           "vit": fit_result(Trainer(vit_model(), VIT_CFG, device="cpu").fit(
               vit_data(), seed=4, mesh=mesh))}
    for fault in faults:
        plant(fault)
        out[fault] = fit_result(Trainer(eeg_model(), EEG_CFG, device="cpu").fit(
            eeg_data(), seed=3, mesh=mesh))
    return out


def tp_batch(seed=5):
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.normal(size=(4, 128, 128)).astype(np.float32)),
            torch.as_tensor(rng.integers(0, 5, 4)))


def tp_step(model, x, y):
    """Loss and gradients of one train-mode step, dropout on."""
    set_generator(model, torch.Generator().manual_seed(11))
    model.train()
    loss = cross_entropy(model(x), y)
    loss.backward()
    return float(loss.detach()), {k: p.grad.clone() for k, p in model.named_parameters()}


TP_CASES = (("none", False), ("full", False), ("none", True))  # (remat, contiguous qkv)


def tp_cases(rank):
    """One step of ``ast_tiny(heads=4, hidden=64, mlp_dim=128)`` (dropout
    0.1) tensor-parallel over a model axis of every rank, for each case of
    ``TP_CASES`` -> {case: (loss, this rank's gradients by name)}. The
    contiguous case plants the fault of cutting qkv's rows contiguously."""
    from eav_tpu_torch.parallel import tp

    torch.set_num_threads(1)
    mesh = make_mesh(((MODEL_AXIS, -1),), "cpu")
    out = {}
    for remat, contiguous in TP_CASES:
        if contiguous:
            tp._RULES = tuple((rx, (0, 1) if "qkv" in rx else spec) for rx, spec in tp._RULES)
        model = tp.apply_tp(ast_tiny(**TP_MODEL, dropout=0.1, remat=remat), mesh)
        loss, grads = tp_step(model, *tp_batch())
        out[remat, contiguous] = (loss, {k: g.numpy() for k, g in grads.items()})
    return out


STACK_SUBJECTS = 5


def stack_data():
    """(data, seeds, init_params) of a stack of ``STACK_SUBJECTS`` EEGNet
    subjects with a partial init overlay."""
    s = STACK_SUBJECTS
    rng = np.random.default_rng(7)
    data = (rng.normal(size=(s, 12, 4, 64)).astype(np.float32), rng.integers(0, 5, (s, 12)),
            rng.normal(size=(s, 6, 4, 64)).astype(np.float32), rng.integers(0, 5, (s, 6)))
    return data, [10 + i for i in range(s)], {"head.bias": torch.full((s, 5), 0.1)}


def seam(rank):
    """The seam's collectives: an all-reduce, ``agreed`` (a call that fails
    on rank 1 only fails on both), and EEGNet stacked over a subject axis of
    every rank (uneven shares; the first rank's gathered result)."""
    from eav_tpu_torch.parallel.distributed import agreed
    from eav_tpu_torch.parallel.subject import SubjectParallelTrainer

    torch.set_num_threads(1)
    t = torch.tensor([float(rank + 1)])
    dist.all_reduce(t)

    def task(fail_on):
        if rank == fail_on:
            raise ValueError(f"rank {rank} fails")
        return rank

    outcomes = [agreed(task)(None)]
    try:
        agreed(task)(1)
    except Exception as e:  # noqa: BLE001 — the outcome is the result
        outcomes.append(f"{type(e).__name__}: {e}")
    data, seeds, init = stack_data()
    mesh = make_mesh(((SUBJECT_AXIS, -1),), "cpu")
    res = SubjectParallelTrainer(eeg_model(), EEG_CFG, device="cpu", mesh=mesh).fit_stacked(
        data, seeds=seeds, init_params=init)
    try:  # a mesh smaller than the group
        make_mesh(((SUBJECT_AXIS, 1),), "cpu")
        outcomes.append("no error")
    except ValueError as e:
        outcomes.append(str(e))
    return {"all_reduce": (float(t), dist.get_world_size()), "agreed": outcomes,
            "stacked": None if res is None else fit_result(res)}
