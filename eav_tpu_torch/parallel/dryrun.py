"""A dry run of the multi-card layer on tiny shapes: the port of
``__graft_entry__.dryrun_multichip``, with its legs.

    python -m eav_tpu_torch.parallel.dryrun [N] [--device cuda|cpu]

On N ranks (``distributed.spawn``: NCCL with a card each when N cards are
visible; else N gloo ranks on ``cuda:0``, or on the CPU with ``cpu``):

1. the stacked EEGNet over a ``subject`` axis of N subjects, then from a
   checkpoint broadcast to every subject, whole and partial (the head);
2. two chained train steps of a tiny AST, dropout on, tensor-parallel
   over a ``data`` x ``model`` mesh (dp 2 when N is even, tp N / dp), the
   data axis's gradient summed, AdamW's state threading;
3. a data-parallel fit of a tiny ViT on uint8 frames over a ``data`` axis
   of N ranks (the per-frame vision fine-tune's path).

Then, in this process (the farm's workers are threads):

4. the task farm over N devices (``cuda:0`` .. ``cuda:N-1`` when visible,
   else N workers on one card or on the CPU) through the real pipelines
   and sweep: every task done, at least two workers used (two devices
   where there are);
5. the sweep's policy: a stacked group with a subject that always fails
   stacked bisects, fits the rest stacked and the failing subject by the
   serial fallback;
6. the CLI's ``_run_sweep`` at ``--subject-parallel 2 --chip-parallel
   min(4, N)``: the stacked EEG groups as a farm worker's setup,
   overlapped with the farmed tiny-AST audio tasks.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import Dict, List

import numpy as np
import torch

from eav_tpu_torch.core.config import FinetuneConfig, PhaseConfig


def _placement(n: int, device: str):
    """(rank device, backend) of the ranks, and the farm's devices."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return ("cpu", "gloo"), [dev] * n
    if not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip: no CUDA GPU; pass device='cpu' to run on the CPU")
    if torch.cuda.device_count() >= n:
        return ("cuda", "nccl"), [torch.device("cuda", i) for i in range(n)]
    return ("cuda:0", "gloo"), [torch.device("cuda", 0)] * n


def _rank_legs(rank: int, n: int, device: str) -> Dict[str, object]:
    """Legs 1-3 on one rank (its group joined)."""
    from eav_tpu_torch.core.optim import make_optimizer
    from eav_tpu_torch.models.ast import ast_tiny
    from eav_tpu_torch.models.dropout import set_generator, set_rows
    from eav_tpu_torch.models.eegnet import EEGNet
    from eav_tpu_torch.models.vit import ViT
    from eav_tpu_torch.parallel import tp
    from eav_tpu_torch.parallel.distributed import rank_device
    from eav_tpu_torch.parallel.mesh import (
        DATA_AXIS, MODEL_AXIS, SUBJECT_AXIS, make_mesh, shard_rows)
    from eav_tpu_torch.parallel.subject import SubjectParallelTrainer
    from eav_tpu_torch.train.loop import DataShards, Trainer, cross_entropy

    dev = rank_device(device)
    out: Dict[str, object] = {}
    rng = np.random.default_rng(0)

    # 1. the stacked EEGNet over the subject axis, fresh and from a checkpoint
    mesh = make_mesh(((SUBJECT_AXIS, n),), dev.type)
    s, n_tr, n_te, chans, samples = n, 16, 8, 6, 64
    data = (rng.normal(size=(s, n_tr, chans, samples)).astype(np.float32),
            rng.integers(0, 5, (s, n_tr)),
            rng.normal(size=(s, n_te, chans, samples)).astype(np.float32),
            rng.integers(0, 5, (s, n_te)))
    cfg = FinetuneConfig(model="eegnet", batch_size=8, optimizer="adam",
                         phases=(PhaseConfig(epochs=1, lr=1e-3, freeze=False),))
    sp = SubjectParallelTrainer(EEGNet(chans=chans, samples=samples, kern_length=16), cfg,
                                device=dev, mesh=mesh)
    one = EEGNet(chans=chans, samples=samples, kern_length=16,
                 generator=torch.Generator().manual_seed(99)).state_dict()
    full = {k: v.expand(s, *v.shape) for k, v in one.items()}
    head = {k: v for k, v in full.items() if k.startswith("head.")}
    for name, init in (("stacked", None), ("stacked_full", full), ("stacked_partial", head)):
        res = sp.fit_stacked(data, init_params=init)
        if rank == 0:
            assert res.outputs_test.shape == (s, n_te, 5), res.outputs_test.shape
            assert np.isfinite(res.outputs_test).all()
            out[name] = res.outputs_test.shape
        else:
            assert res is None

    # 2. a tiny AST, tensor-parallel over data x model, two chained steps
    dp = 2 if n % 2 == 0 else 1
    mesh2 = make_mesh(((DATA_AXIS, dp), (MODEL_AXIS, n // dp)), dev.type)
    # head dim 16 a model rank (JAX's tp * 16 hidden gives 4): on a card the
    # flash kernels, built for head dims 16-128, serve the head shards
    ast = ast_tiny(heads=4, hidden=(n // dp) * 64, mlp_dim=(n // dp) * 128, dropout=0.1,
                   attn_impl="auto").to(dev)
    tp.apply_tp(ast, mesh2)
    batch = 4 * dp
    bx = torch.as_tensor(rng.normal(size=(batch, 128, 128)).astype(np.float32), device=dev)
    by = torch.as_tensor(rng.integers(0, 5, batch), device=dev)
    x, y = shard_rows(bx, mesh2, DATA_AXIS), shard_rows(by, mesh2, DATA_AXIS)
    shards = DataShards(mesh2)
    lo, hi = shards.rows(batch)
    set_generator(ast, torch.Generator(device=dev).manual_seed(7))
    set_rows(ast, (lo, hi, batch))
    opt = make_optimizer(ast, FinetuneConfig(model="ast", batch_size=batch, weight_decay=0.01,
                                             phases=(PhaseConfig(1, 1e-4, False),)))
    ast.train()
    losses = []
    for _ in range(2):  # two chained steps: the optimizer state threads
        opt.zero_grad(set_to_none=True)
        loss = cross_entropy(ast(x), y) * (len(y) / batch)
        loss.backward()
        shards.sum_grads_(ast)
        opt.step()
        losses.append(float(shards.sum_(loss.detach().clone())))
    assert all(np.isfinite(losses)) and next(iter(opt.state.values()))["step"] == 2, losses
    out["tp_dp"] = (dp, n // dp, losses)

    # 3. a ViT fit on uint8 frames, data-parallel over every rank
    mesh3 = make_mesh(((DATA_AXIS, n),), dev.type)
    vit = ViT(hidden=16, layers=1, heads=2, mlp_dim=32, patch_size=8, image_size=16,
              preprocess_uint8=True)
    rng2 = np.random.default_rng(1)
    vdata = (rng2.integers(0, 255, size=(4 * n, 16, 16, 3)).astype(np.uint8),
             rng2.integers(0, 5, 4 * n),
             rng2.integers(0, 255, size=(n, 16, 16, 3)).astype(np.uint8),
             rng2.integers(0, 5, n))
    vcfg = FinetuneConfig(model="vit", batch_size=2 * n, optimizer="adamw",
                          phases=(PhaseConfig(epochs=1, lr=1e-4, freeze=True),))
    vres = Trainer(vit, vcfg, device=dev).fit(vdata, seed=0, mesh=mesh3)
    assert vres.outputs_test.shape == (n, 5)
    out["vit_logits"] = vres.outputs_test
    return out


def _eeg_overrides() -> List[str]:
    return ["eeg.finetune.model_kwargs.chans=4", "eeg.finetune.model_kwargs.samples=64",
            "eeg.finetune.model_kwargs.kern_length=8", "eeg.finetune.phases.0.epochs=2",
            "eeg.split.h_idx=1"]


def _farm_legs(n: int, devices, tmp: str) -> Dict[str, object]:
    """Legs 4-6 in this process."""
    from eav_tpu_torch import cli
    from eav_tpu_torch.core.config import SweepConfig, apply_overrides
    from eav_tpu_torch.core.sweep import SweepRunner
    from eav_tpu_torch.parallel.farm import device_workers
    from eav_tpu_torch.train.pipeline import ModalityPipelines, _cfg_hash, default_presets

    out: Dict[str, object] = {}
    rng = np.random.default_rng(4)
    subjects = tuple(range(1, n + 1))
    y = np.repeat(np.arange(5), 2).astype(np.int32)

    # 4. the farm over n devices
    presets = apply_overrides(default_presets(), _eeg_overrides())
    cache = os.path.join(tmp, "cache")
    os.makedirs(cache)
    for s in subjects:
        np.savez(os.path.join(cache, f"s{s:02d}_eeg_{_cfg_hash(presets['eeg'].eeg)}.npz"),
                 x=rng.normal(size=(10, 4, 64)).astype(np.float32), y=y)

    def make_pipelines(dev=devices[0]):
        return ModalityPipelines("/nonexistent", cache_dir=cache, presets=presets, device=dev)

    def sweep_cfg(name, modalities=("eeg",)):
        return SweepConfig(subjects=subjects, modalities=modalities,
                           journal_path=os.path.join(tmp, f"{name}_journal.jsonl"),
                           metrics_path=os.path.join(tmp, f"{name}_metrics.jsonl"),
                           checkpoint_dir=None)

    farm = SweepRunner(sweep_cfg("farm"), make_pipelines().task_fn)
    state = farm.run_farmed(device_workers(make_pipelines, devices=devices), verbose=False)
    assert all(r["status"] == "done" for r in state.values()), state
    workers = {r["worker"] for r in state.values()}
    assert len(workers) >= 2, f"the farm did not spread over its workers: {workers}"
    farm_devs = {r["device"] for r in state.values()}
    if len(set(devices)) >= 2:
        assert len(farm_devs) >= 2, f"the farm did not spread over devices: {farm_devs}"
    out["farm"] = {"workers": len(workers), "devices": sorted(farm_devs)}

    # 5. the sweep's policy: bisection, then the serial fallback
    pipelines = make_pipelines()
    bad = subjects[min(2, n - 1)]

    def batch_fn(subs):
        if bad in subs:
            raise RuntimeError("injected stacked failure")
        return pipelines.run_stacked(list(subs), "eeg")

    pol_cfg = sweep_cfg("policy")
    pol = SweepRunner(pol_cfg, pipelines.task_fn).run_batched(
        "eeg", batch_fn, group_size=n, verbose=False)
    assert all(r["status"] == "done" for r in pol.values()), pol
    assert "serial fallback" in pol[f"subject{bad:02d}_eeg"].get("note", "")
    with open(pol_cfg.metrics_path) as f:
        rows = [json.loads(line) for line in f]
    assert len([r for r in rows if r.get("accuracy") is not None]) == n
    out["policy"] = f"subject {bad} by the serial fallback"

    # 6. the CLI's sweep: stacked EEG setup overlapped with the farmed audio
    # (hidden 32 over 2 heads: the preset's flash attention takes head dim 16
    # on a card; JAX's leg has hidden 16)
    presets6 = apply_overrides(default_presets(), _eeg_overrides() + [
        "audio.audio.max_frames=64", "audio.finetune.model_kwargs.hidden=32",
        "audio.finetune.model_kwargs.layers=1", "audio.finetune.model_kwargs.heads=2",
        "audio.finetune.model_kwargs.mlp_dim=64", "audio.finetune.model_kwargs.max_frames=64",
        "audio.finetune.phases.0.epochs=1", "audio.finetune.phases.1.epochs=1",
        "audio.finetune.batch_size=5", "audio.split.h_idx=1"])
    cache6 = os.path.join(tmp, "cache6")
    os.makedirs(cache6)
    for s in subjects:
        np.savez(os.path.join(cache6, f"s{s:02d}_eeg_{_cfg_hash(presets6['eeg'].eeg)}.npz"),
                 x=rng.normal(size=(10, 4, 64)).astype(np.float32), y=y)
        np.savez(os.path.join(cache6, f"s{s:02d}_aud_fbank_{_cfg_hash(presets6['audio'].audio)}.npz"),
                 x=rng.normal(size=(10, 64, 128)).astype(np.float32), y=y)

    def make_pipelines6(dev=devices[0]):
        return ModalityPipelines("/nonexistent", cache_dir=cache6, presets=presets6, device=dev)

    cfg6 = sweep_cfg("overlap", ("eeg", "audio"))
    pipelines6 = make_pipelines6()
    runner6 = SweepRunner(cfg6, pipelines6.task_fn)
    workers6 = min(4, n)
    args6 = argparse.Namespace(subject_parallel=2, chip_parallel=workers6, data_parallel=1,
                               farm_timeout_minutes=0.0)
    assert cli._run_sweep(args6, cfg6, runner6, pipelines6, make_pipelines6,
                          devices[:workers6]) == 0
    with open(cfg6.metrics_path) as f:
        rows6 = [json.loads(line) for line in f]
    eeg_rows = [r for r in rows6 if r.get("modality") == "eeg"]
    aud_rows = [r for r in rows6 if r.get("modality") == "audio"]
    assert len(eeg_rows) == n and all(r.get("group_size") in (1, 2) for r in eeg_rows), eeg_rows
    assert len(aud_rows) == n
    summary = [r for r in rows6 if r.get("event") == "farm_summary"][-1]
    assert summary["n_tasks"] == n  # only audio farmed
    assert summary["busy_s"][0] > 0.0  # worker 0 ran the stacked pass
    assert runner6.pending_tasks() == []
    out["overlap"] = {"audio_workers": len({r["worker"] for r in aud_rows})}
    return out


def dryrun_multichip(n_devices: int, device="cuda") -> Dict[str, object]:
    """Every leg above on ``n_devices`` ranks / devices; raises on a failed
    leg, returns what each leg read (rank 0's for legs 1-3)."""
    from eav_tpu_torch.parallel.distributed import spawn

    if n_devices < 2:
        raise ValueError("dryrun_multichip needs 2 or more devices")
    (rank_device, backend), farm_devices = _placement(n_devices, device)
    out = spawn(_rank_legs, n_devices, n_devices, rank_device,
                device=rank_device, backend=backend)[0]
    with tempfile.TemporaryDirectory() as tmp:
        out.update(_farm_legs(n_devices, farm_devices, tmp))
    dp, tp_size, losses = out["tp_dp"]
    print(f"dryrun_multichip({n_devices}, {device!r}): ok (subject-parallel stack + "
          f"stacked-pretrained full and partial overlays; dp{dp} x tp{tp_size} AST steps, "
          f"losses {losses[0]:.4f} / {losses[1]:.4f}; dp{n_devices} uint8 ViT fit; the farm "
          f"over {out['farm']['workers']} workers on {out['farm']['devices']}; the bisect / "
          f"serial-fallback policy; the overlapped stacked setup and farm)", flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m eav_tpu_torch.parallel.dryrun")
    p.add_argument("n", type=int, nargs="?", default=2)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dryrun_multichip(args.n, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
