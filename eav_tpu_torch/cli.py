"""The port's command line, with the JAX package's subcommands and flags
(``eav_tpu/cli.py``):

  python -m eav_tpu_torch.cli presets
  python -m eav_tpu_torch.cli verify-data --data-root /data/EAV --subjects 1-42
  python -m eav_tpu_torch.cli run --data-root /data/EAV --subjects 1-42 \\
      --modalities eeg,audio,vision --cache-dir ./cache --out ./runs/sweep1
  python -m eav_tpu_torch.cli aggregate --out ./runs/sweep1

``run`` fits on the card (``--device cuda``, the default; it raises when no
GPU is visible) unless ``--device cpu`` is given. Its own flags beside
JAX's: ``--device`` and ``--deterministic`` (torch's deterministic mode,
set once for the whole run). ``--epochs-per-call`` and
``--epc-target-seconds`` are accepted so that a JAX command line runs
unchanged, and change nothing: they cut one XLA program into device calls,
and PyTorch runs eagerly.

``run --data-parallel N`` runs the sweep on N ranks, one card each
(``cuda:0`` .. ``cuda:N-1``; with ``--device cpu``, N gloo ranks on the
CPU): spawned here, or, under ``torchrun --nproc-per-node N``, this process
is one of them. The vision fine-tunes split their batches over the ranks
(``Trainer.fit(mesh=)``), as the JAX CLI's do; every other task runs whole
on every rank, the same work each time. Every rank visits the same tasks in
the same order, and a task that fails on any rank fails on all of them
(``parallel/distributed.agreed``), so retries stay in step. Rank 0 alone
writes the journal, ``metrics.jsonl``, the logits, checkpoints and a
``--profile`` trace.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List


def _parse_subjects(spec: str) -> List[int]:
    out: List[int] = []
    for part in spec.split(","):
        if "-" in part:
            a, b = part.split("-")
            out.extend(range(int(a), int(b) + 1))
        else:
            out.append(int(part))
    return out


def _presets(args):
    """``default_presets()`` with ``--config``, then ``--set``, applied."""
    from eav_tpu_torch.core.config import apply_overrides, load_override_file
    from eav_tpu_torch.train.pipeline import default_presets

    presets = default_presets()
    if args.config:
        presets = apply_overrides(presets, load_override_file(args.config))
    if args.set:
        presets = apply_overrides(presets, args.set)
    return presets


def cmd_presets(_args) -> int:
    from eav_tpu_torch.core.config import PRESETS
    from eav_tpu_torch.train.pipeline import default_presets

    for name, p in PRESETS.items():
        print(f"{name:18s} {p.description}")
    print("\nmodality keys (run --modalities, --set <key>.<field>=<value>):")
    for key, p in default_presets().items():
        print(f"{key:18s} {p.name}")
    return 0


# Subjects stacked into one program per family (--subject-parallel caps),
# from the port's runs of chip_smoke.py on an NVIDIA H100 80GB HBM3 at
# 700.00 W (PERF.md):
# - EEGNet and the conformer stack all 42 subjects (3.9 and 42.9 GiB; 1.9x
#   and 6.8x a subject over serial);
# - AST-base fits at S 2 but runs a subject 2x slower than serial flash
#   attention, and a stacked transformer resolves the presets' 'auto'
#   attention to math; ViT-base is not measured stacked: 1, serial per card;
# - the SCNN: 16 (1.22-1.24 ms a subject-step against 1.32 at S 8 and
#   1.49 at S 42; its serial step 2.5-4.2 ms, host-bound);
# - ResNet50 + attention: 1 (a float32 step is device-bound serially).
_STACK_CAPS = {"eeg": 42, "eeg_conformer": 42, "audio": 1, "audio_scnn": 16,
               "vision": 1, "vision_resnet": 1}


def _partition_stacked_chunks(stacked, pending_by_mod, n_workers):
    """Spread the stacked families' group-sized chunks round-robin over the
    workers: ``[{mod: (group_size, [subjects])}]``, one dict per setup
    worker. Whole chunks move, in pending order, so each worker's
    ``run_batched(only_subjects=...)`` regroups into exactly the chunks it
    was given (at most one partial chunk exists, and it stays last)."""
    chunks = []
    for mod, group in stacked:
        pend = pending_by_mod.get(mod, [])
        chunks += [(mod, group, pend[i : i + group]) for i in range(0, len(pend), group)]
    n_setup = min(n_workers, len(chunks))
    assign = [dict() for _ in range(n_setup)]
    for j, (mod, group, subs) in enumerate(chunks):
        d = assign[j % n_setup]
        if mod in d:
            d[mod][1].extend(subs)
        else:
            d[mod] = (group, list(subs))
    return assign


def _farm_devices(device, n: int):
    """The farm's devices: cuda:0 .. cuda:n-1 for a CUDA run (exits when
    fewer are visible), else ``n`` workers on ``device``."""
    import torch

    if device.type != "cuda":
        return [device] * n
    visible = torch.cuda.device_count()
    if visible < n:
        raise SystemExit(f"--chip-parallel {n} requested but only {visible} CUDA devices "
                         "are visible")
    return [torch.device("cuda", i) for i in range(n)]


def cmd_run(args) -> int:
    from eav_tpu_torch.core.device import resolve_device

    if args.chip_parallel >= 1 and args.data_parallel > 1:
        raise SystemExit(
            "--chip-parallel and --data-parallel are mutually exclusive: the "
            "farm gives each fine-tune a whole chip; DP shards one fine-tune "
            "across chips")
    device = resolve_device(args.device)
    if args.data_parallel > 1:
        return _run_data_parallel(args, device)
    devices = _farm_devices(device, args.chip_parallel) if args.chip_parallel >= 1 else None
    return _run(args, device, devices)


def _run_data_parallel(args, device) -> int:
    """``run --data-parallel N``: N ranks, spawned here (or this process
    one of them under torchrun), each running ``_data_parallel_rank``."""
    import torch

    from eav_tpu_torch.parallel import distributed

    n = args.data_parallel
    if device.type == "cuda":
        if device.index is not None:
            raise SystemExit(f"--data-parallel {n} gives rank r the card cuda:r; pass "
                             "--device cuda")
        if torch.cuda.device_count() < n:
            raise SystemExit(f"--data-parallel {n} requested but only "
                             f"{torch.cuda.device_count()} devices are visible")
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:  # torchrun's rank
        if int(os.environ["WORLD_SIZE"]) != n:
            raise SystemExit(f"--data-parallel {n} under torchrun with "
                             f"{os.environ['WORLD_SIZE']} processes")
        address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
        distributed.init_multihost(address, n, int(os.environ["RANK"]), device=device.type)
        try:
            return _data_parallel_rank(int(os.environ["RANK"]), args)
        finally:
            import torch.distributed as dist

            dist.destroy_process_group()
    from eav_tpu_torch import cli  # by its package name, also under ``python -m``

    picklable = argparse.Namespace(**{k: v for k, v in vars(args).items() if k != "fn"})
    return distributed.spawn(cli._data_parallel_rank, n, picklable, device=device.type)[0]


def _data_parallel_rank(rank: int, args) -> int:
    """One rank of ``run --data-parallel N`` (its group joined): the sweep
    over a data mesh of every rank."""
    from eav_tpu_torch.parallel.distributed import rank_device
    from eav_tpu_torch.parallel.mesh import DATA_AXIS, make_mesh

    device = rank_device(args.device)
    mesh = make_mesh(((DATA_AXIS, args.data_parallel),), device.type)
    return _run(args, device, mesh=mesh)


def _run(args, device, devices=None, mesh=None) -> int:
    """The sweep of ``cmd_run`` on ``device``: over the farm's
    ``devices``, or, with a data ``mesh``, as one of its ranks."""
    from eav_tpu_torch.core.config import SweepConfig
    from eav_tpu_torch.core.device import deterministic_algorithms
    from eav_tpu_torch.core.sweep import SweepRunner
    from eav_tpu_torch.train.loop import writes_files
    from eav_tpu_torch.train.pipeline import ModalityPipelines

    if args.deterministic:
        # cuBLAS reads it at the process's first product
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    out = args.out
    os.makedirs(out, exist_ok=True)
    presets = _presets(args)

    def make_pipelines(dev=device):
        return ModalityPipelines(
            data_root=args.data_root,
            cache_dir=args.cache_dir or os.path.join(out, "cache"),
            logits_dir=os.path.join(out, "logits"),
            presets=presets,
            seed=args.seed,
            device=dev,
            deterministic=args.deterministic,
            mesh=mesh,
        )

    pipelines = make_pipelines()
    cfg = SweepConfig(
        subjects=tuple(_parse_subjects(args.subjects)),
        modalities=tuple(args.modalities.split(",")),
        data_root=args.data_root,
        journal_path=os.path.join(out, "journal.jsonl"),
        metrics_path=os.path.join(out, "metrics.jsonl"),
        checkpoint_dir=os.path.join(out, "checkpoints") if args.checkpoint else None,
        resume=not args.no_resume,
        max_retries=args.max_retries,
    )
    agree = lambda fn: fn  # noqa: E731
    if mesh is not None:
        import torch.distributed as dist

        from eav_tpu_torch.parallel.distributed import agreed

        agree = agreed
    runner = SweepRunner(cfg, agree(pipelines.task_fn), writes=writes_files())
    if mesh is not None:  # every rank has read the journal before rank 0 appends to it
        dist.barrier()
    # one setting for the whole run, before any worker starts: the fits
    # inside hold it without toggling it (core/device.py)
    with deterministic_algorithms(args.deterministic):
        if not args.profile or not runner.writes:
            return _run_sweep(args, cfg, runner, pipelines, make_pipelines, devices, agree)
        from eav_tpu_torch.utils.profiling import trace

        with trace(args.profile) as path:
            rc = _run_sweep(args, cfg, runner, pipelines, make_pipelines, devices, agree)
        print(f"[profile] torch.profiler trace written to {path}")
        return rc


def _run_sweep(args, cfg, runner, pipelines, make_pipelines=None, devices=None,
               agree=lambda fn: fn) -> int:
    """The stacked pass, the farm (with the stacked chunks spread over its
    workers' setups) when ``--chip-parallel`` is set, then the serial pass
    over whatever is still pending, with prefetch. ``agree`` wraps each
    group's function (a data-parallel rank's: ``distributed.agreed``)."""
    stacked = [
        (mod, min(args.subject_parallel, cap))
        for mod, cap in _STACK_CAPS.items()
        if mod in cfg.modalities and min(args.subject_parallel, cap) > 1
    ] if args.subject_parallel > 1 else []

    if devices is not None:
        from eav_tpu_torch.parallel.farm import device_workers, on_device

        workers = device_workers(make_pipelines, devices=devices)
        if stacked:
            # each worker's setup runs its slice of the stacked pass on its
            # own device and trainers, then joins the claim loop
            pending_by_mod = {}
            for s, m in runner.pending_tasks():
                pending_by_mod.setdefault(m, []).append(s)
            assign = _partition_stacked_chunks(stacked, pending_by_mod, len(workers))
            for widx, part in enumerate(assign):
                w = workers[widx]

                def stacked_setup(_part=part, _w=w):
                    with on_device(_w.device):
                        for mod, (group, subs) in _part.items():
                            runner.run_batched(
                                mod,
                                lambda ss, m=mod, _p=_w.pipelines: _p.run_stacked(ss, m),
                                group_size=group,
                                prefetch_fn=_w.prefetch_fn,
                                only_subjects=set(subs),
                            )

                workers[widx] = w._replace(setup_fn=stacked_setup)
        timeout = args.farm_timeout_minutes * 60.0 if args.farm_timeout_minutes else None
        runner.run_farmed(workers, verbose=True,
                          exclude_modalities=[m for m, _ in stacked], task_timeout_s=timeout)
    else:
        for mod, group in stacked:
            runner.run_batched(mod, agree(lambda subs, m=mod: pipelines.run_stacked(subs, m)),
                               group_size=group, verbose=runner.writes,
                               prefetch_fn=pipelines.prefetch)
    # everything still pending: the whole sweep in the default mode, or the
    # retries and fusion after a farm
    runner.run(verbose=runner.writes, prefetch_fn=pipelines.prefetch)
    if runner.writes:
        print(json.dumps(runner.aggregate(), indent=2))
    return 0


def format_summary(agg: dict) -> str:
    """A table of the published summary quantities (`README.md:23,31,40`)."""
    lines = [f"{'modality':12s} {'n':>3s} {'mean ACC':>9s} {'std':>6s} {'mean wF1':>9s}"]
    for mod, d in sorted(agg.items()):
        wf1 = (f"{d['mean_weighted_f1']*100:8.1f}%" if d.get("mean_weighted_f1") is not None
               else "      --")
        lines.append(f"{mod:12s} {d['n_subjects']:3d} {d['mean_accuracy']*100:8.1f}% "
                     f"{d['std_accuracy']*100:5.1f}% {wf1}")
    return "\n".join(lines)


def cmd_aggregate(args) -> int:
    from eav_tpu_torch.core.config import SweepConfig
    from eav_tpu_torch.core.sweep import SweepRunner

    cfg = SweepConfig(journal_path=os.path.join(args.out, "journal.jsonl"),
                      metrics_path=os.path.join(args.out, "metrics.jsonl"))
    agg = SweepRunner(cfg, lambda s, m: None).aggregate()
    print(format_summary(agg))
    print(json.dumps(agg, indent=2))
    return 0


def cmd_verify_data(args) -> int:
    """Check every per-subject layout, shape and label invariant the ingest
    relies on before a sweep is launched (``ingest/verify.py``). Exit 0:
    clean (warnings allowed); 1: errors found."""
    from eav_tpu_torch.ingest.verify import verify_data_root

    eeg_cfg = _presets(args)["eeg"].eeg
    reports = verify_data_root(
        args.data_root,
        _parse_subjects(args.subjects),
        modalities=tuple(args.modalities.split(",")),
        eeg_channels=eeg_cfg.channels,
        trial_seconds=eeg_cfg.trial_seconds,
        probe_video=not args.no_probe,
        deep=args.deep,
        verbose=True,
    )
    n_err = sum(len(r.errors) for r in reports)
    n_warn = sum(len(r.warnings) for r in reports)
    print(f"[verify] {len(reports)} subjects: {sum(r.ok for r in reports)} ok, "
          f"{n_err} errors, {n_warn} warnings")
    return 0 if n_err == 0 else 1


def _add_overrides(parser) -> None:
    parser.add_argument("--set", action="append", default=[], metavar="PATH=VALUE",
                        help="field override, e.g. audio.finetune.phases.0.epochs=2 "
                        "or eeg.split.h_idx=40 (repeatable)")
    parser.add_argument("--config", default=None,
                        help="YAML (JSON without PyYAML) file of nested overrides, "
                        "applied before --set")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="eav_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("presets").set_defaults(fn=cmd_presets)

    vd = sub.add_parser("verify-data",
                        help="validate a data root's layout/shapes/labels before sweeping")
    vd.add_argument("--data-root", required=True)
    vd.add_argument("--subjects", default="1-42")
    vd.add_argument("--modalities", default="eeg,audio,vision")
    vd.add_argument("--no-probe", action="store_true",
                    help="skip the first/middle/last video probe decodes per subject "
                    "(needed where there is no video decoder: no libav build, no cv2)")
    vd.add_argument("--deep", action="store_true",
                    help="also walk EVERY Speaking clip's mp4 container header (no decode)")
    _add_overrides(vd)
    vd.set_defaults(fn=cmd_verify_data)

    run = sub.add_parser("run")
    run.add_argument("--data-root", required=True)
    run.add_argument("--subjects", default="1-42")
    run.add_argument("--modalities", default="eeg,audio,vision")
    run.add_argument("--out", default="./runs/sweep")
    run.add_argument("--cache-dir", default=None)
    run.add_argument("--seed", type=int, default=0)
    run.add_argument("--checkpoint", action="store_true")
    run.add_argument("--no-resume", action="store_true")
    run.add_argument("--max-retries", type=int, default=1)
    run.add_argument("--device", default="cuda",
                     help="torch device of the fits (default cuda; raises without a GPU)")
    run.add_argument("--deterministic", action="store_true",
                     help="run the whole sweep under torch.use_deterministic_algorithms")
    run.add_argument("--subject-parallel", type=int, default=1,
                     help="stack up to N subjects of a family into one program "
                     "(capped per family: _STACK_CAPS)")
    run.add_argument("--data-parallel", type=int, default=1,
                     help="N ranks, one card each (gloo ranks with --device cpu): the vision "
                     "fine-tunes split their batches over them; spawned here, or one rank "
                     "a process under torchrun")
    run.add_argument("--chip-parallel", type=int, default=0,
                     help="task farm: N device-bound workers run serial fits "
                     "concurrently, one card each (cuda:0..N-1); N=1 runs the farm "
                     "with one worker; default 0 = plain serial")
    run.add_argument("--farm-timeout-minutes", type=float, default=0.0,
                     help="with --chip-parallel: a task past this deadline is journaled "
                     "failed (note: timeout) and its worker retires; 0 = off")
    run.add_argument("--epochs-per-call", type=int, default=None,
                     help="accepted for JAX command lines; no effect in the port")
    run.add_argument("--epc-target-seconds", type=float, default=None,
                     help="accepted for JAX command lines; no effect in the port")
    _add_overrides(run)
    run.add_argument("--profile", default=None, metavar="LOGDIR",
                     help="wrap the sweep in a torch.profiler trace (Chrome trace in LOGDIR); "
                          "it carries the port's spans: sweep.task, fit.epoch, fit.frozen_cache, "
                          "trainer.train_step and its phases, trainer.evaluate, attention.layout")
    run.set_defaults(fn=cmd_run)

    agg = sub.add_parser("aggregate")
    agg.add_argument("--out", default="./runs/sweep")
    agg.set_defaults(fn=cmd_aggregate)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
