"""A measured sweep replayed through the port's task farm on N workers, the
counterpart of the JAX package's ``scripts/farm_makespan.py``:

    python -m eav_tpu_torch.scripts.farm_makespan --metrics METRICS.jsonl \\
        [--workers 8] [--scale 0.02]

A projection, not a measurement: the makespan the farm's scheduler
(``SweepRunner.run_farmed``: the longest family first, the ahead-claims, the
starvation guard) would give N cards, if each task took the wall time one
card measured for it. ``--metrics`` names the ``metrics.jsonl`` of a sweep
measured on the card (``run_production_sweep``); it has no default, because
the repo's ``docs/results/*.jsonl`` are the JAX package's TPU journals.

``load_walls`` reads each serial task's wall, rebuilds each stacked group's
wall from its rows' shares, and lists fusion's walls. The replay sleeps
each task's wall times ``--scale`` on N worker threads, as ``cli run
--subject-parallel S --chip-parallel N`` runs a sweep: the stacked groups
are dealt round-robin to the workers' setups (``cli._partition_stacked_chunks``;
one group of 42 EEG subjects is worker 0's setup), the serial tasks are
farmed, and fusion follows serially after the farm (the port has no
fusion program to compile ahead, so there is nothing to overlap). It
prints the journal's totals, then the projected makespan against the
perfect spread of the same work (its lower bound), each worker's busy
minutes and the projected total with fusion, against the one card's
journaled total. Host-only: it touches no device.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import tempfile
import time
from typing import Dict, List, Tuple


def load_walls(metrics_path: str) -> Tuple[Dict[Tuple[int, str], float], List[float], List[float]]:
    """(serial walls by (subject, modality), stacked group walls, fusion
    walls) from a sweep's ``metrics.jsonl`` (the JAX script's rules).

    A serial row carries its task's wall. A stacked row (``group_size``
    set) carries its share of the group's wall, identical across the group,
    so identical (modality, share, size) rows make row count / size groups
    of share x size seconds each. Rows without an accuracy (the farm's
    summary, failures) are skipped."""
    serial: Dict[Tuple[int, str], float] = {}
    stacked_rows: Dict[Tuple[str, float, int], int] = {}
    fusion: List[float] = []
    with open(metrics_path) as f:
        for line in f:
            r = json.loads(line)
            if r.get("accuracy") is None or "modality" not in r:
                continue
            if r["modality"] == "fusion":
                fusion.append(r["wall_clock_s"])
            elif r.get("group_size"):
                k = (r["modality"], r["wall_clock_s"], r["group_size"])
                stacked_rows[k] = stacked_rows.get(k, 0) + 1
            else:
                serial[(r["subject"], r["modality"])] = r["wall_clock_s"]
    groups = []
    for (_, share, g), n_rows in stacked_rows.items():
        groups.extend([share * g] * max(1, round(n_rows / g)))
    return serial, groups, fusion


class SimWorker:
    """A farm worker whose task sleeps the task's measured wall, scaled."""

    def __init__(self, i: int, task_fn, setup_fn=None):
        self.name = f"simcard{i}"
        self.prefetch_fn = None
        self.task_fn = task_fn
        self.setup_fn = setup_fn


def replay(serial: Dict[Tuple[int, str], float], groups: List[float], workers: int,
           scale: float) -> dict:
    """The farm over ``serial``'s tasks with ``groups`` dealt to the
    workers' setups -> (makespan s, busy s a worker, setup s a worker, the
    tasks done), in the measured walls' seconds."""
    from eav_tpu_torch.core.config import SweepConfig
    from eav_tpu_torch.core.sweep import SweepRunner, TaskResult

    setup = [0.0] * workers
    for j, wall in enumerate(groups):
        setup[j % max(min(workers, len(groups)), 1)] += wall

    def task_fn(subject, modality):
        time.sleep(serial[(subject, modality)] * scale)
        return TaskResult(metrics={"accuracy": 0.0})

    def setup_fn(wall):
        return (lambda: time.sleep(wall * scale)) if wall else None

    with tempfile.TemporaryDirectory() as td:
        cfg = SweepConfig(subjects=tuple(sorted({s for s, _ in serial})),
                          modalities=tuple(sorted({m for _, m in serial})),
                          journal_path=os.path.join(td, "journal.jsonl"),
                          metrics_path=os.path.join(td, "metrics.jsonl"))
        runner = SweepRunner(cfg, task_fn)
        t0 = time.perf_counter()
        state = runner.run_farmed([SimWorker(i, task_fn, setup_fn(setup[i]))
                                   for i in range(workers)], verbose=False)
        wall = time.perf_counter() - t0
        with open(cfg.metrics_path) as f:
            summary = [json.loads(line) for line in f if "farm_summary" in line][-1]
    return {"makespan_s": wall / scale, "busy_s": [b / scale for b in summary["busy_s"]],
            "setup_s": setup, "done": sorted(t for t, r in state.items()
                                             if r["status"] == "done")}


def project(metrics_path: str, workers: int = 8, scale: float = 0.02) -> list:
    """The journal's totals and the projection -> the printed lines."""
    serial, groups, fusion = load_walls(metrics_path)
    per_mod: Dict[str, float] = collections.defaultdict(float)
    for (_, m), wall in serial.items():
        per_mod[m] += wall
    serial_s, stacked_s, fusion_s = sum(serial.values()), sum(groups), sum(fusion)
    single = serial_s + stacked_s + fusion_s
    lines = [{"tasks": len(serial), "subjects": len({s for s, _ in serial}),
              "serial_policy_seconds": {m: round(v, 3) for m, v in per_mod.items()},
              "stacked_seconds": round(stacked_s, 3),
              "stacked_group_walls_s": [round(w, 3) for w in groups],
              "fusion_seconds": round(fusion_s, 3),
              "journaled_single_card_total_min": round(single / 60.0, 3),
              "metrics": metrics_path}]
    print(json.dumps(lines[-1]), flush=True)
    r = replay(serial, groups, workers, scale)
    lower = (serial_s + stacked_s) / workers
    total = r["makespan_s"] + fusion_s
    lines.append({
        "metric": "farm_makespan_projection",
        "projection": f"the farm's schedule on {workers} cards of the measured task walls",
        "n_workers": workers,
        "scale": scale,
        "tasks_done": len(r["done"]),
        "farmed_makespan_min": round(r["makespan_s"] / 60.0, 3),
        "farmed_lower_bound_min": round(lower / 60.0, 3),
        "schedule_efficiency": round(lower / r["makespan_s"], 3),
        "per_worker_busy_min": [round(b / 60.0, 3) for b in r["busy_s"]],
        "stacked_setup_min": [round(w / 60.0, 3) for w in r["setup_s"]],
        "fusion_tail_min": round(fusion_s / 60.0, 3),
        "projected_total_min": round(total / 60.0, 3),
        "journaled_single_card_total_min": round(single / 60.0, 3),
        "speedup_vs_journaled": round(single / total, 3),
    })
    print(json.dumps(lines[-1]), flush=True)
    return lines


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--metrics", required=True,
                    help="metrics.jsonl of a sweep measured on the card")
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--scale", type=float, default=0.02,
                    help="sleep = measured wall x scale")
    args = ap.parse_args(argv)
    return project(args.metrics, args.workers, args.scale)


if __name__ == "__main__":
    main()
