"""The journaled subject x modality sweep, the port of ``eav_tpu/core/sweep.py``
(its serial and batched paths; the farm of ``run_farmed`` waits for
``parallel/farm.py``).

- a per-task journal (JSONL): done/failed state, attempts, wall-clock; a
  new run resumes by skipping completed tasks and retrying failed ones up to
  ``max_retries``;
- the metrics JSONL: one row per finished task (subject, modality,
  accuracy, weighted F1, samples/sec, wall-clock), ``aggregate`` over it;
- each task's artifacts saved under ``checkpoint_dir`` (``core/checkpoint.py``);
- task functions are pluggable, so tests run the machinery on stubs.

The records have the JAX package's keys and values, so either package
resumes or aggregates the other's journal.
"""

from __future__ import annotations

import json
import os
import threading
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from eav_tpu_torch.core.config import SweepConfig


@dataclass
class TaskResult:
    metrics: Dict[str, Any]
    artifacts: Optional[Dict[str, Any]] = None  # e.g. params to checkpoint


TaskFn = Callable[[int, str], TaskResult]  # (subject, modality) -> result


def _read_jsonl(path: str) -> List[dict]:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        lines = [line.strip() for line in f]
    out = []
    for i, line in enumerate(lines):
        if not line:
            continue
        try:
            out.append(json.loads(line))
        except json.JSONDecodeError:
            # a torn final line is an append another process has not
            # finished: not written yet. Corruption anywhere else raises.
            if i == len(lines) - 1:
                break
            raise
    return out


def _append_jsonl(path: str, record: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")


class SweepRunner:
    def __init__(self, cfg: SweepConfig, task_fn: TaskFn):
        self.cfg = cfg
        self.task_fn = task_fn

    def _task_id(self, subject: int, modality: str) -> str:
        return f"subject{subject:02d}_{modality}"

    def journal_state(self) -> Dict[str, dict]:
        """The latest journal record of each task id."""
        state: Dict[str, dict] = {}
        for rec in _read_jsonl(self.cfg.journal_path):
            if "task" in rec:  # event records (the JAX farm's summaries) carry none
                state[rec["task"]] = rec
        return state

    def pending_tasks(self) -> List[Tuple[int, str]]:
        """(subject, modality) of every task not done and not out of
        retries, modality-major in the config's order."""
        state = self.journal_state() if self.cfg.resume else {}
        tasks = []
        for modality in self.cfg.modalities:
            for subject in self.cfg.subjects:
                rec = state.get(self._task_id(subject, modality))
                if rec is None:
                    tasks.append((subject, modality))
                elif rec["status"] == "failed" and rec.get("attempts", 1) <= self.cfg.max_retries:
                    tasks.append((subject, modality))
        return tasks

    def _record(self, tid: str, state: Dict[str, dict], rec: dict,
                metrics: Optional[dict] = None) -> None:
        if metrics is not None:
            _append_jsonl(self.cfg.metrics_path, metrics)
        _append_jsonl(self.cfg.journal_path, rec)
        state[tid] = rec

    def _run_one(self, subject: int, modality: str, state: Dict[str, dict],
                 verbose: bool) -> dict:
        """Run one task and journal its outcome; an exception fails only
        this task."""
        tid = self._task_id(subject, modality)
        attempts = state.get(tid, {}).get("attempts", 0) + 1
        t0 = time.perf_counter()
        try:
            result = self.task_fn(subject, modality)
            wall = time.perf_counter() - t0
            metrics = dict(result.metrics)
            metrics.update(subject=subject, modality=modality, wall_clock_s=round(wall, 3))
            if result.artifacts and self.cfg.checkpoint_dir:
                from eav_tpu_torch.core.checkpoint import save_pytree

                save_pytree(os.path.join(self.cfg.checkpoint_dir, tid), result.artifacts)
            rec = {"task": tid, "status": "done", "attempts": attempts,
                   "wall_clock_s": round(wall, 3), "ts": time.time()}
        except Exception as e:  # noqa: BLE001 — task isolation is the point
            metrics = None
            rec = {"task": tid, "status": "failed", "attempts": attempts,
                   "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc(limit=5), "ts": time.time()}
        self._record(tid, state, rec, metrics)
        if verbose:
            if rec["status"] == "done":
                print(f"[sweep] {tid} done in {rec['wall_clock_s']}s")
            else:
                print(f"[sweep] {tid} FAILED ({rec['error']})")
        return rec

    def run(self, verbose: bool = True, prefetch_fn=None) -> Dict[str, dict]:
        """Run every pending task in order. ``prefetch_fn(subject,
        modality)`` (e.g. ``ModalityPipelines.prefetch``) runs for task N+1
        on a daemon thread while task N runs, and is joined before task N+1
        starts."""
        state = self.journal_state()
        tasks = self.pending_tasks()
        for i, (subject, modality) in enumerate(tasks):
            thread = None
            if prefetch_fn is not None and i + 1 < len(tasks):
                thread = threading.Thread(target=prefetch_fn, args=tasks[i + 1], daemon=True)
                thread.start()
            self._run_one(subject, modality, state, verbose)
            if thread is not None:
                thread.join()
        return state

    def run_batched(self, modality: str, batch_fn, group_size: int = 8,
                    verbose: bool = True, prefetch_fn=None) -> Dict[str, dict]:
        """Run the pending subjects of one modality in groups through
        ``batch_fn(subjects) -> {subject: TaskResult}`` (e.g.
        ``ModalityPipelines.run_stacked``), writing the serial path's records.

        A failing group is bisected: each half runs again on its own, down
        to single subjects, and a single subject that still fails runs the
        serial ``task_fn`` before it is journaled as failed.
        ``prefetch_fn(subject, modality)`` walks group G+1's subjects on a
        daemon thread while group G runs; its failures are printed, not
        raised (the group's own load raises them)."""
        state = self.journal_state()
        pending = [s for s, m in self.pending_tasks() if m == modality]
        groups = [pending[g : g + group_size] for g in range(0, len(pending), group_size)]

        def prefetch_group(subjects):
            for s in subjects:
                try:
                    prefetch_fn(s, modality)
                except Exception as e:  # noqa: BLE001 — prefetch is best-effort
                    print(f"[sweep] prefetch subject{s:02d} {modality} failed ({e})")

        for i, group in enumerate(groups):
            thread = None
            if prefetch_fn is not None and i + 1 < len(groups):
                thread = threading.Thread(target=prefetch_group, args=(groups[i + 1],), daemon=True)
                thread.start()
            self._run_group(modality, batch_fn, group, state, verbose)
            if thread is not None:
                thread.join()
        return state

    def _run_group(self, modality: str, batch_fn, group: List[int],
                   state: Dict[str, dict], verbose: bool) -> None:
        t0 = time.perf_counter()
        try:
            results = batch_fn(group)
            wall = time.perf_counter() - t0
            for s in group:
                tid = self._task_id(s, modality)
                metrics = dict(results[s].metrics)
                metrics.update(subject=s, modality=modality,
                               wall_clock_s=round(wall / len(group), 3))
                rec = {"task": tid, "status": "done",
                       "attempts": state.get(tid, {}).get("attempts", 0) + 1,
                       "wall_clock_s": round(wall / len(group), 3), "ts": time.time()}
                self._record(tid, state, rec, metrics)
            if verbose:
                print(f"[sweep] {modality} subjects {group} done in {wall:.1f}s")
        except Exception as e:  # noqa: BLE001 — task isolation is the point
            if len(group) > 1:
                if verbose:
                    print(f"[sweep] {modality} group {group} failed ({e}); bisecting to isolate")
                mid = len(group) // 2
                self._run_group(modality, batch_fn, group[:mid], state, verbose)
                self._run_group(modality, batch_fn, group[mid:], state, verbose)
                return
            s = group[0]
            tid = self._task_id(s, modality)
            # a stacked program of one subject may still fail where the
            # serial one runs (memory), so the serial task gets its turn
            if verbose:
                print(f"[sweep] {tid} stacked failed ({e}); serial fallback")
            metrics = None
            try:
                t1 = time.perf_counter()
                result = self.task_fn(s, modality)
                wall = time.perf_counter() - t1
                metrics = dict(result.metrics)
                metrics.update(subject=s, modality=modality, wall_clock_s=round(wall, 3))
                rec = {"task": tid, "status": "done",
                       "attempts": state.get(tid, {}).get("attempts", 0) + 1,
                       "wall_clock_s": round(wall, 3),
                       "note": f"serial fallback after stacked failure: {e}", "ts": time.time()}
            except Exception as e2:  # noqa: BLE001 — task isolation
                rec = {"task": tid, "status": "failed",
                       "attempts": state.get(tid, {}).get("attempts", 0) + 1,
                       "error": f"{type(e2).__name__}: {e2}",
                       "stacked_error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc(limit=5), "ts": time.time()}
            self._record(tid, state, rec, metrics)
            if verbose and rec["status"] == "failed":
                print(f"[sweep] {tid} FAILED ({rec['error']})")

    def aggregate(self) -> Dict[str, Dict[str, float]]:
        """Per-modality mean and std of accuracy, and mean weighted F1, over
        subjects (the latest row of each task), the published summary
        quantities (`README.md:23,31,40`)."""
        rows = _read_jsonl(self.cfg.metrics_path)
        by_mod: Dict[str, Dict[str, list]] = {}
        seen = set()
        for r in reversed(rows):  # the latest row of each task wins
            key = (r.get("subject"), r.get("modality"))
            if key in seen or r.get("accuracy") is None:
                continue
            seen.add(key)
            d = by_mod.setdefault(r["modality"], {"accuracy": [], "weighted_f1": []})
            d["accuracy"].append(r["accuracy"])
            if r.get("weighted_f1") is not None:
                d["weighted_f1"].append(r["weighted_f1"])
        return {
            mod: {
                "n_subjects": len(d["accuracy"]),
                "mean_accuracy": float(np.mean(d["accuracy"])),
                "std_accuracy": float(np.std(d["accuracy"])),
                "mean_weighted_f1": float(np.mean(d["weighted_f1"])) if d["weighted_f1"] else None,
            }
            for mod, d in by_mod.items()
        }
