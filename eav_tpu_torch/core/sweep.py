"""The journaled subject x modality sweep, the port of ``eav_tpu/core/sweep.py``:
the serial path (``run``), the batched one (``run_batched``) and the task
farm over device-bound workers (``run_farmed``, ``parallel/farm.py``).

- a per-task journal (JSONL): done/failed state, attempts, wall-clock; a
  new run resumes by skipping completed tasks and retrying failed ones up to
  ``max_retries``;
- the metrics JSONL: one row per finished task (subject, modality,
  accuracy, weighted F1, samples/sec, wall-clock), ``aggregate`` over it;
- each task's artifacts saved under ``checkpoint_dir`` (``core/checkpoint.py``);
- task functions are pluggable, so tests run the machinery on stubs;
- a runner built with ``writes=False`` (the ranks after the first of a
  data-parallel sweep, ``cli run --data-parallel N``) writes nothing: it
  reads the journal once, when it is built, and keeps its records in
  memory, so that it visits the tasks the writing runner visits, in the
  same order, as long as every task's outcome is the same on every rank
  (``parallel/distributed.agreed``).

The records have the JAX package's keys and values, so either package
resumes or aggregates the other's journal. Every journal and metrics append
and every update of the shared state runs under the runner's log lock: the
farm's workers journal from threads of their own.
"""

from __future__ import annotations

import json
import os
import threading
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from eav_tpu_torch.core.config import SweepConfig
from eav_tpu_torch.utils.profiling import span


@dataclass
class TaskResult:
    metrics: Dict[str, Any]
    artifacts: Optional[Dict[str, Any]] = None  # e.g. params to checkpoint


TaskFn = Callable[[int, str], TaskResult]  # (subject, modality) -> result

# The farm's claim order: the longest family first (the LPT rule), so that
# the last task of a long family does not run alone at the end while every
# other worker idles. The ranks are the JAX package's, from its measured
# per-subject walls: vision > audio > conformer > EEGNet > SCNN; other
# modalities keep their list position among themselves.
_FARM_DURATION_RANK = {
    "vision": 0, "vision_resnet": 1, "audio": 2, "eeg_conformer": 3,
    "eeg": 4, "audio_scnn": 5,
}


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
    def __init__(self, cfg: SweepConfig, task_fn: TaskFn, writes: bool = True):
        self.cfg = cfg
        self.task_fn = task_fn
        self.writes = writes
        # journal and metrics appends and the shared state's updates: the
        # farm runs tasks, and stacked setups, on several threads
        self._log_lock = threading.Lock()
        # a runner that writes nothing keeps its journal here
        self._journal = None if writes else self._read_journal()

    def _read_journal(self) -> Dict[str, dict]:
        state: Dict[str, dict] = {}
        for rec in _read_jsonl(self.cfg.journal_path):
            if "task" in rec:  # event records carry none
                state[rec["task"]] = rec
        return state

    def _task_id(self, subject: int, modality: str) -> str:
        return f"subject{subject:02d}_{modality}"

    def journal_state(self) -> Dict[str, dict]:
        """The latest journal record of each task id, read under the log
        lock (a farm worker's stacked setup reads it while others append)."""
        with self._log_lock:
            return self._read_journal() if self.writes else dict(self._journal)

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
        with self._log_lock:
            if not self.writes:
                self._journal[tid] = rec
            else:
                if metrics is not None:
                    _append_jsonl(self.cfg.metrics_path, metrics)
                _append_jsonl(self.cfg.journal_path, rec)
            state[tid] = rec

    def _attempts(self, tid: str, state: Dict[str, dict]) -> int:
        with self._log_lock:
            return state.get(tid, {}).get("attempts", 0) + 1

    def _run_one(self, subject: int, modality: str, task_fn: TaskFn, state: Dict[str, dict],
                 verbose: bool, extra: Optional[dict] = None) -> dict:
        """Run one task through ``task_fn`` and journal its outcome; an
        exception fails only this task. ``extra`` (the farm's ``device`` and
        ``worker``) joins both records."""
        tid = self._task_id(subject, modality)
        attempts = self._attempts(tid, state)
        t0 = time.perf_counter()
        try:
            with span("sweep.task"):
                result = task_fn(subject, modality)
            wall = time.perf_counter() - t0
            metrics = dict(result.metrics)
            metrics.update(subject=subject, modality=modality, wall_clock_s=round(wall, 3))
            metrics.update(extra or {})
            if result.artifacts and self.cfg.checkpoint_dir and self.writes:
                from eav_tpu_torch.core.checkpoint import save_pytree

                save_pytree(os.path.join(self.cfg.checkpoint_dir, tid), result.artifacts)
            rec = {"task": tid, "status": "done", "attempts": attempts,
                   "wall_clock_s": round(wall, 3), "ts": time.time()}
        except Exception as e:  # noqa: BLE001 — task isolation is the point
            metrics = None
            rec = {"task": tid, "status": "failed", "attempts": attempts,
                   "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc(limit=5), "ts": time.time()}
        rec.update(extra or {})
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
            self._run_one(subject, modality, self.task_fn, state, verbose)
            if thread is not None:
                thread.join()
        return state

    def run_farmed(self, workers: Sequence, verbose: bool = True,
                   exclude_modalities: Sequence[str] = (),
                   task_timeout_s: Optional[float] = None) -> Dict[str, dict]:
        """The task farm: ``len(workers)`` device-bound workers
        (``parallel/farm.DeviceWorker``: ``name``, ``task_fn``, optional
        ``prefetch_fn`` and ``setup_fn``) pull pending (subject, modality)
        tasks concurrently, one fit per device at a time, longest family
        first (``_FARM_DURATION_RANK``). Claims are taken under a lock, so
        each task runs on one worker; both records of a farmed task carry
        ``device`` (the worker's name) and ``worker`` (its index).

        - Each worker claims its next task ahead and prefetches it while the
          current one fits, except when the unclaimed tail is no deeper than
          the worker count (claiming there would pin tail tasks to busy
          workers while free ones starve); a farm of one worker always
          claims ahead.
        - ``setup_fn`` runs on the worker's thread before its first claim
          (the CLI's slice of the stacked pass); its wall time counts as the
          worker's busy time, and a failing setup leaves its tasks pending.
        - ``exclude_modalities`` are driven elsewhere (the CLI's stacked
          families); fusion is always excluded: it reads the other
          modalities' archives, so it runs after them in the caller's
          serial pass.
        - ``task_timeout_s`` (off by default): a task still running at its
          deadline is journaled failed with the note ``timeout``, its
          worker's ahead-claim goes back to the pool and the worker retires
          (its device is presumed wedged; the thread cannot be killed and is
          left as a daemon, and should it finish, its ``done`` record
          supersedes the timeout on resume). A prefetch past the deadline
          retires its worker too, and a setup past four deadlines (a few
          group fits).

        A ``farm_summary`` event (workers, tasks done, makespan, each
        worker's busy seconds) is appended to the metrics file."""
        state = self.journal_state()
        excluded = set(exclude_modalities) | {"fusion"}
        tasks = [t for t in self.pending_tasks() if t[1] not in excluded]
        tasks.sort(key=lambda t: _FARM_DURATION_RANK.get(t[1], 50))  # stable
        claim_cv = threading.Condition()
        pos = [0]  # the next unclaimed task
        inflight = [0]  # tasks running under a worker, and held prefetches
        per_worker = [{"name": getattr(w, "name", str(i)), "tasks": 0, "busy_s": 0.0}
                      for i, w in enumerate(workers)]

        def claim(ahead: bool = False):
            with claim_cv:
                if ahead:
                    if len(workers) > 1 and len(tasks) - pos[0] <= len(workers):
                        return None
                    if pos[0] >= len(tasks):
                        return None
                else:
                    # a free worker stays while tasks are in flight: a worker
                    # that times out returns its ahead-claim to the pool
                    while pos[0] >= len(tasks):
                        if inflight[0] == 0:
                            return None
                        claim_cv.wait(timeout=1.0)
                pos[0] += 1
                return tasks[pos[0] - 1]

        def give_back(task) -> None:
            """Return an ahead-claimed task to the head of the pool (under
            ``claim_cv``)."""
            tasks.insert(pos[0], task)

        def safe_prefetch(fn, subject, modality):
            try:
                fn(subject, modality)
            except Exception as e:  # noqa: BLE001 — prefetch is best-effort
                print(f"[farm] prefetch subject{subject:02d} {modality} failed ({e})")

        def run_deadlined(widx, w, cur) -> bool:
            """Run ``cur`` on worker ``w``; False when it blew the deadline."""
            extra = {"device": getattr(w, "name", str(widx)), "worker": widx}
            if task_timeout_s is None:
                self._run_one(cur[0], cur[1], w.task_fn, state, verbose, extra=extra)
                return True
            helper = threading.Thread(target=self._run_one,
                                      args=(cur[0], cur[1], w.task_fn, state, verbose),
                                      kwargs={"extra": extra}, daemon=True,
                                      name=f"farm-{widx}-task")
            helper.start()
            helper.join(task_timeout_s)
            if not helper.is_alive():
                return True
            tid = self._task_id(*cur)
            rec = {"task": tid, "status": "failed", "attempts": self._attempts(tid, state),
                   "error": f"TimeoutError: task exceeded farm deadline ({task_timeout_s}s); "
                            f"worker {widx} retired",
                   "note": "timeout", "ts": time.time(), **extra}
            self._record(tid, state, rec)
            if verbose:
                print(f"[farm] {tid} TIMED OUT after {task_timeout_s}s on worker {widx}; "
                      "retiring the worker, others drain on")
            return False

        def run_setup(widx, setup) -> bool:
            """Run a worker's ``setup_fn``; False when it blew four task
            deadlines (the worker retires, its tasks stay pending)."""
            done = threading.Event()

            def target():
                try:
                    setup()
                except Exception as e:  # noqa: BLE001 — keep the worker alive
                    print(f"[farm] worker {widx} setup failed ({e}); "
                          "its tasks stay pending for the serial pass")
                finally:
                    done.set()

            if task_timeout_s is None:
                target()
                return True
            threading.Thread(target=target, daemon=True, name=f"farm-{widx}-setup").start()
            if done.wait(task_timeout_s * 4):
                return True
            print(f"[farm] worker {widx} setup exceeded {task_timeout_s * 4:.0f}s; retiring "
                  "the worker, its stacked tasks stay pending for the serial pass")
            return False

        def worker_loop(widx, w):
            setup = getattr(w, "setup_fn", None)
            if setup is not None:
                t0 = time.perf_counter()
                ok = run_setup(widx, setup)
                per_worker[widx]["busy_s"] += time.perf_counter() - t0
                if not ok:
                    return
            cur = claim()
            while cur is not None:
                nxt = claim(ahead=True)
                pf = None
                if getattr(w, "prefetch_fn", None) is not None and nxt is not None:
                    pf = threading.Thread(target=safe_prefetch, args=(w.prefetch_fn, *nxt),
                                          daemon=True)
                    pf.start()
                t0 = time.perf_counter()
                with claim_cv:
                    inflight[0] += 1
                ok = run_deadlined(widx, w, cur)
                # a prefetch joined under a deadline keeps its worker counted
                # in flight: survivors must not exit before a wedged
                # prefetch's ahead-claim comes back to the pool
                hold = ok and pf is not None and task_timeout_s is not None
                with claim_cv:
                    if not ok and nxt is not None:
                        give_back(nxt)
                    if not hold:
                        inflight[0] -= 1
                    claim_cv.notify_all()
                per_worker[widx]["busy_s"] += time.perf_counter() - t0
                if not ok:
                    return
                per_worker[widx]["tasks"] += 1
                if pf is not None:
                    if hold:
                        pf.join(task_timeout_s)
                        stuck = pf.is_alive()
                        with claim_cv:
                            if stuck:
                                give_back(nxt)
                            inflight[0] -= 1
                            claim_cv.notify_all()
                        if stuck:
                            if verbose:
                                print(f"[farm] worker {widx} prefetch exceeded "
                                      f"{task_timeout_s}s; retiring the worker, its "
                                      "ahead-claim returns to the pool")
                            return
                    else:
                        pf.join()
                cur = nxt if nxt is not None else claim()

        t_start = time.perf_counter()
        threads = [threading.Thread(target=worker_loop, args=(i, w), name=f"farm-{i}")
                   for i, w in enumerate(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        makespan = time.perf_counter() - t_start
        summary = {
            "event": "farm_summary",
            "n_workers": len(workers),
            "n_tasks": sum(pw["tasks"] for pw in per_worker),
            "makespan_s": round(makespan, 3),
            "busy_s": [round(pw["busy_s"], 3) for pw in per_worker],
            "workers": [pw["name"] for pw in per_worker],
            "ts": time.time(),
        }
        with self._log_lock:
            if self.writes:
                _append_jsonl(self.cfg.metrics_path, summary)
        if verbose and summary["n_tasks"]:
            busy = sum(pw["busy_s"] for pw in per_worker)
            print(f"[farm] {summary['n_tasks']} tasks over {len(workers)} workers: makespan "
                  f"{makespan:.1f}s, aggregate busy {busy:.1f}s "
                  f"(speedup x{busy / max(makespan, 1e-9):.2f})")
        return state

    def run_batched(self, modality: str, batch_fn, group_size: int = 8,
                    verbose: bool = True, prefetch_fn=None,
                    only_subjects=None) -> Dict[str, dict]:
        """Run the pending subjects of one modality in groups through
        ``batch_fn(subjects) -> {subject: TaskResult}`` (e.g.
        ``ModalityPipelines.run_stacked``), writing the serial path's records.

        A failing group is bisected: each half runs again on its own, down
        to single subjects, and a single subject that still fails runs the
        serial ``task_fn`` before it is journaled as failed.
        ``prefetch_fn(subject, modality)`` walks group G+1's subjects on a
        daemon thread while group G runs; its failures are printed, not
        raised (the group's own load raises them).

        ``only_subjects``: run only these of the pending subjects (in
        pending order, so whole group-sized chunks regroup as they were
        cut). The CLI spreads the stacked pass over farm workers this way;
        callers pass disjoint sets, since batched groups take no claim."""
        state = self.journal_state()
        pending = [s for s, m in self.pending_tasks()
                   if m == modality and (only_subjects is None or s in only_subjects)]
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
            with span("sweep.task"):
                results = batch_fn(group)
            wall = time.perf_counter() - t0
            for s in group:
                tid = self._task_id(s, modality)
                metrics = dict(results[s].metrics)
                metrics.update(subject=s, modality=modality,
                               wall_clock_s=round(wall / len(group), 3))
                rec = {"task": tid, "status": "done", "attempts": self._attempts(tid, state),
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
                with span("sweep.task"):
                    result = self.task_fn(s, modality)
                wall = time.perf_counter() - t1
                metrics = dict(result.metrics)
                metrics.update(subject=s, modality=modality, wall_clock_s=round(wall, 3))
                rec = {"task": tid, "status": "done", "attempts": self._attempts(tid, state),
                       "wall_clock_s": round(wall, 3),
                       "note": f"serial fallback after stacked failure: {e}", "ts": time.time()}
            except Exception as e2:  # noqa: BLE001 — task isolation
                rec = {"task": tid, "status": "failed", "attempts": self._attempts(tid, state),
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
