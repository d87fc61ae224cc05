"""What the readers of the port's own spans share
(``benchmark/metrics/layout_copy_pct.extract.py``, ``graph_replay_pct.*``).

The port names its layers with spans (``eav_tpu_torch/utils/profiling.span``):
``torch.profiler.record_function`` ranges, which the traced run's profile
keeps among the annotating thread's host operations (``trace.Profile.host``,
on the profiler's clock), and for some of them a pair of CUDA events on the
current stream, handed over once by the port's ``take_spans``. A span opens
only while a profiler runs, so every span read here comes from the profiled
unit. A program without spans reads None in every metric, and so does a
run without device activity (the CPU).

Besides the numbers, the first reading of a run notes (the info line's
``notes``) each span's count on the annotating thread, the device-timed
spans' counts and milliseconds with the count dropped past the port's bound,
and the profiled unit's idle seconds by the port span the annotating thread
was in.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional, Tuple

TRAIN_STEP = "trainer.train_step"
LAYOUT = "attention.layout"
PREFIXES = ("trainer.", "fit.", "attention.", "sweep.")  # the port's span names
# the spans an idle interval is charged to, innermost first: the step's
# phases, then the rest of the step, then the evaluation
PHASES = ("trainer.forward", "trainer.backward", "trainer.optimizer", "trainer.maxnorm",
          TRAIN_STEP, "trainer.evaluate")
OUTSIDE = "outside any port span"

Interval = Tuple[float, float]


def _union(intervals: List[Interval]) -> List[Interval]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _subtract(gaps: List[Interval], spans: List[Interval]) -> List[Interval]:
    """The parts of ``gaps`` outside ``spans``, both sorted and disjoint."""
    out, j = [], 0
    for c, d in gaps:
        while j < len(spans) and spans[j][1] <= c:
            j += 1
        at, k = c, j
        while k < len(spans) and spans[k][0] < d:
            if spans[k][0] > at:
                out.append((at, spans[k][0]))
            at = max(at, spans[k][1])
            k += 1
        if d > at:
            out.append((at, d))
    return out


def host_spans(profile, name: str) -> List[Interval]:
    """The annotating thread's spans named ``name``: [(start, end)] in
    microseconds on the profiler's clock."""
    return [(a, b) for a, b, n in profile.host if n == name]


def idle_split(profile) -> Dict[str, float]:
    """The profiled unit's idle microseconds by the innermost of ``PHASES``
    that the annotating thread was in, and ``OUTSIDE`` them all; the values
    sum to the unit's idle time."""
    rest, split = profile.gaps(), {}
    for name in PHASES:
        left = _subtract(rest, _union(host_spans(profile, name)))
        split[name] = sum(b - a for a, b in rest) - sum(b - a for a, b in left)
        rest = left
    split[OUTSIDE] = sum(b - a for a, b in rest)
    return split


def _device_spans() -> Optional[Tuple[List[Tuple[str, float]], int]]:
    """The port's device-timed spans, or None where the port has no store."""
    try:
        from eav_tpu_torch.utils.profiling import take_spans
    except ImportError:
        return None
    return take_spans()


def reading(run) -> dict:
    """What a run's port spans give, taken once a run (the store empties as
    it is read) and noted with the first reading: ``device`` [(name, ms)]
    or None, ``dropped``, ``host`` the annotating thread's counts by name,
    ``split`` the idle microseconds by span (``idle_split``)."""
    cached = vars(run).get("_port_spans")
    if cached is not None:
        return cached
    taken = _device_spans()
    p = run.profile
    out = {"device": None if taken is None else taken[0],
           "dropped": 0 if taken is None else taken[1],
           "host": Counter(n for _, _, n in p.host if n.startswith(PREFIXES)) if p else Counter(),
           "split": idle_split(p) if p is not None and p.busy_s > 0 else {}}
    vars(run)["_port_spans"] = out
    if out["host"]:
        run.note("port spans on the annotating thread: "
                 + ", ".join(f"{n} {c}" for n, c in sorted(out["host"].items())))
    if out["device"]:
        by = Counter(n for n, _ in out["device"])
        ms = {n: sum(v for m, v in out["device"] if m == n) for n in by}
        run.note("device-timed port spans: "
                 + ", ".join(f"{n} {by[n]} ({ms[n]:.3f} ms)" for n in sorted(by))
                 + f"; dropped {out['dropped']}")
    if out["host"] and out["split"]:
        run.note("idle s by port span: "
                 + ", ".join(f"{n} {us * 1e-6:.4f}" for n, us in out["split"].items() if us > 0)
                 + f"; all idle {sum(out['split'].values()) * 1e-6:.4f}")
    return out


def device_ms(run, name: str) -> List[float]:
    """The device ms of each device-timed span ``name`` (event to event)."""
    spans = reading(run)["device"] or []
    return [ms for n, ms in spans if n == name]


def share_of_busy_pct(run, name: str) -> Optional[float]:
    """The device ms of all spans ``name`` over the profiled unit's busy
    time (the union of its kernels, copies and sets), as a share."""
    p = run.profile
    values = device_ms(run, name)
    if p is None or p.busy_s <= 0 or not values:
        return None
    return 100.0 * sum(values) * 1e-3 / p.busy_s
