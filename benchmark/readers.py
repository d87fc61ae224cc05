"""What the metric readers share (``benchmark/metrics/<name>.py``). Each
returns None where it finds nothing to read: a share of a peak or a
roofline is never 0 for want of a reading."""

from __future__ import annotations

import math
import statistics
from typing import Optional, Tuple

from benchmark import yardstick

# the names the port's flash kernels carry in a device trace
FLASH = {"fwd": "flash_fwd", "dkv": "flash_dkv", "dq": "flash_dq"}


def training(unit: dict) -> bool:
    return unit["train_samples"] > 0


def per_second(run, train: bool) -> Optional[float]:
    """Samples of the window's whole units over the window: trained samples
    (``train``) or samples passed forward in units that train nothing."""
    if not run.units or any(training(u) != train for u in run.units):
        return None
    key = "train_samples" if train else "eval_samples"
    return sum(u[key] for u in run.units) / run.window_s


def mfu(run, train: bool) -> Optional[float]:
    """The analytic FLOPs of the window's unprofiled units over their time,
    as a share of the card's bf16 peak."""
    units = [u for u in run.steady_units() if training(u) == train]
    if run.peaks is None or not units or len(units) != len(run.steady_units()):
        return None
    return 100.0 * sum(u["flops"] for u in units) / sum(u["seconds"] for u in units) \
        / run.peaks["bfloat16"]


def span_ms(run, name: str):
    """Host ms of each call ``name`` in the unprofiled units."""
    steady = {i for i, u in enumerate(run.units) if not u.get("profiled")}
    return [(t1 - t0) * 1e3 for n, u, t0, t1 in run.spans if n == name and u in steady]


def event_ms(run, name: str):
    """CUDA-event ms of each call ``name`` in the unprofiled units."""
    steady = {i for i, u in enumerate(run.units) if not u.get("profiled")}
    return [ms for n, u, ms in run.events_ms if n == name and u in steady]


def median(values) -> Optional[float]:
    return statistics.median(values) if values else None


def p95(values) -> Optional[float]:
    """The nearest-rank 95th percentile."""
    if not values:
        return None
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


def profiled_unit(run) -> Optional[dict]:
    return next((u for u in run.units if u.get("profiled")), None)


def idle_pct(run, train: bool) -> Optional[float]:
    """The share of an unprofiled unit's time in which the device is idle:
    1 - the profiled unit's device busy time (the union of its kernels,
    copies and sets, which the profiler does not slow) over the median
    host-clock time of the unprofiled units, which do the same work."""
    p, unit, steady = run.profile, profiled_unit(run), run.steady_units()
    if p is None or unit is None or not steady or training(unit) != train or p.busy_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / statistics.median(u["seconds"] for u in steady))


def flash_roofline(run, kernels: Tuple[str, ...]) -> Optional[float]:
    """The least time of the profiled unit's attention work (from the
    model's shapes, ``yardstick.attention_work``) for ``kernels`` (keys of
    ``FLASH``) over the device time of those kernels in the stretch. Notes
    the launches the port's counters saw against the calls expected."""
    p, unit = run.profile, profiled_unit(run)
    if p is None or run.peaks is None or unit is None:
        return None
    seconds, launches = p.kernel_seconds(tuple(FLASH[k] for k in kernels))
    if launches == 0:
        return None
    least, expected = 0.0, {k: 0 for k in kernels}
    for kind, bh, t, d, calls in unit["attention"]:
        if kind in kernels:
            flop, nbytes = yardstick.attention_work(kind, bh, t, d)
            least += calls * yardstick.least_seconds(flop, nbytes, run.peaks)
            expected[kind] += calls
    for k in kernels:
        counted = run.counters.get(FLASH[k])
        run.note(f"{FLASH[k]}: {counted} launches counted, {expected[k]} calls expected"
                 + ("" if counted == expected[k] else " (differ)"))
    return 100.0 * least / seconds
