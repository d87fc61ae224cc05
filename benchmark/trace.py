"""The traced run's profile: one unit of the window under ``torch.profiler``
(CPU and CUDA activity), read back from its Chrome trace.

``Profile`` gives what the per-layer metrics read: the stretch's span on the
profiler's clock (the ``bench.unit`` annotation around the unit, which ends
in a fence, so every kernel of the unit ends inside it), every device
activity in it (kernels, copies, sets), the device's busy time as the union
of those intervals, the device operations that took the most time, and the
idle gaps named by the innermost host operation that was running at each
gap's middle. Recording every host operation slows a host-bound unit (the
AST epoch about twice) but not its kernels, so the stretch's busy time
stands for an unprofiled unit's and its span does not. The trace file goes
to ``TMPDIR`` and is deleted once read.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from typing import Dict, List, Tuple

import torch

ANNOTATION = "bench.unit"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10  # entries of each list in the breakdown
NAME_CHARS = 160  # a kernel's name is cut to this many characters in the breakdown


class Stretch:
    """A profiler around one unit: ``with Stretch(device) as s: ...``;
    ``s.read()`` after the window."""

    def __init__(self, device):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)

    def __enter__(self):
        self._prof.__enter__()
        self._mark = torch.profiler.record_function(ANNOTATION)
        self._mark.__enter__()
        return self

    def __exit__(self, *exc):
        self._mark.__exit__(*exc)
        self._prof.__exit__(*exc)
        return False

    def read(self) -> "Profile":
        fd, path = tempfile.mkstemp(prefix="bench-trace-", suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        return Profile(events)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Profile:
    """One stretch's device activity and host operations (microseconds on
    the profiler's clock)."""

    def __init__(self, events: List[dict]):
        timed = [e for e in events if e.get("ph") == "X" and "dur" in e]
        marks = [e for e in timed if e.get("name") == ANNOTATION
                 and e.get("cat") == "user_annotation"]
        if not marks:
            raise RuntimeError(f"the trace holds no {ANNOTATION!r} annotation")
        mark = marks[0]
        self.start, self.end = float(mark["ts"]), float(mark["ts"]) + float(mark["dur"])
        self.device: List[Tuple[str, float, float]] = []  # (name, start, end), clipped to the span
        self.host: List[Tuple[float, float, str]] = []  # the annotating thread's operations
        for e in timed:
            a = float(e["ts"])
            b = a + float(e["dur"])
            if e.get("cat") in DEVICE_CATS:
                a, b = max(a, self.start), min(b, self.end)
                if b > a:
                    self.device.append((e["name"], a, b))
            elif (e.get("cat") in HOST_CATS and e.get("tid") == mark.get("tid")
                  and e.get("pid") == mark.get("pid") and e is not mark):
                self.host.append((a, b, e["name"]))
        self.host.sort(key=lambda h: (h[0], -h[1]))
        self._starts = [a for a, _, _ in self.host]
        self._parent = []  # the innermost operation enclosing each one, or -1
        stack: List[int] = []
        for i, (a, b, _) in enumerate(self.host):
            while stack and self.host[stack[-1]][1] < a:
                stack.pop()
            self._parent.append(stack[-1] if stack else -1)
            stack.append(i)
        self.busy = _union([(a, b) for _, a, b in self.device])

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) * 1e-6

    def kernel_seconds(self, names: Tuple[str, ...]) -> Tuple[float, int]:
        """Device seconds and launches of the kernels whose names hold any of
        ``names``."""
        hits = [(a, b) for n, a, b in self.device if any(k in n for k in names)]
        return sum(b - a for a, b in hits) * 1e-6, len(hits)

    def device_ops(self) -> List[List]:
        """The device operations that took the most time: [[name, seconds]]."""
        total: Dict[str, float] = {}
        for n, a, b in self.device:
            total[n] = total.get(n, 0.0) + (b - a)
        top = sorted(total.items(), key=lambda kv: -kv[1])[:TOP]
        return [[n[:NAME_CHARS], us * 1e-6] for n, us in top]

    def gaps(self) -> List[Tuple[float, float]]:
        """The stretch's intervals with no device activity."""
        out, at = [], self.start
        for a, b in self.busy:
            if a > at:
                out.append((at, a))
            at = max(at, b)
        if self.end > at:
            out.append((at, self.end))
        return out

    def host_at(self, t: float) -> str:
        """The innermost host operation running at ``t`` on the annotating
        thread, else the unit's annotation: the latest operation to start
        before ``t``, or the first of its enclosing ones still running."""
        i = bisect.bisect_right(self._starts, t) - 1
        while i >= 0:
            _, b, name = self.host[i]
            if b >= t:
                return name
            i = self._parent[i]
        return ANNOTATION

    def idle_gaps(self) -> List[List]:
        """Idle seconds by what the host was doing: [[host operation, seconds]],
        the longest first."""
        total: Dict[str, float] = {}
        for a, b in self.gaps():
            name = self.host_at((a + b) / 2)
            total[name] = total.get(name, 0.0) + (b - a)
        top = sorted(total.items(), key=lambda kv: -kv[1])[:TOP]
        return [[n[:NAME_CHARS], us * 1e-6] for n, us in top]
