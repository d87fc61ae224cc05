"""Profiling and observability helpers, the port of ``eav_tpu/utils/profiling.py``.

- :func:`fence`: wait for the device that holds (the first tensor of) a
  result; CUDA calls return before the card has finished.
- :func:`span`: a named span of the port's own (the trainer's phases,
  attention's layout copies), on the profiler's clock while a
  ``torch.profiler`` runs and nothing but one flag check otherwise; with
  ``device=True`` also timed on the card by a pair of CUDA events, read
  back by :func:`take_spans`.
- :func:`trace`: a ``torch.profiler`` trace of CPU and CUDA activity around
  a region, written as a Chrome trace (``chrome://tracing``, Perfetto); it
  carries the port's spans.
- :func:`debug_nans`: raise ``FloatingPointError`` at the first NaN a
  module's forward or a backward produces (JAX's ``jax_debug_nans``).
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Iterator, List, Tuple

import torch
from torch.utils._pytree import tree_leaves


def fence(x) -> None:
    """Synchronise the device of the first tensor in ``x`` (a tensor or a
    tree of them); CPU tensors, arrays and empty trees need no fence."""
    for leaf in tree_leaves(x):
        if isinstance(leaf, torch.Tensor):
            if leaf.device.type == "cuda":
                torch.cuda.synchronize(leaf.device)
            return


SPAN_CAPACITY = 65536  # device-timed spans kept until ``take_spans``; later ones are counted
# the profiler's flag, per thread: the autograd engine's threads take it from
# the thread that runs the backward, threads started by the program do not
_profiler_enabled = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()  # what ``span`` returns with no profiler running


class SpanStore:
    """Device-timed spans, (name, entry event, exit event) in the order they
    closed, up to ``capacity``; spans past it are dropped and counted. Spans
    close on the caller's thread and on the autograd engine's, hence the
    lock."""

    def __init__(self, capacity: int = SPAN_CAPACITY):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._spans: list = []
        self._dropped = 0

    def add(self, name: str, start, end) -> None:
        with self._lock:
            if len(self._spans) < self.capacity:
                self._spans.append((name, start, end))
            else:
                self._dropped += 1

    def take(self) -> Tuple[List[Tuple[str, float]], int]:
        """([(name, ms from the entry event to the exit event)], spans
        dropped), then the store is empty. Read after a fence: an event the
        stream has not reached raises."""
        with self._lock:
            spans, dropped = self._spans, self._dropped
            self._spans, self._dropped = [], 0
        return [(name, a.elapsed_time(b)) for name, a, b in spans], dropped


_STORE = SpanStore()


class _Span:
    """An open span: a ``record_function`` range and, when ``timed`` on a
    CUDA stream that is not capturing a graph, a pair of timing events
    recorded on the current stream at entry and exit."""

    __slots__ = ("name", "_range", "_events")

    def __init__(self, name: str, timed: bool):
        self.name = name
        self._range = torch.profiler.record_function(name)
        self._events = None
        if timed and torch.cuda.is_initialized() and not torch.cuda.is_current_stream_capturing():
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))

    def __enter__(self) -> None:
        self._range.__enter__()
        if self._events is not None:
            self._events[0].record()

    def __exit__(self, *exc) -> bool:
        if self._events is not None:
            self._events[1].record()
            _STORE.add(self.name, *self._events)
        self._range.__exit__(*exc)
        return False


def span(name: str, device: bool = False):
    """A context manager naming the block ``name`` in a ``torch.profiler``
    trace: a ``record_function`` range (a ``user_annotation`` on the
    profiler's clock, nested under the caller's span, on the thread that
    runs it). With ``device`` and a CUDA current stream that is not
    capturing a graph, the block is also timed on that stream by two CUDA
    events, kept for :func:`take_spans` (event to event: any wait of the
    stream inside the block counts). With no profiler running it costs one
    flag check: no range, no event, no allocation. Nothing inside the block
    is moved, fenced or copied."""
    if not _profiler_enabled():
        return _OFF
    return _Span(name, device)


def take_spans() -> Tuple[List[Tuple[str, float]], int]:
    """The device-timed spans closed since the last call: ([(name, device
    ms)], the count dropped past ``SPAN_CAPACITY``); clears them. Read after
    a fence."""
    return _STORE.take()


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[str]:
    """Profile the block (CPU ops, and CUDA kernels when a card is visible)
    and write ``<logdir>/trace-<pid>.json``, a Chrome trace; yields that path."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace-{os.getpid()}.json")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)


def _non_finite_output(module, _args, output) -> None:
    for t in tree_leaves(output):
        if (isinstance(t, torch.Tensor) and t.is_floating_point()
                and not torch._C._functorch.is_functorch_wrapped_tensor(t)
                and not bool(torch.isfinite(t).all())):
            raise FloatingPointError(
                f"non-finite value in the output of {type(module).__name__}.forward")


@contextlib.contextmanager
def debug_nans(enable: bool = True) -> Iterator[None]:
    """With ``enable``, the block raises ``FloatingPointError`` at the first
    non-finite output of any module's forward (a forward hook on every
    module) and at the first NaN a backward function returns
    (``torch.autograd.detect_anomaly(check_nan=True)``). Slow: for finding
    a fault, never on a measured path. The forward check skips tensors under
    ``torch.func`` transforms (a stacked fit's), whose values it cannot
    read. The hook and the anomaly mode are gone after the block."""
    if not enable:
        yield
        return
    handle = torch.nn.modules.module.register_module_forward_hook(_non_finite_output)
    try:
        with torch.autograd.detect_anomaly(check_nan=True):
            yield
    except RuntimeError as e:
        if "nan values" in str(e):
            raise FloatingPointError(str(e)) from e
        raise
    finally:
        handle.remove()
