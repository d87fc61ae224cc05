"""Profiling and observability helpers, the port of ``eav_tpu/utils/profiling.py``.

- :func:`fence`: wait for the device that holds (the first tensor of) a
  result; CUDA calls return before the card has finished.
- :class:`Throughput`: a fenced samples/s meter.
- :func:`trace`: a ``torch.profiler`` trace of CPU and CUDA activity around
  a region, written as a Chrome trace (``chrome://tracing``, Perfetto).
- :func:`debug_nans`: raise ``FloatingPointError`` at the first NaN a
  module's forward or a backward produces (JAX's ``jax_debug_nans``).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

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


class Throughput:
    """Steady-state samples/s of a region that ends in a :func:`fence`.

    >>> meter = Throughput()
    >>> with meter.measure(n_samples=batch * steps):
    ...     for _ in range(steps): out = step(...)
    ...     fence(out)
    >>> meter.samples_per_sec
    """

    def __init__(self):
        self.samples_per_sec: Optional[float] = None
        self.wall_clock_s: Optional[float] = None

    @contextlib.contextmanager
    def measure(self, n_samples: int) -> Iterator[None]:
        t0 = time.perf_counter()
        yield
        self.wall_clock_s = time.perf_counter() - t0
        self.samples_per_sec = n_samples / self.wall_clock_s


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
