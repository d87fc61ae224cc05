"""The task farm over devices: one serial fine-tune per card, every card busy
(the port of ``eav_tpu/parallel/farm.py``).

AST and ViT saturate a card alone, so their subjects do not stack
(``cli._STACK_CAPS``); a sweep over several cards runs one subject's fit on
each at a time instead. The subjects' fits are independent, so nothing
passes between cards.

Each worker owns

- a ``torch.device``, passed explicitly: its ``ModalityPipelines`` is built
  for that device (the JAX package binds a thread-local default device
  instead), and its task and prefetch run under ``torch.cuda.device(dev)``
  for a CUDA device, so an allocation that names no device still lands on
  the worker's card;
- its own ``ModalityPipelines``, hence its own trainers and parked
  prefetches, which never cross workers.

Workers pull (subject, modality) tasks from the journal-backed pool of
``core/sweep.SweepRunner.run_farmed`` and prefetch their next task while the
current one fits.
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, NamedTuple, Optional, Sequence

import torch


class DeviceWorker(NamedTuple):
    """One farm worker: ``task_fn`` / ``prefetch_fn`` run on the worker's
    device; ``name`` labels its journal records (``device``).

    ``setup_fn``: work the worker runs on its thread before it joins the
    claim loop (the CLI gives it a slice of the stacked pass).
    ``device`` / ``pipelines``: the worker's device and task provider, for
    callers that compose setup work on the same device and trainers."""

    name: str
    task_fn: Callable  # (subject, modality) -> TaskResult
    prefetch_fn: Optional[Callable] = None  # (subject, modality) -> None
    setup_fn: Optional[Callable] = None  # () -> None
    device: Optional[torch.device] = None
    pipelines: Optional[object] = None


def on_device(dev: Optional[torch.device]):
    """``torch.cuda.device(dev)`` for a CUDA device, else a null context."""
    if dev is not None and dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def device_workers(pipelines_factory: Callable[[torch.device], object],
                   devices: Optional[Sequence] = None,
                   n: Optional[int] = None) -> List[DeviceWorker]:
    """One worker per device. ``pipelines_factory(device)`` returns a fresh
    task provider for that device (``task_fn(subject, modality)``, and
    optionally ``prefetch(subject, modality)``; the CLI passes a
    ``ModalityPipelines`` constructor); it is called once per worker.

    ``devices``: explicit devices (the tests pass ``[torch.device("cpu")] *
    2``); by default ``cuda:0`` .. ``cuda:n-1`` (every visible card when
    ``n`` is None). Raises when fewer cards are visible; never falls back to
    the CPU."""
    if devices is None:
        visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = visible if n is None else n
        if n < 1 or visible < n:
            raise RuntimeError(f"the farm needs {max(n, 1)} CUDA devices, {visible} visible")
        devices = [torch.device("cuda", i) for i in range(n)]
    workers: List[DeviceWorker] = []
    for dev in (torch.device(d) for d in devices):
        pipelines = pipelines_factory(dev)

        def task_fn(subject, modality, _p=pipelines, _d=dev):
            with on_device(_d):
                return _p.task_fn(subject, modality)

        prefetch = getattr(pipelines, "prefetch", None)
        prefetch_fn = None
        if prefetch is not None:
            def prefetch_fn(subject, modality, _pf=prefetch, _d=dev):
                with on_device(_d):
                    _pf(subject, modality)

        workers.append(DeviceWorker(str(dev), task_fn, prefetch_fn, device=dev,
                                    pipelines=pipelines))
    return workers
