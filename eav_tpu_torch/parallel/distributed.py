"""The multi-process seam (the port of ``eav_tpu/parallel/distributed.py``),
and the helpers that start and coordinate ranks.

The JAX package needs a distributed runtime only across hosts (XLA's
collectives span the chips of one slice). PyTorch needs one for any use of
several cards: one process a card, joined in a ``torch.distributed`` process
group. ``init_multihost`` forms that group from a coordinator address (an
argument or ``EAV_TPU_COORDINATOR``): NCCL for cards, gloo for the CPU (and
gloo on cards when the caller asks, which lets two ranks share one card,
as NCCL does not). Without a coordinator it returns False and touches
nothing, as the JAX package's does.

``spawn`` runs a function on N ranks in spawned processes (the CLI's
``--data-parallel N``, the dry run and the tests use it); ``agreed`` makes
a function's outcome the same on every rank, so that a sweep's task that
fails on one rank fails, and is retried, on all of them.
"""

from __future__ import annotations

import functools
import os
import queue as queue_mod
import socket
import time
import traceback
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist


def _rank_card(device: torch.device, process_id: int) -> torch.device:
    """The card of a rank that asked for ``cuda`` without an index: its
    ``LOCAL_RANK`` (torchrun's) or its process id, modulo the visible cards."""
    if device.type != "cuda" or device.index is not None:
        return device
    local = int(os.environ.get("LOCAL_RANK", process_id))
    return torch.device("cuda", local % torch.cuda.device_count())


def init_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device="cuda",
    backend: Optional[str] = None,
) -> bool:
    """Join this process to the process group when a coordinator is named
    (``coordinator_address``, else ``EAV_TPU_COORDINATOR``: ``host:port`` or
    a ``torch.distributed`` init URL). Returns True then, False without a
    coordinator (nothing is touched).

    ``num_processes`` / ``process_id`` default to ``WORLD_SIZE`` / ``RANK``
    (torchrun's variables). ``backend`` defaults to NCCL for a CUDA
    ``device`` and gloo otherwise. A CUDA rank's card becomes the current
    device: ``device``'s index, else ``LOCAL_RANK`` (or the process id)
    modulo the visible cards."""
    coordinator_address = coordinator_address or os.environ.get("EAV_TPU_COORDINATOR")
    if coordinator_address is None:
        return False
    if num_processes is None:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None:
        process_id = int(os.environ["RANK"])
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(_rank_card(dev, process_id))
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                            init_method=url, world_size=num_processes, rank=process_id)
    return True


def global_mesh_axes():
    """Recommended axis layout once multi-host: subjects over DCN (zero
    inter-host traffic), data/model over ICI within a slice."""
    return (("subject", "dcn"), ("data", "ici"), ("model", "ici"))


def rank_device(device="cuda") -> torch.device:
    """The device this rank computes on: its current card for ``cuda``
    without an index (``init_multihost`` set it), else ``device``."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, nprocs, address, device, backend, results, args) -> None:
    """A spawned rank: join the group, run ``fn(rank, *args)``, put
    (rank, ok, result or traceback) on ``results``, leave the group."""
    try:
        init_multihost(address, nprocs, rank, device=device, backend=backend)
        results.put((rank, True, fn(rank, *args)))
    except Exception:  # noqa: BLE001 — reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, nprocs: int, *args, device="cuda", backend: Optional[str] = None,
          timeout_s: float = 3600.0) -> List[Any]:
    """``[fn(rank, *args) for rank in range(nprocs)]``, each call in a
    spawned process that joined an ``nprocs``-rank group over
    ``127.0.0.1`` (``init_multihost``: ``device`` and ``backend`` as
    there). ``fn`` and ``args`` are pickled: ``fn`` must be importable.
    The first rank to fail (or to die, or the deadline) raises here with
    its traceback, and every rank still running is terminated."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    address = f"127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, rank, nprocs, address, str(device), backend, results, args))
             for rank in range(nprocs)]
    for p in procs:
        p.start()
    out: dict = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(out) < nprocs:  # drain the queue before any join
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} died (exit code "
                                       f"{procs[dead[0]].exitcode}) without a result")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{nprocs} ranks did not finish in {timeout_s} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
    finally:
        for p in procs:
            p.join(timeout=30.0 if len(out) == nprocs else 0.0)
            if p.is_alive():
                p.terminate()
                p.join()
    return [out[r] for r in range(nprocs)]


def agreed(fn: Callable, group=None) -> Callable:
    """``fn`` with one outcome on every rank of ``group``: after the call,
    the ranks exchange whether it raised; if it raised on any rank it raises
    on every rank (its own exception where it raised, else naming the ranks
    that did), else each rank returns its own result. Every rank must call
    it the same number of times, in the same order."""

    @functools.wraps(fn)
    def call(*args, **kwargs):
        try:
            out, err = fn(*args, **kwargs), None
        except Exception as e:  # noqa: BLE001 — re-raised below, on every rank
            out, err = e, f"{type(e).__name__}: {e}"
        errors: List[Optional[str]] = [None] * dist.get_world_size(group)
        dist.all_gather_object(errors, err, group=group)
        if err is not None:
            raise out
        failed = [f"rank {r}: {e}" for r, e in enumerate(errors) if e is not None]
        if failed:
            raise RuntimeError("failed on another rank: " + "; ".join(failed))
        return out

    return call
