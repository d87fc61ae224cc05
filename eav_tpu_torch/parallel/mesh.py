"""The device mesh: named axes over the ranks of the process group (the port
of ``eav_tpu/parallel/mesh.py``).

The axes are the JAX package's:

- ``subject``: independent per-subject fine-tunes, a share of the stack a
  rank (``parallel/subject.py``), no communication during the fit;
- ``data``: one fine-tune's batch split over the ranks
  (``Trainer.fit(mesh=)``): the gradient is the global batch's, summed over
  the axis;
- ``model``: the transformer encoders' heads and MLP split over the ranks
  (``parallel/tp.py``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over every rank of
the group (``distributed.init_multihost``). JAX places arrays on a mesh and
XLA inserts the collectives; PyTorch runs one process a rank, so a rank
takes its own rows (``shard_rows``, the counterpart of ``put_sharded`` along
axis 0) and the trainers issue the collectives themselves. ``constrain``,
``shard`` and ``replicated`` are placement hints to XLA's partitioner and
have no counterpart here.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
SUBJECT_AXIS = "subject"


def make_mesh(axes: Sequence[Tuple[str, int]] = ((DATA_AXIS, -1),), device_type: str = "cuda"):
    """A mesh from (axis name, size) pairs over the group's ranks; one size
    may be -1 to take the ranks the others leave (as numpy's reshape).
    ``device_type`` is ``"cuda"`` or ``"cpu"``. The mesh must hold every
    rank: a mesh smaller than the group raises (its other ranks would have
    nothing to compute), as does one larger."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group (distributed.init_multihost)")
    names = tuple(a for a, _ in axes)
    sizes = [s for _, s in axes]
    n = dist.get_world_size()
    if sizes.count(-1) > 1:
        raise ValueError("at most one axis size may be -1")
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1) or 1
        sizes[sizes.index(-1)] = n // known
    total = math.prod(sizes)
    if total > n:
        raise ValueError(f"mesh of {total} devices > {n} available")
    if total < n:
        raise ValueError(f"mesh of {total} devices < the group's {n} ranks: a mesh "
                         "holds every rank")
    return init_device_mesh(device_type, tuple(sizes), mesh_dim_names=names)


def axis_size(mesh, axis: str) -> int:
    """Ranks along ``axis`` (1 without a mesh or without that axis)."""
    return mesh.size(mesh.mesh_dim_names.index(axis)) if has_axis(mesh, axis) else 1


def has_axis(mesh, axis: str) -> bool:
    return mesh is not None and axis in (mesh.mesh_dim_names or ())


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 without it)."""
    return mesh.get_local_rank(axis) if has_axis(mesh, axis) else 0


def axis_group(mesh, axis: str) -> Optional[dist.ProcessGroup]:
    """The process group of this rank's line along ``axis`` (None without a
    mesh or without that axis; a group of one rank for an axis of size 1)."""
    return mesh.get_group(axis) if has_axis(mesh, axis) else None


def share(n: int, parts: int, index: int) -> Tuple[int, int]:
    """(lo, hi) of part ``index`` of ``n`` rows cut into ``parts``
    contiguous parts, the first ``n % parts`` one row longer
    (``torch.tensor_split``'s cut: 5 rows over 2 parts are 3 and 2)."""
    q, r = divmod(n, parts)
    lo = index * q + min(index, r)
    return lo, lo + q + (index < r)


def shard_rows(x, mesh, axis: str = DATA_AXIS):
    """This rank's contiguous rows of ``x`` (a tensor or an array) along
    ``axis``: the counterpart of ``put_sharded(x, mesh, axis)`` along axis 0."""
    lo, hi = share(len(x), axis_size(mesh, axis), axis_index(mesh, axis))
    return x[lo:hi]
