"""Partition model: how a global array is placed over the workers.

PyTorch counterpart of ``pylops_mpi_tpu/parallel/partition.py`` (the
reference's placement policies, ``pylops_mpi/DistributedArray.py:26-71``):

- ``Partition.BROADCAST`` — every worker holds the whole array.
- ``Partition.UNSAFE_BROADCAST`` — kept for API parity; identical to
  ``BROADCAST`` here.
- ``Partition.SCATTER`` — split along one axis with the balanced
  remainder rule: the first ``dim % P`` shards get ``ceil(dim/P)`` rows,
  the rest ``floor(dim/P)``.
"""

from __future__ import annotations

from enum import Enum
from typing import Tuple

__all__ = ["Partition", "local_split"]


class Partition(Enum):
    ALL = "All"            # alias kept out of public docs
    BROADCAST = "Broadcast"
    UNSAFE_BROADCAST = "UnsafeBroadcast"
    SCATTER = "Scatter"


def local_split(global_shape: Tuple[int, ...], n_shards: int,
                partition: Partition, axis: int) -> Tuple[Tuple[int, ...], ...]:
    """Per-shard logical shapes (ref ``DistributedArray.py:42-71``).

    For ``SCATTER``, dimension ``axis`` is split into ``n_shards`` pieces
    with the balanced remainder rule; all other dims are unchanged. For
    broadcast partitions every shard sees the full global shape.
    """
    if partition in (Partition.BROADCAST, Partition.UNSAFE_BROADCAST):
        return tuple(tuple(global_shape) for _ in range(n_shards))
    dim = global_shape[axis]
    base, rem = divmod(dim, n_shards)
    sizes = [base + 1 if i < rem else base for i in range(n_shards)]
    shapes = []
    for s in sizes:
        shp = list(global_shape)
        shp[axis] = s
        shapes.append(tuple(shp))
    return tuple(shapes)
