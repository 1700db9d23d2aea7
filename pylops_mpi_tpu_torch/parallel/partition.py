"""Partition model: how a global array is placed over the workers.

PyTorch counterpart of ``pylops_mpi_tpu/parallel/partition.py`` (the
reference's placement policies, ``pylops_mpi/DistributedArray.py:26-71``):

- ``Partition.BROADCAST`` — every worker holds the whole array.
- ``Partition.UNSAFE_BROADCAST`` — kept for API parity; identical to
  ``BROADCAST`` here.
- ``Partition.SCATTER`` — split along one axis with the balanced
  remainder rule: the first ``dim % P`` shards get ``ceil(dim/P)`` rows,
  the rest ``floor(dim/P)``.

Ragged splits travel between ranks padded to the largest shard (NCCL
moves equal sizes only): :func:`padded_shard_size`, :func:`pad_index_map`
and :func:`unpad_index_map` describe that padded layout.
"""

from __future__ import annotations

from enum import Enum
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ["Partition", "local_split", "shard_offsets", "padded_shard_size",
           "pad_index_map", "unpad_index_map", "flat_outer_shapes"]


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


def shard_offsets(local_sizes: Sequence[int]) -> Tuple[int, ...]:
    """Exclusive prefix sum of per-shard sizes along the partition axis."""
    return tuple(int(x) for x in
                 np.concatenate([[0], np.cumsum(local_sizes)[:-1]]))


def padded_shard_size(local_sizes: Sequence[int]) -> int:
    """Physical (equal) per-shard size: pad-to-max."""
    return int(max(local_sizes)) if len(local_sizes) else 0


def pad_index_map(local_sizes: Sequence[int],
                  s_phys: Optional[int] = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Gather map for logical → padded-physical along the partition
    axis: ``(src, valid)`` of length ``P*s_phys``, where physical row
    ``r = p*s_phys + j`` reads logical row ``src[r]`` when ``valid[r]``
    and is padding otherwise."""
    sizes = np.asarray(local_sizes, dtype=np.int64)
    sp = padded_shard_size(sizes) if s_phys is None else int(s_phys)
    offs = np.concatenate([[0], np.cumsum(sizes)])
    r = np.arange(len(sizes) * sp)
    p, j = r // sp, r % sp
    valid = j < sizes[p]
    src = offs[p] + np.minimum(j, np.maximum(sizes[p] - 1, 0))
    return src, valid


def unpad_index_map(local_sizes: Sequence[int],
                    s_phys: Optional[int] = None) -> np.ndarray:
    """Gather map for padded-physical → logical: index ``i`` of the
    logical axis reads physical row ``idx[i]``."""
    sizes = np.asarray(local_sizes, dtype=np.int64)
    sp = padded_shard_size(sizes) if s_phys is None else int(s_phys)
    return np.concatenate(
        [np.arange(n, dtype=np.int64) + p * sp
         for p, n in enumerate(sizes)]) if len(sizes) else np.empty(0, np.int64)


def flat_outer_shapes(n_outer: int, inner: int, n_shards: int):
    """Per-shard flat sizes of a SCATTER split of an ``(n_outer, ...)``
    array along axis 0: each shard's row count (balanced
    :func:`local_split`) times the per-row ``inner`` size. The
    row-aligned layout of the pencil FFT's flat model and data vectors
    (``ops/fft.py``)."""
    shapes = local_split((int(n_outer),), n_shards, Partition.SCATTER, 0)
    return tuple((s[0] * int(inner),) for s in shapes)
