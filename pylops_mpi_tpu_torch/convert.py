"""Carry an operator's matrices and a problem's vectors into the port.

The tests build an operator with the JAX package, take its blocks as
numpy arrays (``[np.asarray(op.A) for op in jax_op.ops]``) and rebuild
the same operator here; a user with blocks on the host does the same.
Stacked vectors come over as (nested) lists of their components'
arrays.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .distributedarray import DistributedArray
from .stacked import StackedDistributedArray
from .ops._precision import as_torch_dtype
from .ops.blockdiag import MPIBlockDiag
from .ops.local import MatrixMult
from .parallel.mesh import DeviceLike, resolve_device
from .parallel.partition import Partition

__all__ = ["blockdiag_from_numpy", "array_from_numpy", "stacked_from_numpy"]


def blockdiag_from_numpy(blocks: Sequence[np.ndarray], dtype=None,
                         compute_dtype=None,
                         device: DeviceLike = None) -> MPIBlockDiag:
    """``MPIBlockDiag([MatrixMult(b) for b in blocks])`` with each block
    cast to ``dtype`` (default: its own) and placed on ``device``
    (default ``"cuda"``); ``compute_dtype`` as for
    :class:`~.ops.blockdiag.MPIBlockDiag`."""
    dev = resolve_device(device)
    dt = as_torch_dtype(dtype)
    mats = []
    for b in blocks:
        t = torch.tensor(np.asarray(b))
        mats.append(MatrixMult(t.to(device=dev, dtype=dt or t.dtype)))
    return MPIBlockDiag(mats, compute_dtype=compute_dtype)


def array_from_numpy(x: np.ndarray, dtype=None,
                     partition: Partition = Partition.SCATTER, axis: int = 0,
                     device: DeviceLike = None) -> DistributedArray:
    """A :class:`DistributedArray` of ``x`` cast to ``dtype`` on
    ``device`` (default ``"cuda"``)."""
    t = torch.tensor(np.asarray(x))
    dt = as_torch_dtype(dtype)
    return DistributedArray.to_dist(
        t.to(device=resolve_device(device), dtype=dt or t.dtype),
        partition=partition, axis=axis)


def stacked_from_numpy(components: Sequence, dtype=None,
                       device: DeviceLike = None) -> StackedDistributedArray:
    """A (nested) :class:`StackedDistributedArray` from a list whose
    items are arrays (one SCATTER component each) or lists (a nested
    stack), cast to ``dtype`` on ``device`` (default ``"cuda"``)."""
    return StackedDistributedArray([
        stacked_from_numpy(c, dtype=dtype, device=device)
        if isinstance(c, (list, tuple))
        else array_from_numpy(c, dtype=dtype, device=device)
        for c in components])
