"""fftshift and ifftshift of a distributed array.

PyTorch counterpart of ``pylops_mpi_tpu/utils/fft_helper.py`` (the
reference's ``pylops_mpi/utils/fft_helper.py:11-105``): the shift of the
global array along ``axes``, with the input's layout. A SCATTER array
is gathered, shifted, and each rank keeps its shard (the JAX package
rolls the logical array and lets the partitioner move what crosses
shards).
"""

from __future__ import annotations

import numpy as np
import torch

from ..distributedarray import DistributedArray

__all__ = ["fftshift_nd", "ifftshift_nd"]


def _shift(x: DistributedArray, axes, inverse: bool) -> DistributedArray:
    axes = tuple(int(a) for a in np.atleast_1d(axes))
    shift = torch.fft.ifftshift if inverse else torch.fft.fftshift
    g = shift(x._global(), dim=axes)
    return DistributedArray._wrap(x._shard_of(g).contiguous(), x)


def fftshift_nd(x: DistributedArray, axes=None) -> DistributedArray:
    """``fftshift`` of ``x`` along ``axes`` (default: every axis)."""
    axes = tuple(range(x.ndim)) if axes is None else axes
    return _shift(x, axes, inverse=False)


def ifftshift_nd(x: DistributedArray, axes=None) -> DistributedArray:
    """``ifftshift`` of ``x`` along ``axes`` (default: every axis)."""
    axes = tuple(range(x.ndim)) if axes is None else axes
    return _shift(x, axes, inverse=True)
