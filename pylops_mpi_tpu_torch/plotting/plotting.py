"""Shard-layout plots.

PyTorch counterpart of ``pylops_mpi_tpu/plotting/plotting.py`` (the
reference's ``pylops_mpi/plotting/plotting.py:13-73``): the ranks'
ownership of a distributed array, and one panel per shard. matplotlib is
imported when a plot is made. Under a process group
:func:`plot_local_arrays` gathers every shard (collective: every rank
calls it), so that every rank returns the same figure.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..distributedarray import DistributedArray
from ..parallel.partition import Partition, shard_offsets

__all__ = ["plot_distributed_array", "plot_local_arrays"]


def _plt():
    try:
        import matplotlib.pyplot as plt
        return plt
    except ImportError as e:
        raise ImportError(
            "matplotlib is required for plotting; install it or use "
            "DistributedArray.asarray() directly") from e


def plot_distributed_array(arr: DistributedArray, figsize=(8, 3)):
    """Color-coded shard ownership of a 1-D/2-D DistributedArray
    (ref ``plotting.py:13-44``); from the layout alone, no gather."""
    plt = _plt()
    sizes = [s[arr.axis] for s in arr.local_shapes]
    owner = np.repeat(np.arange(arr.n_shards), sizes)
    fig, ax = plt.subplots(figsize=figsize)
    if arr.ndim == 1:
        ax.imshow(owner[None, :], aspect="auto", cmap="tab10",
                  vmin=0, vmax=max(9, arr.n_shards - 1))
        ax.set_yticks([])
    else:
        shape = [1, 1]
        shape[arr.axis] = arr.global_shape[arr.axis]
        grid = np.broadcast_to(owner.reshape(shape),
                               arr.global_shape[:2])
        ax.imshow(grid, aspect="auto", cmap="tab10")
    ax.set_title(f"shard layout: {arr.n_shards} devices, axis={arr.axis}")
    return fig, ax


def _shards(arr: DistributedArray) -> List[np.ndarray]:
    """Every shard of ``arr`` on the host, in shard order: the gathered
    array cut by the layout (each rank's copy of a replicated one)."""
    g = arr.asarray()
    if arr.partition != Partition.SCATTER:
        return [g.copy() for _ in range(arr.n_shards)]
    sizes = [s[arr.axis] for s in arr.local_shapes]
    return [np.take(g, np.arange(o, o + n), axis=arr.axis)
            for o, n in zip(shard_offsets(sizes), sizes)]


def plot_local_arrays(arr: DistributedArray, cmap: str = "viridis",
                      figsize=(12, 3)):
    """One panel per shard (ref ``plotting.py:46-73``, which gathers to
    rank 0; here every rank gathers and plots)."""
    plt = _plt()
    locs = _shards(arr)
    fig, axs = plt.subplots(1, len(locs), figsize=figsize)
    axs = np.atleast_1d(axs)
    for i, (ax, loc) in enumerate(zip(axs, locs)):
        view = loc if loc.ndim > 1 else loc[None, :]
        ax.imshow(view, aspect="auto", cmap=cmap)
        ax.set_title(f"shard {i}")
    fig.tight_layout()
    return fig, axs
