"""Distributed 1-D non-stationary convolution.

PyTorch counterpart of ``pylops_mpi_tpu/ops/nonstatconv.py`` (the
reference's ``pylops_mpi/signalprocessing/NonStatConvolve1d.py:16-189``):
a factory that computes the halo width from the filter spacing, gives
each shard the filters its haloed block needs, and returns the sandwich
``HOp.H @ MPIBlockDiag([local NonStationaryConvolve1D]) @ HOp``. Each
rank builds the local operator of its own shard only; the others enter
``MPIBlockDiag`` by their shapes. With one rank the halo is 0 and the
one block holds every filter.
"""

from __future__ import annotations

import numpy as np

from ..linearoperator import MPILinearOperator
from ..parallel.mesh import DeviceLike, check_mesh, rank, world_size
from .blockdiag import MPIBlockDiag
from .halo import MPIHalo
from .local import NonStationaryConvolve1D, ShapeOnly, _tensor

__all__ = ["MPINonStationaryConvolve1D"]


def MPINonStationaryConvolve1D(dims, hs, ih, axis: int = -1, mesh=None,
                               dtype="float64", *,
                               device: DeviceLike = None
                               ) -> MPILinearOperator:
    """Distributed non-stationary convolution (JAX package
    ``ops/nonstatconv.py:26-111``). ``hs``: ``(nfilt, nh)`` odd-length
    filters, a tensor (kept on its device) or an array (placed on
    ``device``, default ``"cuda"``); ``ih``: their regularly spaced
    positions along ``axis``, which must be 0 for N-D ``dims``. ``mesh``
    keeps the JAX package's argument order and must describe the
    process group."""
    check_mesh(mesh)
    size, me = world_size(), rank()
    dims = tuple(int(d) for d in np.atleast_1d(dims))
    hs = _tensor(hs, device)
    ih = np.asarray(ih)
    axis = axis % len(dims)

    if hs.shape[1] % 2 == 0:
        raise ValueError("filters hs must have odd length")
    if len(np.unique(np.diff(ih))) > 1:
        raise ValueError(
            "the indices of filters 'ih' are must be regularly sampled")
    if min(ih) < 0 or max(ih) >= dims[axis]:
        raise ValueError(
            "the indices of filters 'ih' must be larger than 0 and "
            "smaller than `dims`")
    if dims[axis] % size:
        raise ValueError(
            f"number of input samples {dims[axis]} is not divisible by "
            f"the number of shards ({size})")
    if axis != 0:
        # the distributed sandwich shards axis 0 (the reference's TODO
        # at NonStatConvolve1d.py:92 — N-D layouts convolve on axis=-1
        # only when ndim == 1)
        if len(dims) > 1:
            raise NotImplementedError(
                "distributed NonStationaryConvolve1D currently requires "
                "axis == 0 for N-D layouts")
        axis = 0

    # halo width: max over shards of the distance from the shard edge to
    # the nearest outside filter, plus half filter support
    # (ref NonStatConvolve1d.py:119-133)
    dims_local = dims[axis] // size
    ihdiff = int(np.diff(ih)[0]) if len(ih) > 1 else 1
    dists = []
    for r in range(size):
        start = r * dims_local
        end = start + dims_local - 1
        ihidx = np.where((ih >= start) & (ih <= end))[0]
        if len(ihidx) == 0:
            raise ValueError(f"shard {r} has zero filters!")
        d_start = 0 if r == 0 else ihdiff - (ih[ihidx[0]] - start)
        d_end = 0 if r == size - 1 else ihdiff - (end - ih[ihidx[-1]])
        dists.extend([d_start, d_end])
    halo = int(max(dists)) + (int(hs.shape[1]) // 2 + 1)
    if size == 1:
        halo = 0

    proc_grid_shape = [1] * len(dims)
    proc_grid_shape[axis] = size
    HOp = MPIHalo(dims=dims, halo=halo, proc_grid_shape=proc_grid_shape,
                  dtype=dtype)

    # Per-shard local operators on the haloed extents, with every filter
    # within one spacing of the extended block (the JAX package's window,
    # not the reference's one-filter overlap, which lets the ghost rows'
    # interpolation clamp when the halo spans more than one spacing).
    # Only this rank's is built.
    cops = []
    for r in range(size):
        start = r * dims_local
        end = start + dims_local - 1
        front = halo if r > 0 else 0
        back = halo if r < size - 1 else 0
        dims_ns = list(dims)
        dims_ns[axis] = dims_local + front + back
        if r != me:
            cops.append(ShapeOnly(dims_ns, dims_ns, dtype=dtype))
            continue
        sel = np.where((ih >= start - front - ihdiff)
                       & (ih <= end + back + ihdiff))[0]
        cops.append(NonStationaryConvolve1D(
            dims_ns, hs[sel[0]:sel[-1] + 1],
            ih[sel[0]:sel[-1] + 1] - (start - front), axis=axis,
            dtype=dtype))

    return HOp.H @ MPIBlockDiag(cops) @ HOp
