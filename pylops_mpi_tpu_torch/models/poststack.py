"""Post-stack seismic inversion pipeline.

PyTorch counterpart of ``pylops_mpi_tpu/models/poststack.py`` (the
reference's ``tutorials/poststack.py``): post-stack modelling as an
``MPIBlockDiag`` of per-trace-block local operators, inverted with
CGLS, optionally with Laplacian regularization through a stacked
system.

Layout: the model/data cube is ``(nx, nt0)``, traces first and time
last, so each block is contiguous in the C-order flatten and the
BlockDiag model space coincides with the derivative operators' (which
distribute axis 0). The local modelling operator mirrors pylops'
``PoststackLinearModelling``: ``d = 0.5 · W · D m`` with ``W`` a
stationary wavelet convolution along time and ``D`` the centered first
derivative along time. The wavelet is a numpy array.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..distributedarray import DistributedArray
from ..ops.blockdiag import MPIBlockDiag
from ..ops.derivatives import MPILaplacian
from ..ops.local import Conv1D, FirstDerivative, LocalOperator
from ..ops.stack import MPIStackedVStack
from ..parallel.mesh import DeviceLike, resolve_device, world_size
from ..solvers.basic import cgls
from ..stacked import StackedDistributedArray

__all__ = ["PoststackLinearModelling", "MPIPoststackLinearModelling",
           "poststack_inversion", "ricker"]


def ricker(t, f0: float = 20.0):
    """Ricker wavelet (zero-phase) on the symmetric time axis built from
    the non-negative times ``t``; returns ``(wavelet, times)``."""
    t = np.asarray(t)
    t = np.concatenate([-t[:0:-1], t])
    w = (1 - 2 * (np.pi * f0 * t) ** 2) * np.exp(-(np.pi * f0 * t) ** 2)
    return w, t


def PoststackLinearModelling(wav: np.ndarray, nt0: int,
                             spatdims: Tuple[int, ...] = (),
                             dtype=torch.float64,
                             device: DeviceLike = None) -> LocalOperator:
    """Local post-stack modelling ``0.5 · W · D`` over a
    ``(*spatdims, nt0)`` block, time on the last axis; the wavelet goes
    to ``device`` (default ``"cuda"``)."""
    dims = tuple(spatdims) + (nt0,)
    taxis = len(dims) - 1
    D = FirstDerivative(dims, axis=taxis, kind="centered", edge=True,
                        dtype=dtype)
    W = Conv1D(dims, np.asarray(wav), axis=taxis, offset=len(wav) // 2,
               dtype=dtype, device=device)
    return 0.5 * (W @ D)


def MPIPoststackLinearModelling(wav: np.ndarray, nt0: int, nx: int,
                                dtype=torch.float64,
                                device: DeviceLike = None) -> MPIBlockDiag:
    """The ``nx`` traces split over the ranks, one local modelling block
    per rank (the reference tutorial's MPIBlockDiag layout): each rank
    keeps its own block of traces."""
    chunks = [len(c) for c in np.array_split(np.arange(nx), world_size())]
    return MPIBlockDiag([PoststackLinearModelling(wav, nt0, (c,), dtype=dtype,
                                                  device=device)
                         for c in chunks])


def poststack_inversion(d, wav: np.ndarray, niter: int = 100,
                        epsR: Optional[float] = None, damp: float = 1e-4,
                        dtype=torch.float64, device: DeviceLike = None):
    """Invert post-stack data ``d (nx, nt0)`` for acoustic impedance.

    ``d`` is a numpy array (placed on ``device``, default ``"cuda"``)
    or a tensor (kept on its device unless ``device`` is given).
    ``epsR=None``: damped CGLS. With ``epsR``: the Laplacian-regularized
    stacked system ``[Op; εR·∇²] m = [d; 0]``. Under a process group
    every rank passes the whole ``d`` and keeps its traces; the model
    comes back gathered on every rank. Returns the model as a numpy
    ``(nx, nt0)`` array and the modelling operator."""
    nx, nt0 = d.shape
    if isinstance(d, torch.Tensor):
        dev = d.device if device is None else resolve_device(device)
        flat = d.reshape(-1)
    else:
        dev = resolve_device(device)
        flat = np.asarray(d).ravel()
    Op = MPIPoststackLinearModelling(wav, nt0, nx, dtype=dtype, device=dev)
    dy = DistributedArray.to_dist(flat, local_shapes=Op.local_shapes_n,
                                  device=dev)
    x0 = DistributedArray(global_shape=Op.shape[1],
                          local_shapes=Op.local_shapes_m, dtype=dtype,
                          device=dev)
    if epsR is None:
        # damping stabilises the near-singular W·D normal equations
        # (cond ~ 1e17): without it CGLS trajectories are rounding-order
        # sensitive
        x, *_ = cgls(Op, dy, x0, niter=niter, damp=damp, tol=1e-10)
    else:
        LapOp = MPILaplacian(dims=(nx, nt0), axes=(0, 1), weights=(1, 1),
                             sampling=(1, 1), dtype=dtype)
        StackOp = MPIStackedVStack([Op, epsR * LapOp])
        zero = DistributedArray(global_shape=LapOp.shape[0],
                                local_shapes=LapOp.local_shapes_n,
                                dtype=dtype, device=dev)
        dstack = StackedDistributedArray([dy, zero])
        x, *_ = cgls(StackOp, dstack, x0, niter=niter, damp=damp, tol=1e-10)
    return x.asarray().reshape(nx, nt0), Op
