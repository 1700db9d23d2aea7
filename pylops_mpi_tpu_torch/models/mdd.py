"""Multi-dimensional deconvolution (MDD) pipeline.

PyTorch counterpart of ``pylops_mpi_tpu/models/mdd.py`` (the reference's
``tutorials/mdd.py``): the frequency-domain MDC operator from a kernel,
and its inversion with CGLS.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..distributedarray import DistributedArray, Partition
from ..ops.mdc import MPIMDC
from ..parallel.mesh import DeviceLike, resolve_device
from ..solvers.basic import cgls

__all__ = ["mdd", "kernel_to_frequency"]


def kernel_to_frequency(Gt: np.ndarray, nfmax: Optional[int] = None
                        ) -> np.ndarray:
    """Time-domain kernel ``(ns, nr, nt)`` → one-sided frequency kernel
    ``(nfmax, ns, nr)`` on the host (the preprocessing step of
    tutorials/mdd.py)."""
    ns, nr, nt = Gt.shape
    Gf = np.fft.rfft(Gt, nt, axis=-1)
    Gf = np.moveaxis(Gf, -1, 0)          # (nfft, ns, nr)
    if nfmax is not None:
        Gf = Gf[:nfmax]
    return Gf


def mdd(G, d, nt: int, nv: int = 1, dt: float = 1.0, dr: float = 1.0,
        twosided: bool = True, niter: int = 50, mesh=None, *,
        tol: float = 1e-12, device: DeviceLike = None
        ) -> Tuple[np.ndarray, object]:
    """Solve ``d = MDC(G) m`` for ``m`` with CGLS from a zero model, with
    BROADCAST data and model (JAX package ``models/mdd.py:33-52``).

    Parameters
    ----------
    G : (nfmax, ns, nr) complex frequency kernel, numpy array or tensor;
        every rank passes the whole kernel and keeps its chunk of the
        frequencies
    d : (nt, ns, nv) data, numpy array or tensor
    mesh : kept for the JAX package's argument order; must describe the
        process group
    tol : CGLS tolerance (keyword-only; the JAX package fixes 1e-12)
    device : where the operator and vectors live; default a tensor
        ``G``'s device, else ``"cuda"``

    The data and model take the real counterpart of ``G``'s dtype (the
    JAX package always uses float64).

    Returns the model as a numpy ``(nt, nr, nv)`` array and the
    operator."""
    if device is None and isinstance(G, torch.Tensor):
        dev = G.device
    else:
        dev = resolve_device(device)
    Op = MPIMDC(G, nt=nt, nv=nv, dt=dt, dr=dr, twosided=twosided, mesh=mesh,
                device=dev)
    if not isinstance(d, torch.Tensor):
        d = torch.tensor(np.asarray(d))
    dy = DistributedArray.to_dist(d.reshape(-1).to(device=dev,
                                                   dtype=Op.dtype),
                                  partition=Partition.BROADCAST)
    x0 = DistributedArray(global_shape=Op.shape[1],
                          partition=Partition.BROADCAST, dtype=Op.dtype,
                          device=dev)
    x, istop, iiter, r1, r2, cost = cgls(Op, dy, x0, niter=niter, tol=tol)
    nr = Op.shape[1] // (nt * nv)
    return x.asarray().reshape(nt, nr, nv), Op
