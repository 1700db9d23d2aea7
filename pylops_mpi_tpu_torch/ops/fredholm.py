"""Fredholm integral of the first kind over frequency slices.

PyTorch counterpart of ``pylops_mpi_tpu/ops/fredholm.py:38-229`` (the
reference's ``pylops_mpi/signalprocessing/Fredholm1.py:14-169``): the
batched per-slice product ``d[k] = G[k] @ m[k]`` and its adjoint
``m[k] = G[k]ᴴ @ d[k]``. With one device the whole kernel ``G`` lives on
it and both products are one batched ``torch.matmul`` (cuBLAS on the
card, TF32 off), as the JAX package leaves them to XLA's einsum.

Not ported: the JAX package's ``planar=True`` plane-pair layout (for
TPU runtimes with no complex support) and its slice-aligned SCATTER
layout over several devices.
"""

from __future__ import annotations

import numpy as np
import torch

from ..distributedarray import DistributedArray
from ..linearoperator import MPILinearOperator
from ..parallel.mesh import DeviceLike, require_world_of_one, resolve_device
from ._precision import (as_torch_dtype, check_compute_dtype,
                         default_compute_dtype, matmul_narrow)

__all__ = ["MPIFredholm1"]


class MPIFredholm1(MPILinearOperator):
    """Fredholm1 over ``nsl`` slices (ref ``Fredholm1.py:14-169``).

    Parameters
    ----------
    G : tensor or numpy array
        The whole kernel ``(nsl, nx, ny)``. A tensor stays on its device
        unless ``device`` is given; a numpy array goes to ``device``
        (default ``"cuda"``).
    nz : int
        Columns of each slice's model and data.
    saveGt : bool
        Store ``Gᴴ`` (conjugated and transposed, contiguous) at build
        time, which doubles the kernel's memory; without it each
        adjoint hands ``torch.matmul`` a lazy conjugate-transpose view.
    usematmul : bool
        Accepted for signature parity; no effect (one batched product
        either way).
    dtype : dtype
        Operator dtype; vectors enter the products at it.
    compute_dtype : dtype, optional
        Narrow storage of ``G`` (e.g. ``torch.complex64`` for a
        ``complex128`` operator); the products run at the operator
        dtype. ``None`` lets the precision policy decide.

    Model and data are flat vectors of ``nsl·ny·nz`` and ``nsl·nx·nz``
    entries, or ``(N, K)`` blocks of K such vectors."""

    accepts_block = True

    def __init__(self, G, nz: int = 1, saveGt: bool = False,
                 usematmul: bool = True, dtype="float64", compute_dtype=None,
                 device: DeviceLike = None):
        require_world_of_one("MPIFredholm1", "A.3")
        if isinstance(G, torch.Tensor):
            if device is not None:
                G = G.to(resolve_device(device))
        else:
            G = torch.tensor(np.asarray(G)).to(resolve_device(device))
        dtype = as_torch_dtype(dtype)
        compute_dtype = as_torch_dtype(compute_dtype)
        if compute_dtype is None:
            compute_dtype = default_compute_dtype(dtype)
        check_compute_dtype(compute_dtype, G.dtype, "MPIFredholm1")
        self.compute_dtype = compute_dtype
        if compute_dtype is not None:
            G = G.to(compute_dtype)
        self.nz = int(nz)
        self.nsl, self.nx, self.ny = G.shape
        if self.nsl < 1:
            raise ValueError("G must have at least one slice")
        self.dims = (self.nsl, self.ny, self.nz)
        self.dimsd = (self.nsl, self.nx, self.nz)
        super().__init__(shape=(int(np.prod(self.dimsd)),
                                int(np.prod(self.dims))), dtype=dtype)
        self.G = G
        # one copy, conjugated and transposed, at build time
        self.GT = G.mH.contiguous() if saveGt else None

    @property
    def device(self) -> torch.device:
        return self.G.device

    def _product(self, K: torch.Tensor, x: DistributedArray, dims,
                 n_out: int) -> DistributedArray:
        """``K @ x`` per slice, with a block's K columns folded into the
        trailing ``nz`` dimension of the same product."""
        ncol = int(x.global_shape[1]) if x.ndim == 2 else None
        v = x.array.reshape(dims if ncol is None
                            else dims[:-1] + (self.nz * ncol,))
        if self.compute_dtype is None:
            v = v.to(self.dtype)
        y = matmul_narrow(K, v, self.compute_dtype, self.dtype).to(self.dtype)
        if ncol is None:
            return DistributedArray._wrap(y.reshape(-1), x,
                                          global_shape=(n_out,),
                                          local_shapes=((n_out,),))
        return DistributedArray._wrap(y.reshape(n_out, ncol), x,
                                      global_shape=(n_out, ncol),
                                      local_shapes=((n_out, ncol),))

    def _matvec(self, x: DistributedArray) -> DistributedArray:
        return self._product(self.G, x, self.dims, self.shape[0])

    def _rmatvec(self, x: DistributedArray) -> DistributedArray:
        GT = self.GT if self.GT is not None else self.G.mH
        return self._product(GT, x, self.dimsd, self.shape[1])
