"""Fredholm integral of the first kind over frequency slices.

PyTorch counterpart of ``pylops_mpi_tpu/ops/fredholm.py:38-229`` (the
reference's ``pylops_mpi/signalprocessing/Fredholm1.py:14-169``): the
batched per-slice product ``d[k] = G[k] @ m[k]`` and its adjoint
``m[k] = G[k]ᴴ @ d[k]``. Every rank is given the whole kernel ``G`` and
keeps its balanced chunk of the slices (the first ``nsl % P`` ranks one
more), and only that chunk goes to the device. Both products are one
batched ``torch.matmul`` over the chunk (cuBLAS on the card, TF32 off),
as the JAX package leaves them to XLA's einsum.

Two layouts of the vectors, as in the JAX package:

- BROADCAST model and data: each rank takes its slices of the whole
  vector and the output's slices are gathered from every rank (one
  padded ``all_gather``, ragged when ``nsl % P != 0``), the reference's
  allgather of the data;
- SCATTER, slice-aligned (``model_local_shapes``/``data_local_shapes``,
  which need ``nsl % P == 0``): each rank holds the slices of its chunk,
  and an apply communicates nothing.

Not ported: the JAX package's ``planar=True`` plane-pair layout (for
TPU runtimes with no complex support; ROADMAP.md §A.5).
"""

from __future__ import annotations

import numpy as np
import torch

from ..distributedarray import DistributedArray
from ..linearoperator import MPILinearOperator
from ..parallel import collectives
from ..parallel.mesh import (DeviceLike, check_mesh, rank, resolve_device,
                             world_size)
from ..parallel.partition import Partition, local_split, shard_offsets
from ._precision import (as_torch_dtype, check_compute_dtype,
                         default_compute_dtype, matmul_narrow)

__all__ = ["MPIFredholm1"]


class MPIFredholm1(MPILinearOperator):
    """Fredholm1 over ``nsl`` slices (ref ``Fredholm1.py:14-169``).

    Parameters
    ----------
    G : tensor or numpy array
        The whole kernel ``(nsl, nx, ny)``, on every rank; the rank keeps
        its chunk of the slices. A tensor chunk stays on its device
        unless ``device`` is given; a numpy chunk goes to ``device``
        (default ``"cuda"``).
    nz : int
        Columns of each slice's model and data.
    saveGt : bool
        Store the chunk's ``Gᴴ`` (conjugated and transposed, contiguous)
        at build time, which doubles the kernel's memory; without it
        each adjoint hands ``torch.matmul`` a lazy conjugate-transpose
        view.
    usematmul : bool
        Accepted for signature parity; no effect (one batched product
        either way).
    mesh : Mesh, optional
        Kept for the JAX package's argument order; must describe the
        process group.
    dtype : dtype
        Operator dtype; vectors enter the products at it.
    compute_dtype : dtype, optional
        Narrow storage of ``G`` (e.g. ``torch.complex64`` for a
        ``complex128`` operator); the products run at the operator
        dtype. ``None`` lets the precision policy decide.
    planar : bool
        Must be ``False``: the plane-pair layout is not ported.
    scale : float, keyword-only
        A factor the chunk is multiplied by, at its own dtype, before it
        is narrowed (``MPIMDC``'s prescaling, applied to the chunk only).

    Model and data are flat vectors of ``nsl·ny·nz`` and ``nsl·nx·nz``
    entries, or ``(N, K)`` blocks of K such vectors."""

    accepts_block = True

    def __init__(self, G, nz: int = 1, saveGt: bool = False,
                 usematmul: bool = True, mesh=None, dtype="float64",
                 compute_dtype=None, planar: bool = False, *,
                 scale=None, device: DeviceLike = None):
        check_mesh(mesh)
        if planar:
            raise NotImplementedError(
                "MPIFredholm1(planar=True) is not ported (ROADMAP.md §A.5)")
        if not isinstance(G, torch.Tensor):
            G = np.asarray(G)
        self._P, self._rank = world_size(), rank()
        self.nsl, self.nx, self.ny = (int(v) for v in G.shape)
        if self.nsl < 1:
            raise ValueError("G must have at least one slice")
        self._slices = [s[0] for s in local_split(
            (self.nsl,), self._P, Partition.SCATTER, 0)]
        lo = shard_offsets(self._slices)[self._rank]
        part = G[lo:lo + self._slices[self._rank]]
        if isinstance(G, torch.Tensor):
            G = part if device is None else part.to(resolve_device(device))
            if self._P > 1 and G.data_ptr() == part.data_ptr():
                G = G.clone()  # not a view that keeps the whole kernel
        else:
            G = torch.tensor(part).to(resolve_device(device))
        if scale is not None:
            G = G * scale
        dtype = as_torch_dtype(dtype)
        compute_dtype = as_torch_dtype(compute_dtype)
        if compute_dtype is None:
            compute_dtype = default_compute_dtype(dtype)
        check_compute_dtype(compute_dtype, G.dtype, "MPIFredholm1")
        self.compute_dtype = compute_dtype
        if compute_dtype is not None:
            G = G.to(compute_dtype)
        self.nz = int(nz)
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

    @property
    def model_local_shapes(self):
        """Slice-aligned SCATTER split of the flat model vector (the
        layout whose applies communicate nothing); ``None`` when the
        slices do not divide over the ranks."""
        return self._slice_shapes(self.ny)

    @property
    def data_local_shapes(self):
        """Slice-aligned SCATTER split of the flat data vector."""
        return self._slice_shapes(self.nx)

    def _slice_shapes(self, inner):
        if self.nsl % self._P:
            return None
        return tuple((n * inner * self.nz,) for n in self._slices)

    def _check_partition(self, x: DistributedArray, inner: int) -> None:
        """JAX ``ops/fredholm.py:149-165``."""
        if x.partition in (Partition.BROADCAST, Partition.UNSAFE_BROADCAST):
            return
        shapes = self._slice_shapes(inner)
        sizes = tuple(s[0] for s in x.local_shapes)
        if x.partition == Partition.SCATTER and shapes is not None \
                and sizes == tuple(s[0] for s in shapes):
            return
        raise ValueError(
            "x must be BROADCAST, or SCATTER with slice-aligned local "
            "shapes (model_local_shapes/data_local_shapes; requires "
            "nsl % n_devices == 0 and planar=False); got "
            f"{x.partition} with local sizes {sizes}")

    def _product(self, K: torch.Tensor, x: DistributedArray, dims, inner_in,
                 inner_out, n_out: int) -> DistributedArray:
        """``K @ x`` per slice of the rank's chunk, with a block's K
        columns folded into the trailing ``nz`` dimension of the same
        product; a BROADCAST output gathers every rank's slices."""
        self._check_partition(x, inner_in)
        ncol = int(x.global_shape[1]) if x.ndim == 2 else None
        nzk = self.nz * (ncol or 1)
        if x.partition == Partition.SCATTER:
            v = x.array.reshape(K.shape[0], dims[1], nzk)
        else:
            v = x.array.reshape(dims[0], dims[1], nzk)
            if self._P > 1:
                lo = shard_offsets(self._slices)[self._rank]
                v = v[lo:lo + K.shape[0]]
        if self.compute_dtype is None:
            v = v.to(self.dtype)
        y = matmul_narrow(K, v, self.compute_dtype, self.dtype).to(self.dtype)
        tail = () if ncol is None else (ncol,)
        if x.partition == Partition.SCATTER:
            locs = tuple(tuple(s) + tail for s in self._slice_shapes(
                inner_out))
        else:
            if self._P > 1:
                y = collectives.all_gather(y, self._slices)
            locs = ((n_out,) + tail,) * self._P
        return DistributedArray._wrap(y.reshape((-1,) + tail), x,
                                      global_shape=(n_out,) + tail,
                                      local_shapes=locs)

    def _matvec(self, x: DistributedArray) -> DistributedArray:
        return self._product(self.G, x, self.dims, self.ny, self.nx,
                             self.shape[0])

    def _rmatvec(self, x: DistributedArray) -> DistributedArray:
        GT = self.GT if self.GT is not None else self.G.mH
        return self._product(GT, x, self.dimsd, self.nx, self.ny,
                             self.shape[1])


# the operator's parameters (JAX ``ops/fredholm.py`` registrations)
from ..linearoperator import register_operator_params  # noqa: E402

register_operator_params(MPIFredholm1, "G", "GT")
