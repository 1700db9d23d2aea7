"""Distributed sparse matrix–vector products (the sparse matmul tier).

PyTorch counterpart of ``pylops_mpi_tpu/ops/sparse.py``.
:class:`MPISparseMatrixMult` stores only the nonzeros, as row-sorted
(CSR-order) triplets, so an apply's bytes and flops scale with ``nnz``
instead of ``N·Ncol``. Each rank keeps the triplets of its own rows of
``y`` (the default split of ``N``):

- the forward gathers ``x`` (one ``all_gather``) and multiplies it by
  the rank's rows as a CSR matrix (``torch.mv``/``torch.sparse.mm``:
  cuSPARSE on the card), a sorted-segment reduction over each row's
  nonzeros. On an H100 ``torch.segment_reduce`` took 20 ms where the CSR
  product took 0.38 ms for the same 83.9 M nonzeros;
- the adjoint multiplies each conjugated value by its row's entry of
  ``y``, scatter-adds the products into a full-length column vector
  (``index_add_``) and combines the ranks' vectors with one
  ``reduce_scatter`` into the model's shards (the JAX package's
  "psum-shaped combine"). ``index_add_`` on CUDA adds with atomics,
  whose order, and so the last bits of an f32 sum, changes from run to
  run.

``adjoint_mode="ring"`` (JAX ``ops/sparse.py:210-260``) runs the adjoint
of a vector across ranks as a ring instead: each rank's (products,
columns) bundle, padded to the largest rank's nonzeros, travels round
the ranks (:func:`~..parallel.collectives.ring_pass`), and each rank
folds the resident bundle's entries that fall in its own shard of the
model into it, so no full-length vector is reduced; a block ``(N, K)``
input, or a world of one, keeps the scatter schedule, as there. The
JAX package computes this tier outside Pallas, so plain PyTorch ops
carry it.

:func:`auto_sparse_matmult` picks the tier through the tuner (space
``sparse_matmult``, ``nnz`` in its context); with tuning off, the
default, it returns the dense ``MPIMatrixMult``, as the JAX package's
does.
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from ..distributedarray import DistributedArray, Partition
from ..linearoperator import MPILinearOperator
from ..parallel import collectives
from ..parallel.mesh import (DeviceLike, check_mesh, initialized, rank,
                             resolve_device, world_size)
from ..parallel.partition import local_split, shard_offsets
from ._precision import as_torch_dtype
from .blockdiag import _chunk_rows

__all__ = ["MPISparseMatrixMult", "auto_sparse_matmult"]


class MPISparseMatrixMult(MPILinearOperator):
    """Row-sharded sparse (CSR/banded) matrix multiplication (JAX
    ``ops/sparse.py:64-262``).

    Parameters
    ----------
    rows, cols : array-like (nnz,) int
        Row and column of each nonzero; unsorted rows are sorted stably.
    data : array-like (nnz,)
        Nonzero values.
    shape : (N, Ncol)
        Dense shape of the matrix.
    mesh : Mesh, optional
        Must describe the process group (the triplets are split over it).
    dtype, compute_dtype : optional
        Operator dtype (default the values') and the dtype the products
        are formed in.
    adjoint_mode : {"scatter", "ring"}
        The adjoint's schedule across ranks (see the module doc).
    device : str or torch.device, keyword-only
        Where the rank's triplets live (default ``"cuda"``).
    """

    accepts_block = True

    def __init__(self, rows, cols, data, shape: Tuple[int, int], *,
                 mesh=None, dtype=None, compute_dtype=None,
                 adjoint_mode: str = "scatter", device: DeviceLike = None):
        if adjoint_mode not in ("scatter", "ring"):
            raise ValueError(f"adjoint_mode={adjoint_mode!r} "
                             "(expected 'scatter' or 'ring')")
        check_mesh(mesh)
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        data = np.asarray(data)
        if rows.size and np.any(np.diff(rows) < 0):
            order = np.argsort(rows, kind="stable")
            rows, cols, data = rows[order], cols[order], data[order]
        self.N, self.Ncol = int(shape[0]), int(shape[1])
        self.nnz = int(rows.shape[0])
        if self.nnz:
            rmax, cmax = int(np.max(rows)), int(np.max(cols))
            if rmax >= self.N or cmax >= self.Ncol:
                raise ValueError(
                    f"triplet index ({rmax}, {cmax}) outside shape "
                    f"({self.N}, {self.Ncol})")
        dev = resolve_device(device)
        self.compute_dtype = as_torch_dtype(compute_dtype)
        self.adjoint_mode = adjoint_mode
        P = world_size()
        self.local_shapes_n = local_split((self.N,), P, Partition.SCATTER, 0)
        self.local_shapes_m = local_split((self.Ncol,), P,
                                          Partition.SCATTER, 0)
        sizes = [s[0] for s in self.local_shapes_n]
        r0 = shard_offsets(sizes)[rank()]
        self._row0, self._nrows = r0, sizes[rank()]
        lo, hi = np.searchsorted(rows, [r0, r0 + self._nrows], side="left")
        # every rank's nonzero count: the ring's bundles are padded to the
        # largest
        ends = np.searchsorted(rows, np.cumsum(sizes), side="left")
        self._nnz_max = int(np.max(np.diff(np.concatenate([[0], ends]))))
        lrows = rows[lo:hi] - r0
        self.nnz_local = int(hi - lo)
        # int32 indices: 4 bytes a nonzero each for rows and columns
        self._rows = torch.from_numpy(lrows.astype(np.int32)).to(dev)
        self._cols = torch.from_numpy(cols[lo:hi].astype(np.int32)).to(dev)
        vals = torch.from_numpy(np.array(data[lo:hi]))
        dt = as_torch_dtype(dtype)
        self._data = vals.to(device=dev, dtype=dt or vals.dtype)
        crow = np.zeros(self._nrows + 1, dtype=np.int32)
        np.cumsum(np.bincount(lrows, minlength=self._nrows), out=crow[1:])
        self._crow = torch.from_numpy(crow).to(dev)
        self._csr = {}  # the rank's rows as CSR, by product dtype
        super().__init__(shape=(self.N, self.Ncol), dtype=self._data.dtype)

    # ------------------------------------------------------- constructors
    @classmethod
    def from_dense(cls, A, *, tol: float = 0.0, **kw):
        """From a dense matrix, keeping entries with ``|a| > tol``
        (row-major scan: CSR order)."""
        A = np.asarray(A)
        if A.ndim != 2:
            raise ValueError(f"from_dense expects 2-D, got {A.shape}")
        rows, cols = np.nonzero(np.abs(A) > tol)
        return cls(rows, cols, A[rows, cols], A.shape, **kw)

    @classmethod
    def from_banded(cls, offsets, bands, shape: Tuple[int, int], **kw):
        """From diagonals: ``bands[k]`` holds the entries of diagonal
        ``offsets[k]`` within ``shape`` (scipy ``dia`` style)."""
        N, Ncol = int(shape[0]), int(shape[1])
        rows_l, cols_l, data_l = [], [], []
        for off, band in zip(offsets, bands):
            off = int(off)
            r0, c0 = max(0, -off), max(0, off)
            ln = min(N - r0, Ncol - c0)
            if ln <= 0:
                continue
            band = np.asarray(band)
            if band.shape[0] != ln:
                raise ValueError(
                    f"band at offset {off} has {band.shape[0]} entries; "
                    f"diagonal length is {ln}")
            rows_l.append(np.arange(r0, r0 + ln))
            cols_l.append(np.arange(c0, c0 + ln))
            data_l.append(band)
        if not rows_l:
            return cls(np.zeros(0, int), np.zeros(0, int), np.zeros(0),
                       shape, **kw)
        return cls(np.concatenate(rows_l), np.concatenate(cols_l),
                   np.concatenate(data_l), shape, **kw)

    # ------------------------------------------------------------ queries
    @property
    def device(self) -> torch.device:
        return self._data.device

    @property
    def density(self) -> float:
        return self.nnz / float(max(1, self.N * self.Ncol))

    def _scattered(self) -> bool:
        return initialized() and world_size() > 1

    def diagonal(self) -> torch.Tensor:
        """The whole main diagonal (length ``min(N, Ncol)``) on every
        rank, one ``all_reduce`` of the ranks' pieces under a group: the
        Jacobi preconditioner's fast path."""
        n = min(self.N, self.Ncol)
        g = self._rows.long() + self._row0
        on = g == self._cols.long()
        d = torch.zeros(n, dtype=self._data.dtype, device=self.device)
        d.index_add_(0, g[on], self._data[on])
        if self._scattered():
            d = collectives.all_reduce(d, "sum")
        return d

    def todense(self, device: DeviceLike = None) -> np.ndarray:
        """The dense matrix on the host (every rank's rows gathered)."""
        A = torch.zeros((self._nrows, self.Ncol), dtype=self._data.dtype,
                        device=self.device)
        A.index_put_((self._rows.long(), self._cols.long()), self._data,
                     accumulate=True)
        if self._scattered():
            A = collectives.all_gather(A, [s[0] for s in self.local_shapes_n])
        return A.cpu().numpy()

    # ------------------------------------------------------------- apply
    def _wdt(self, g: torch.Tensor) -> torch.dtype:
        if self.compute_dtype is not None:
            return self.compute_dtype
        return torch.promote_types(g.dtype, self._data.dtype)

    def _out(self, arr: torch.Tensor, x: DistributedArray, length: int,
             locals_out) -> DistributedArray:
        tail = tuple(arr.shape[1:])
        return DistributedArray._wrap(
            arr.to(self.dtype), x, global_shape=(length,) + tail,
            local_shapes=tuple(tuple(s) + tail for s in locals_out),
            partition=Partition.SCATTER, axis=0)

    def _rows_csr(self, wdt: torch.dtype) -> torch.Tensor:
        """The rank's rows as a ``(rows, Ncol)`` CSR tensor of ``wdt``."""
        if wdt not in self._csr:
            with warnings.catch_warnings():  # "CSR support is in beta"
                warnings.simplefilter("ignore", UserWarning)
                self._csr[wdt] = torch.sparse_csr_tensor(
                    self._crow, self._cols, self._data.to(wdt),
                    (self._nrows, self.Ncol), check_invariants=False)
        return self._csr[wdt]

    def _matvec(self, x: DistributedArray) -> DistributedArray:
        g = x._global()
        wdt = self._wdt(g)
        A = self._rows_csr(wdt)
        g = g.to(wdt)
        y = torch.mv(A, g) if g.ndim == 1 else torch.sparse.mm(A, g)
        return self._out(y, x, self.N, self.local_shapes_n)

    def _rmatvec(self, x: DistributedArray) -> DistributedArray:
        yl = _chunk_rows(x, [s[0] for s in self.local_shapes_n])
        wdt = self._wdt(yl)
        yg = yl.index_select(0, self._rows).to(wdt)
        vals = self._data.conj().to(wdt)
        prod = vals[:, None] * yg if yl.ndim == 2 else vals * yg
        if self.adjoint_mode == "ring" and yl.ndim == 1 and self._scattered():
            return self._out(self._rmatvec_ring(prod), x, self.Ncol,
                             self.local_shapes_m)
        out = torch.zeros((self.Ncol,) + tuple(yl.shape[1:]), dtype=wdt,
                          device=yl.device)
        out.index_add_(0, self._cols, prod)
        if self._scattered():
            out = collectives.reduce_scatter(
                out, [s[0] for s in self.local_shapes_m])
        return self._out(out, x, self.Ncol, self.local_shapes_m)

    def _rmatvec_ring(self, prod: torch.Tensor) -> torch.Tensor:
        """This rank's shard of the adjoint by the ring (module docstring;
        JAX ``_rmatvec_ring``): the (products, columns) bundles, padded
        with zero products at column -1, pass every rank, and each folds
        the entries of its own columns into its shard."""
        sizes = [s[0] for s in self.local_shapes_m]
        r = rank()
        lo, n = shard_offsets(sizes)[r], sizes[r]
        pad = self._nnz_max - self.nnz_local
        vals = torch.cat([prod, prod.new_zeros(pad)])
        cols = torch.cat([self._cols, self._cols.new_full((pad,), -1)])

        def body(acc, resident, _owner, _s):
            v, c = resident
            loc = c.long() - lo
            sel = (loc >= 0) & (loc < n)
            return acc.index_add(0, loc[sel], v[sel])

        return collectives.ring_pass((vals, cols), body,
                                     init=prod.new_zeros(n))


def auto_sparse_matmult(A, *, mesh=None, dtype=None, compute_dtype=None,
                        tol: float = 0.0, nnz: Optional[int] = None,
                        device: DeviceLike = None) -> MPILinearOperator:
    """Dense-or-sparse tier selection through the tuner (JAX
    ``ops/sparse.py:265-298``): counts ``A``'s entries above ``tol`` and
    asks ``tuning.get_plan`` (space ``sparse_matmult``, ``nnz`` in the
    plan's context) which tier to build. With tuning off, the default,
    the plan is ``None`` and the dense ``MPIMatrixMult`` comes back."""
    A = np.asarray(A)
    if A.ndim != 2:
        raise ValueError(f"auto_sparse_matmult expects 2-D, got {A.shape}")
    N, Ncol = A.shape
    if nnz is None:
        nnz = int(np.count_nonzero(np.abs(A) > tol))
    from ..tuning import plan as _tuneplan
    dt = as_torch_dtype(dtype) or as_torch_dtype(A.dtype)
    pl = _tuneplan.get_plan(
        "sparse_matmult", shape=(int(N), int(Ncol)), dtype=dt,
        n_dev=world_size(), device=resolve_device(device),
        extra={"nnz": int(nnz), "itemsize": int(dt.itemsize)})
    if pl is not None and pl.params.get("tier", "dense") == "sparse":
        return MPISparseMatrixMult.from_dense(
            A, tol=tol, mesh=mesh, dtype=dtype,
            compute_dtype=compute_dtype, device=device)
    from .matrixmult import MPIMatrixMult
    return MPIMatrixMult(A, 1, mesh=mesh, dtype=dtype,
                         compute_dtype=compute_dtype, device=device)


# the operator's parameters (JAX ``ops/sparse.py`` registrations)
from ..linearoperator import register_operator_params  # noqa: E402

register_operator_params(MPISparseMatrixMult, "_data", "_rows", "_cols")
