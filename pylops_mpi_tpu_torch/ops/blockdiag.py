"""Block-diagonal distributed operator.

PyTorch counterpart of ``pylops_mpi_tpu/ops/blockdiag.py:48-315`` (the
reference's ``pylops_mpi/basicoperators/BlockDiag.py``). Homogeneous
``MatrixMult`` blocks (same shape, same ``otherdims``) are stacked into
one ``(nblk, m, n)`` tensor, optionally stored narrow (``compute_dtype``),
and applied as one batched product; any other list of blocks is applied
block by block.

``normal_matvec`` gives ``(OpᴴOp x, Op x)`` from one read of the stack
through :mod:`.normal_kernels` (the Hopper kernel on CUDA, its plain
version on the CPU) for real floating blocks and real vectors of the
kernel's dtype rules; complex blocks or vectors, block (2-D) vectors and
other dtype pairs take the two-sweep ``matvec`` + ``rmatvec``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..distributedarray import DistributedArray
from ..linearoperator import MPILinearOperator
from . import normal_kernels
from ._precision import (as_torch_dtype, check_compute_dtype,
                         default_compute_dtype, matmul_narrow)
from .local import LocalOperator, MatrixMult

__all__ = ["MPIBlockDiag"]


class MPIBlockDiag(MPILinearOperator):
    """Distributed block-diagonal operator
    (ref ``basicoperators/BlockDiag.py:16-144``).

    Parameters
    ----------
    ops : list of LocalOperator
        All diagonal blocks.
    dtype : dtype, optional
        Operator dtype (default: promotion of the blocks' dtypes).
    compute_dtype : dtype, optional
        Narrow storage for the batched block stack (e.g.
        ``torch.bfloat16``). ``None`` lets the precision policy
        (``PYLOPS_MPI_TPU_TORCH_PRECISION``) decide.
    """

    def __init__(self, ops: Sequence[LocalOperator], dtype=None,
                 compute_dtype=None):
        self.ops = list(ops)
        nops = np.asarray([op.shape[0] for op in self.ops])
        mops = np.asarray([op.shape[1] for op in self.ops])
        self.nops, self.mops = nops, mops
        self.local_shapes_n = ((int(nops.sum()),),)
        self.local_shapes_m = ((int(mops.sum()),),)
        shape = (int(nops.sum()), int(mops.sum()))
        if dtype is None:
            dtype = self.ops[0].dtype
            for op in self.ops[1:]:
                dtype = torch.promote_types(dtype, op.dtype)
        super().__init__(shape=shape, dtype=dtype)
        self.compute_dtype = as_torch_dtype(compute_dtype)
        if self.compute_dtype is None:
            self.compute_dtype = default_compute_dtype(self.dtype)
        self._batched = self._try_batch()

    def _try_batch(self):
        """Homogeneous MatrixMult blocks → one ``(nblk, m, n)`` stack,
        for plain and uniform-``otherdims`` blocks alike."""
        self._batched_k = 1
        if not all(isinstance(op, MatrixMult) for op in self.ops):
            return None
        odims = {op.otherdims for op in self.ops}
        shapes = {tuple(op.A.shape) for op in self.ops}
        if len(odims) != 1 or len(shapes) != 1:
            return None
        other = odims.pop()
        self._batched_k = int(np.prod(other)) if other else 1
        A = torch.stack([op.A for op in self.ops])
        if self.compute_dtype is not None:
            check_compute_dtype(self.compute_dtype, A.dtype, "MPIBlockDiag")
            A = A.to(self.compute_dtype)
        return A.contiguous()

    @property
    def device(self):
        """Device of the block stack (or of the first block's matrix);
        ``None`` for blocks without one."""
        if self._batched is not None:
            return self._batched.device
        A = getattr(self.ops[0], "A", None)
        return None if A is None else A.device

    accepts_block = True

    def _apply(self, x: DistributedArray, forward: bool) -> DistributedArray:
        y_len = self.shape[0] if forward else self.shape[1]
        locals_out = self.local_shapes_n if forward else self.local_shapes_m
        ncol = x.global_shape[1] if x.ndim == 2 else None
        if self._batched is not None:
            A = self._batched
            nblk, m, n = A.shape
            k = self._batched_k
            nin = n if forward else m
            X = x.array.reshape(nblk, nin, k * (ncol or 1))
            Y = matmul_narrow(A if forward else A.mH, X,
                              self.compute_dtype, self.dtype)
            arr = Y.reshape(-1) if ncol is None else Y.reshape(y_len, ncol)
        elif ncol is not None:
            return self._apply_columns(x, forward)
        else:
            sizes_in = self.mops if forward else self.nops
            offs = np.concatenate([[0], np.cumsum(sizes_in)])
            arr = torch.cat([
                op.matvec(x.array[int(lo):int(hi)]) if forward
                else op.rmatvec(x.array[int(lo):int(hi)])
                for op, lo, hi in zip(self.ops, offs[:-1], offs[1:])])
        y_shape = (y_len,) if ncol is None else (y_len, ncol)
        if ncol is not None:
            locals_out = tuple(tuple(s) + (ncol,) for s in locals_out)
        return DistributedArray._wrap(arr, x, global_shape=y_shape,
                                      local_shapes=locals_out)

    def _matvec(self, x: DistributedArray) -> DistributedArray:
        return self._apply(x, forward=True)

    def _rmatvec(self, x: DistributedArray) -> DistributedArray:
        return self._apply(x, forward=False)

    @property
    def has_fused_normal(self) -> bool:
        """One-sweep normal product available: a batched stack of plain
        (vector-form) real blocks the kernel takes."""
        if self._batched is None or self._batched_k != 1:
            return False
        A = self._batched
        return normal_kernels.supported(
            A.dtype, normal_kernels._X_DTYPE.get(A.dtype), A.shape[2])

    def normal_matvec(self, x: DistributedArray):
        """``(u, q) = (OpᴴOp x, Op x)`` with one read of the block stack
        when ``has_fused_normal`` holds and ``x`` is a real vector of the
        kernel's dtype; the two-sweep product otherwise."""
        if (not self.has_fused_normal or x.ndim != 1
                or not normal_kernels.supported(self._batched.dtype, x.dtype,
                                                self._batched.shape[2])):
            return super().normal_matvec(x)
        nblk, m, n = self._batched.shape
        U, Q = normal_kernels.normal_matvec(self._batched,
                                            x.array.reshape(nblk, n))
        u = DistributedArray._wrap(U.reshape(-1), x,
                                   global_shape=(self.shape[1],),
                                   local_shapes=self.local_shapes_m)
        q = DistributedArray._wrap(Q.reshape(-1), x,
                                   global_shape=(self.shape[0],),
                                   local_shapes=self.local_shapes_n)
        return u, q
