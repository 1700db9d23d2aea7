"""Vertical and horizontal stacking of operators.

PyTorch counterpart of ``pylops_mpi_tpu/ops/stack.py`` (the reference's
``pylops_mpi/basicoperators/VStack.py`` and ``HStack.py``):

- :class:`MPIVStack` — ``y = [L0 x; L1 x; ...]`` from a replicated
  (BROADCAST) model; the data is SCATTER over the row blocks, and the
  adjoint ``Σᵢ Lᵢᴴ yᵢ`` is BROADCAST.
- :class:`MPIStackedVStack` — one shared model, stacked data.
- :class:`MPIHStack` — the adjoint of a :class:`MPIVStack` of adjoints.

:class:`MPIVStack` and :class:`MPIHStack` run with one rank, where the
reference's adjoint allreduce is the local sum of the partials; under a
group of more ranks they raise (ROADMAP.md §A.3).
:class:`MPIStackedVStack` runs across ranks: its components share the
model's split, so it needs no collective of its own.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..distributedarray import DistributedArray
from ..linearoperator import MPILinearOperator
from ..parallel.mesh import require_world_of_one
from ..parallel.partition import Partition
from ..stacked import StackedDistributedArray
from ..stackedlinearoperator import MPIStackedLinearOperator
from ._precision import (as_torch_dtype, check_compute_dtype,
                         default_compute_dtype, matmul_narrow, result_dtype)
from .local import LocalOperator, MatrixMult, _Adjoint

__all__ = ["MPIVStack", "MPIStackedVStack", "MPIHStack"]


class MPIVStack(MPILinearOperator):
    """Vertical stack of local operators (ref
    ``basicoperators/VStack.py:21-203``): forward ``[L0 x; L1 x; ...]``
    with a replicated model, output SCATTER over the row blocks; adjoint
    ``Σᵢ Lᵢᴴ yᵢ``, output BROADCAST.

    Rows that are all plain ``MatrixMult`` blocks of one shape, or all
    ``MatrixMult(...).H`` (the :class:`MPIHStack` construction), collapse
    into one ``(nblk, m, n)`` stack stored at ``compute_dtype`` (``None``
    lets the precision policy decide), applied as one product: plain
    rows take one GEMM (a GEMV for a vector) with the flattened
    ``(nblk·m, n)`` stack, forward and adjoint; adjoint rows take one
    batched GEMM, and their adjoint a sum over the blocks after it.
    Block (``(N, K)``) vectors widen the same products; other rows
    apply one by one, and block vectors then column by column.

    ``overlap`` and ``hierarchical`` select, in the JAX package, the
    ring and two-level forms of the adjoint's reduction over several
    devices; with one worker there is nothing to reduce across, so they
    are accepted and have no effect (as in the JAX package on one
    device). ``mask`` must be ``None``: sub-communicator stacks are not
    ported.
    """

    def __init__(self, ops: Sequence[LocalOperator],
                 mask: Optional[Sequence[int]] = None, dtype=None,
                 compute_dtype=None, overlap=None, hierarchical=None):
        require_world_of_one("MPIVStack (and MPIHStack)", "A.3")
        if mask is not None:
            raise NotImplementedError(
                "mask= (sub-communicator stacks) is not ported: the port "
                "has one worker; pass mask=None")
        self.ops = list(ops)
        cols = {op.shape[1] for op in self.ops}
        if len(cols) != 1:
            raise ValueError("column size mismatch in MPIVStack")
        self.nops = np.asarray([op.shape[0] for op in self.ops])
        self.local_shapes_n = ((int(self.nops.sum()),),)
        shape = (int(self.nops.sum()), int(cols.pop()))
        super().__init__(shape=shape, dtype=dtype or result_dtype(
            *[op.dtype for op in self.ops]))
        self.compute_dtype = as_torch_dtype(compute_dtype)
        if self.compute_dtype is None:
            self.compute_dtype = default_compute_dtype(self.dtype)
        self._batched, self._batched_adj = self._try_batch()

    def _try_batch(self):
        """Homogeneous matrix rows → one ``(nblk, m, n)`` stack and the
        flag saying the rows are its blocks' adjoints; ``(None, False)``
        for any other list of rows."""
        mats, adjs = [], []
        for op in self.ops:
            if isinstance(op, MatrixMult) and not op.otherdims:
                mats.append(op.A)
                adjs.append(False)
            elif (isinstance(op, _Adjoint) and isinstance(op.A, MatrixMult)
                    and not op.A.otherdims):
                mats.append(op.A.A)
                adjs.append(True)
            else:
                return None, False
        if len(set(adjs)) != 1 or len({tuple(m.shape) for m in mats}) != 1:
            return None, False
        A = torch.stack(mats)
        if self.compute_dtype is not None:
            check_compute_dtype(self.compute_dtype, A.dtype, "MPIVStack")
            A = A.to(self.compute_dtype)
        return A.contiguous(), adjs[0]

    @property
    def device(self):
        """Device of the block stack (or of the first row's matrix);
        ``None`` for rows without one."""
        if self._batched is not None:
            return self._batched.device
        A = getattr(self.ops[0], "A", None)
        return A.device if isinstance(A, torch.Tensor) else None

    accepts_block = True

    def _batched_apply(self, x: torch.Tensor, forward: bool) -> torch.Tensor:
        """The stacked rows (``forward``) or their adjoint on ``x``, a
        vector or a ``(len, K)`` block."""
        A, adj = self._batched, self._batched_adj
        nblk, m, n = A.shape
        cd, dt = self.compute_dtype, self.dtype
        tail = x.shape[1:]
        if not adj:
            # [A_b x]_b, or Σ_b A_bᴴ y_b: one product with the flat stack
            flat = A.view(nblk * m, n)
            return matmul_narrow(flat if forward else flat.mH, x, cd, dt)
        if forward:  # [A_bᴴ x]_b
            return matmul_narrow(A.mH, x, cd, dt).reshape((nblk * n,) + tail)
        # Σ_b A_b y_b
        Y = matmul_narrow(A, x.reshape(nblk, n, -1), cd, dt).sum(0)
        return Y.reshape((m,) + tail)

    def _matvec(self, x: DistributedArray) -> DistributedArray:
        ncol = x.global_shape[1] if x.ndim == 2 else None
        if self._batched is not None:
            arr = self._batched_apply(x.array, forward=True)
        elif ncol is not None:
            return self._apply_columns(x, forward=True)
        else:
            parts = [op.matvec(x.array) for op in self.ops]
            arr = parts[0] if len(parts) == 1 else torch.cat(parts)
        lsh = (self.local_shapes_n if ncol is None
               else tuple(tuple(s) + (ncol,) for s in self.local_shapes_n))
        return DistributedArray.to_dist(arr, partition=Partition.SCATTER,
                                        local_shapes=lsh)

    def _rmatvec(self, x: DistributedArray) -> DistributedArray:
        if self._batched is not None:
            arr = self._batched_apply(x.array, forward=False)
        elif x.ndim == 2:
            return self._apply_columns(x, forward=False)
        else:
            parts = torch.split(x.array, self.nops.tolist())
            arr = self.ops[0].rmatvec(parts[0])
            for op, p in zip(self.ops[1:], parts[1:]):
                arr = arr + op.rmatvec(p)
        return DistributedArray.to_dist(arr, partition=Partition.BROADCAST)


class MPIStackedVStack(MPIStackedLinearOperator):
    """Vertical stack of distributed operators sharing one model; the
    output is a :class:`StackedDistributedArray` with one component per
    operator (JAX package ``ops/stack.py:333-353``, ref
    ``VStack.py:153-203``)."""

    def __init__(self, ops: Sequence[MPILinearOperator]):
        self.ops = list(ops)
        if len({op.shape[1] for op in self.ops}) != 1:
            raise ValueError("column size mismatch in MPIStackedVStack")
        # the shared model's split, from the first operator that fixes one
        self.local_shapes_m = next((op.local_shapes_m for op in self.ops
                                    if op.local_shapes_m is not None), None)
        shape = (int(sum(op.shape[0] for op in self.ops)),
                 self.ops[0].shape[1])
        super().__init__(shape=shape,
                         dtype=result_dtype(*[op.dtype for op in self.ops]))

    def _matvec(self, x: DistributedArray) -> StackedDistributedArray:
        return StackedDistributedArray([op.matvec(x) for op in self.ops])

    def _rmatvec(self, x: StackedDistributedArray) -> DistributedArray:
        y = self.ops[0].rmatvec(x.distarrays[0])
        for op, d in zip(self.ops[1:], x.distarrays[1:]):
            y = y + op.rmatvec(d)
        return y


class MPIHStack(MPILinearOperator):
    """Horizontal stack ``[L0, L1, ...]``, the adjoint of a
    :class:`MPIVStack` of the adjoints (ref ``HStack.py:98-100``; JAX
    package ``ops/stack.py:356-377``): forward input SCATTER, output
    BROADCAST. The keywords are :class:`MPIVStack`'s."""

    accepts_block = True

    def __init__(self, ops: Sequence[LocalOperator],
                 mask: Optional[Sequence[int]] = None, dtype=None,
                 compute_dtype=None, overlap=None, hierarchical=None):
        self.vstack = MPIVStack([op.H for op in ops], mask=mask, dtype=dtype,
                                compute_dtype=compute_dtype, overlap=overlap,
                                hierarchical=hierarchical)
        self.ops = self.vstack.ops
        super().__init__(shape=(self.vstack.shape[1], self.vstack.shape[0]),
                         dtype=self.vstack.dtype)

    @property
    def device(self):
        return self.vstack.device

    def _matvec(self, x: DistributedArray) -> DistributedArray:
        return self.vstack._rmatvec(x)

    def _rmatvec(self, x: DistributedArray) -> DistributedArray:
        return self.vstack._matvec(x)
