"""Block-diagonal distributed operators.

PyTorch counterpart of ``pylops_mpi_tpu/ops/blockdiag.py`` (the
reference's ``pylops_mpi/basicoperators/BlockDiag.py``). Every rank is
given the full list of blocks; the JAX package's balanced rule
(``_chunk_ops``) assigns each rank a contiguous chunk of them, and the
operator keeps references to its own chunk only. The apply is local to
the rank's shard: no communication. Homogeneous ``MatrixMult`` blocks
(same shape, same ``otherdims``) of the chunk are stacked into one
``(nblk, m, n)`` tensor, optionally stored narrow (``compute_dtype``),
and applied as one batched product; any other chunk is applied block by
block.

``normal_matvec`` gives ``(OpᴴOp x, Op x)`` from one read of the stack
through :mod:`.normal_kernels` (the Hopper kernel on CUDA, its plain
version on the CPU) for real floating blocks and real vectors of the
kernel's dtype rules; complex blocks or vectors, block (2-D) vectors and
other dtype pairs, or ``normal_path="two_sweep"``, take the two-sweep
``matvec`` + ``rmatvec``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..distributedarray import DistributedArray, Partition
from ..linearoperator import MPILinearOperator
from ..parallel import collectives
from ..parallel.mesh import check_mesh, rank, world_size
from ..parallel.partition import shard_offsets
from ..stacked import StackedDistributedArray
from ..stackedlinearoperator import MPIStackedLinearOperator
from . import normal_kernels
from ._precision import (as_torch_dtype, check_compute_dtype,
                         default_compute_dtype, matmul_narrow, result_dtype)
from .local import LocalOperator, MatrixMult

__all__ = ["MPIBlockDiag", "MPIStackedBlockDiag"]


def _chunk_ops(ops: Sequence, n_shards: int) -> List[List]:
    """Assign operators to ranks: contiguous balanced chunks (the first
    ``len(ops) % P`` ranks get one extra), the JAX package's rule
    (``ops/blockdiag.py:34-46``) and the reference's one list per rank."""
    n = len(ops)
    base, rem = divmod(n, n_shards)
    chunks, off = [], 0
    for i in range(n_shards):
        c = base + (1 if i < rem else 0)
        chunks.append(list(ops[off:off + c]))
        off += c
    return chunks


def _chunk_rows(x: DistributedArray, rows: Sequence[int]) -> torch.Tensor:
    """``x``'s rows of this rank's chunk when the ranks hold ``rows``
    rows each along axis 0: its shard when it is split so, else
    regathered into that split; a BROADCAST vector's own slice."""
    P, r = world_size(), rank()
    if x.partition != Partition.SCATTER:
        if P == 1:
            return x.array
        off = shard_offsets(rows)[r]
        return x.array[off:off + rows[r]]
    if [s[0] for s in x.local_shapes] != list(rows):
        x = x._relayout(tuple((n,) + tuple(x.global_shape[1:])
                              for n in rows))
    return x.array


class MPIBlockDiag(MPILinearOperator):
    """Distributed block-diagonal operator
    (ref ``basicoperators/BlockDiag.py:16-144``).

    Parameters
    ----------
    ops : list of LocalOperator
        All diagonal blocks (the concatenation of every rank's list in
        the reference API); each rank keeps its chunk.
    mask : list, optional
        Group color per rank, carried onto the outputs so that their
        reductions group as the reference's sub-communicators do.
    mesh : Mesh, optional
        Kept for the JAX package's argument order. The blocks are split
        over the default process group (:func:`~..parallel.mesh.world_size`
        ranks); a ``mesh`` of another size or rank is refused.
    dtype : dtype, optional
        Operator dtype (default: promotion of the blocks' dtypes).
    compute_dtype : dtype, optional
        Narrow storage for the batched block stack (e.g.
        ``torch.bfloat16``). ``None`` lets the precision policy
        (``PYLOPS_MPI_TPU_TORCH_PRECISION``) decide.
    normal_path : str, optional
        ``"fused"`` or ``None``/``"auto"``: the one-sweep normal kernel
        where it applies; ``"two_sweep"``: always ``matvec`` +
        ``rmatvec``. Left at ``None``/``"auto"`` under
        ``PYLOPS_MPI_TPU_TORCH_TUNE=on|auto``, the plan decides.
    """

    def __init__(self, ops: Sequence[LocalOperator],
                 mask: Optional[Sequence] = None, mesh=None, dtype=None,
                 compute_dtype=None, normal_path: Optional[str] = None):
        if normal_path not in (None, "auto", "fused", "two_sweep"):
            raise ValueError(
                f"normal_path={normal_path!r}: expected None, 'auto', "
                "'fused' or 'two_sweep'")
        ops = list(ops)
        check_mesh(mesh)
        self._P, self._rank = world_size(), rank()
        chunks = _chunk_ops(ops, self._P)
        if mask is not None and len(mask) != self._P:
            raise ValueError(f"mask must have {self._P} entries")
        self.mask = None if mask is None else tuple(mask)
        self.nops = np.asarray([op.shape[0] for op in ops])
        self.mops = np.asarray([op.shape[1] for op in ops])
        # per-rank shapes (what the reference gathers at construction,
        # ref BlockDiag.py:106-120)
        self.local_shapes_n = tuple(
            (int(sum(op.shape[0] for op in c)),) for c in chunks)
        self.local_shapes_m = tuple(
            (int(sum(op.shape[1] for op in c)),) for c in chunks)
        shape = (int(self.nops.sum()), int(self.mops.sum()))
        super().__init__(shape=shape, dtype=dtype or result_dtype(
            *[op.dtype for op in ops]))
        # this rank's blocks only: the others can be freed by the caller
        self.ops = chunks[self._rank]
        del chunks
        self.compute_dtype = as_torch_dtype(compute_dtype)
        if self.compute_dtype is None:
            self.compute_dtype = default_compute_dtype(self.dtype)
        self._normal_path = None if normal_path == "auto" else normal_path
        self._batched = self._try_batch()
        # the tuner's seam (JAX ``ops/blockdiag.py:107-125``): a normal
        # path left at its sentinel comes from the plan under
        # PYLOPS_MPI_TPU_TORCH_TUNE=on|auto (off: None, nothing changes)
        if self._normal_path is None and self._batched is not None:
            from ..tuning import plan as _tuneplan
            from ..utils.deps import batch_default
            tplan = _tuneplan.get_plan(
                "blockdiag", shape=self.shape, dtype=self.dtype,
                n_dev=self._P, device=self._batched.device,
                extra={"fused_available": bool(self.has_fused_normal),
                       "a_bytes": float(np.sum(self.nops * self.mops))
                       * self._batched.element_size(),
                       "batch": batch_default()})
            if tplan is not None \
                    and tplan.get("normal_path") in ("fused", "two_sweep"):
                self._normal_path = tplan.get("normal_path")

    def _try_batch(self):
        """Homogeneous MatrixMult blocks → one ``(nblk, m, n)`` stack,
        for plain and uniform-``otherdims`` blocks alike."""
        self._batched_k = 1
        if not self.ops or not all(isinstance(op, MatrixMult)
                                   for op in self.ops):
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
        A = getattr(self.ops[0], "A", None) if self.ops else None
        return A.device if isinstance(A, torch.Tensor) else None

    accepts_block = True

    def _local_input(self, x: DistributedArray, forward: bool):
        """``x``'s rows of this rank's blocks, in the operator's model
        (forward) or data (adjoint) split (:func:`_chunk_rows`)."""
        want = self.local_shapes_m if forward else self.local_shapes_n
        return _chunk_rows(x, [s[0] for s in want])

    def _output(self, arr: torch.Tensor, x: DistributedArray,
                forward: bool) -> DistributedArray:
        """This rank's output rows as a vector of the operator's data
        (forward) or model space, in ``x``'s partition, with the
        operator's mask; a BROADCAST output is gathered whole."""
        y_len = self.shape[0] if forward else self.shape[1]
        locals_out = self.local_shapes_n if forward else self.local_shapes_m
        tail = tuple(x.global_shape[1:])
        if x.partition != Partition.SCATTER:
            if self._P > 1:
                arr = collectives.all_gather(arr, [s[0] for s in locals_out])
            locals_out = ((y_len,),) * self._P
        return DistributedArray._wrap(
            arr, x, global_shape=(y_len,) + tail,
            local_shapes=tuple(tuple(s) + tail for s in locals_out),
            mask=self.mask)

    def _apply(self, x: DistributedArray, forward: bool) -> DistributedArray:
        ncol = x.global_shape[1] if x.ndim == 2 else None
        if self._batched is None and ncol is not None:
            return self._apply_columns(x, forward)
        xl = self._local_input(x, forward)
        if self._batched is not None:
            A = self._batched
            nblk, m, n = A.shape
            k = self._batched_k
            nin = n if forward else m
            X = xl.reshape(nblk, nin, k * (ncol or 1))
            Y = matmul_narrow(A if forward else A.mH, X,
                              self.compute_dtype, self.dtype)
            arr = Y.reshape(-1) if ncol is None else Y.reshape(-1, ncol)
        elif not self.ops:  # a rank with no blocks
            arr = xl.new_zeros(0, dtype=torch.promote_types(self.dtype,
                                                            xl.dtype))
        else:
            sizes_in = [op.shape[1] if forward else op.shape[0]
                        for op in self.ops]
            offs = np.concatenate([[0], np.cumsum(sizes_in)])
            parts = [op.matvec(xl[int(lo):int(hi)]) if forward
                     else op.rmatvec(xl[int(lo):int(hi)])
                     for op, lo, hi in zip(self.ops, offs[:-1], offs[1:])]
            arr = parts[0] if len(parts) == 1 else torch.cat(parts)
        return self._output(arr, x, forward)

    def _matvec(self, x: DistributedArray) -> DistributedArray:
        return self._apply(x, forward=True)

    def _rmatvec(self, x: DistributedArray) -> DistributedArray:
        return self._apply(x, forward=False)

    @property
    def has_fused_normal(self) -> bool:
        """One-sweep normal product available: a batched stack of plain
        (vector-form) real blocks the kernel takes."""
        if (self._batched is None or self._batched_k != 1
                or self._normal_path == "two_sweep"):
            return False
        A = self._batched
        return normal_kernels.supported(
            A.dtype, normal_kernels._X_DTYPE.get(A.dtype), A.shape[2])

    def _normal_matvec(self, x: DistributedArray):
        """``(u, q) = (OpᴴOp x, Op x)`` with one read of the block stack
        when ``has_fused_normal`` holds and ``x`` is a real vector of the
        kernel's dtype; the two-sweep product otherwise."""
        if (not self.has_fused_normal or x.ndim != 1
                or not normal_kernels.supported(self._batched.dtype, x.dtype,
                                                self._batched.shape[2])):
            return super()._normal_matvec(x)
        nblk, m, n = self._batched.shape
        U, Q = normal_kernels.normal_matvec(
            self._batched, self._local_input(x, True).reshape(nblk, n))
        return (self._output(U.reshape(-1), x, False),
                self._output(Q.reshape(-1), x, True))

    def diagonal(self) -> torch.Tensor:
        """Main diagonals of this rank's blocks, concatenated, at the
        operator's dtype (JAX ``ops/blockdiag.py:216``, which returns every
        block's): the Jacobi preconditioner's fast path. Batched blocks
        read the stacked tensor; others each block's matrix."""
        if self._batched is not None and self._batched_k == 1:
            d = torch.diagonal(self._batched, dim1=1, dim2=2)
            return d.reshape(-1).to(self.dtype)
        parts = []
        for op in self.ops:
            A = getattr(op, "A", None)
            if A is None:
                raise AttributeError(
                    "diagonal() needs matrix blocks (op.A); got "
                    f"{type(op).__name__}")
            parts.append(torch.diagonal(A))
        if not parts:
            return torch.zeros(0, dtype=self.dtype)
        return torch.cat(parts).to(self.dtype)


class MPIStackedBlockDiag(MPIStackedLinearOperator):
    """Diagonal stack of distributed operators acting on a
    :class:`StackedDistributedArray`, one component each (JAX
    ``ops/blockdiag.py:318-335``, ref ``BlockDiag.py:147-188``)."""

    def __init__(self, ops: Sequence[MPILinearOperator]):
        self.ops = list(ops)
        shape = (int(sum(op.shape[0] for op in self.ops)),
                 int(sum(op.shape[1] for op in self.ops)))
        super().__init__(shape=shape,
                         dtype=result_dtype(*[op.dtype for op in self.ops]))

    def _matvec(self, x: StackedDistributedArray) -> StackedDistributedArray:
        return StackedDistributedArray(
            [op.matvec(d) for op, d in zip(self.ops, x.distarrays)])

    def _rmatvec(self, x: StackedDistributedArray) -> StackedDistributedArray:
        return StackedDistributedArray(
            [op.rmatvec(d) for op, d in zip(self.ops, x.distarrays)])


# the operator's parameters (JAX ``ops/blockdiag.py`` registrations)
from ..linearoperator import register_operator_params  # noqa: E402

register_operator_params(MPIBlockDiag, "_batched")
register_operator_params(MPIStackedBlockDiag, "ops")
