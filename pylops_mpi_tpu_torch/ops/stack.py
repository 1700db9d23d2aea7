"""Vertical and horizontal stacking of operators.

PyTorch counterpart of ``pylops_mpi_tpu/ops/stack.py`` (the reference's
``pylops_mpi/basicoperators/VStack.py`` and ``HStack.py``):

- :class:`MPIVStack` — ``y = [L0 x; L1 x; ...]`` from a replicated
  (BROADCAST) model; the data is SCATTER over the row blocks, and the
  adjoint ``Σᵢ Lᵢᴴ yᵢ`` is BROADCAST.
- :class:`MPIStackedVStack` — one shared model, stacked data.
- :class:`MPIHStack` — the adjoint of a :class:`MPIVStack` of adjoints.

Every rank is given the whole list of rows and keeps its chunk, by the
rule ``MPIBlockDiag`` follows (``_chunk_ops``). The forward applies the
rank's rows to the whole model and communicates nothing (a SCATTER
model is gathered first, as the JAX package's arrays are global); the
adjoint sums the rank's partials ``Lᵢᴴ yᵢ`` and reduces them over the
group with one ``all_reduce``, or, with overlap on and batched rows on
every rank, as a ring (:meth:`MPIVStack._rmatvec_ring`), or on a world
laid out hosts × ranks as a two-level reduce-scatter and gather
(:meth:`MPIVStack._rmatvec_hier`).
:class:`MPIStackedVStack`'s components share the model's split, so it
needs no collective of its own.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..distributedarray import DistributedArray
from ..linearoperator import MPILinearOperator
from ..parallel import collectives
from ..parallel.mesh import check_mesh, rank, world_size
from ..parallel.partition import Partition
from ..stacked import StackedDistributedArray
from ..stackedlinearoperator import MPIStackedLinearOperator
from ._precision import (as_torch_dtype, check_compute_dtype,
                         default_compute_dtype, matmul_narrow, result_dtype)
from .blockdiag import _chunk_ops, _chunk_rows
from .local import LocalOperator, MatrixMult, _Adjoint

__all__ = ["MPIVStack", "MPIStackedVStack", "MPIHStack"]


class MPIVStack(MPILinearOperator):
    """Vertical stack of local operators (ref
    ``basicoperators/VStack.py:21-203``; JAX package ``ops/stack.py``):
    forward ``[L0 x; L1 x; ...]`` with a replicated model, output
    SCATTER over the row blocks; adjoint ``Σᵢ Lᵢᴴ yᵢ``, output
    BROADCAST.

    Every rank passes all the rows and keeps its chunk; the rows of the
    other ranks are read for their shapes only, so a rank may pass
    :class:`~.local.ShapeOnly` stand-ins for them. ``local_shapes_n``
    gives each rank's row count. The rank's rows that are all plain
    ``MatrixMult`` blocks of one shape, or all ``MatrixMult(...).H``
    (the :class:`MPIHStack` construction), collapse into one
    ``(nblk, m, n)`` stack stored at ``compute_dtype`` (``None`` lets the
    precision policy decide), applied as one product: plain rows take
    one GEMM (a GEMV for a vector) with the flattened ``(nblk·m, n)``
    stack, forward and adjoint; adjoint rows take one batched GEMM, and
    their adjoint a sum over the blocks after it. Block (``(N, K)``)
    vectors widen the same products; other rows apply one by one, and
    block vectors then column by column.

    ``mask`` is stamped on both outputs, so that their ``dot``/``norm``
    reduce within the rank's color group; the adjoint still sums every
    rank's partial, as the JAX package's does. ``mesh`` keeps the JAX
    package's argument order and must describe the process group.
    ``overlap`` (``PYLOPS_MPI_TPU_TORCH_OVERLAP``) selects the ring form
    of the adjoint's reduction (JAX ``ops/stack.py:177-233``, taken where
    the JAX package takes it: more than one rank, and the blocks batched
    on every rank, their count a multiple of the ranks); it reorders the
    sums. Deciding that the other ranks' rows batch too takes one
    ``all_reduce`` at construction, when overlap is on. ``hierarchical``
    (``PYLOPS_MPI_TPU_TORCH_HIERARCHICAL``) selects, in place of the ring,
    the two-level form of the same reduction on a world laid out hosts ×
    ranks (JAX ``ops/stack.py:240-301``): one GEMM gives the rank's whole
    partial, then ``hier_reduce_scatter`` (over the ranks of its host,
    then across hosts on partials ``1/I`` the size) and
    ``hier_all_gather``; it reorders the sums. ``.hierarchical`` keeps
    the setting and ``._hier`` what it resolved to on this world
    (``utils.deps.hierarchical_active``); a flat world, a world of one
    or ``off`` keep the ring or bulk reduction bit for bit.
    """

    def __init__(self, ops: Sequence[LocalOperator],
                 mask: Optional[Sequence[int]] = None, mesh=None, dtype=None,
                 compute_dtype=None, overlap=None, hierarchical=None):
        check_mesh(mesh)
        ops = list(ops)
        cols = {op.shape[1] for op in ops}
        if len(cols) != 1:
            raise ValueError("column size mismatch in MPIVStack")
        self._P, self._rank = world_size(), rank()
        if mask is not None and len(mask) != self._P:
            raise ValueError(f"mask must have {self._P} entries")
        self.mask = None if mask is None else tuple(mask)
        self.nops = np.asarray([op.shape[0] for op in ops])
        chunks = _chunk_ops(ops, self._P)
        self.local_shapes_n = tuple(
            (int(sum(op.shape[0] for op in c)),) for c in chunks)
        shape = (int(self.nops.sum()), int(cols.pop()))
        super().__init__(shape=shape, dtype=dtype or result_dtype(
            *[op.dtype for op in ops]))
        # this rank's rows only: the others can be freed by the caller
        self.ops = chunks[self._rank]
        del chunks
        self.compute_dtype = as_torch_dtype(compute_dtype)
        if self.compute_dtype is None:
            self.compute_dtype = default_compute_dtype(self.dtype)
        self._batched, self._batched_adj = self._try_batch()
        # the tuner's seam (JAX ``ops/stack.py:83-95``): an overlap left
        # at None, and not pinned by the environment, comes from the plan
        from ..utils.deps import overlap_enabled, overlap_env_pinned
        if overlap is None and not overlap_env_pinned():
            from ..tuning import plan as _tuneplan
            from ..utils.deps import batch_default
            tplan = _tuneplan.get_plan("stack", shape=shape,
                                       dtype=self.dtype, n_dev=self._P,
                                       device=self.device,
                                       extra={"batch": batch_default()})
            if tplan is not None and tplan.get("overlap") in ("on", "off"):
                overlap = tplan.get("overlap")
        self.overlap = overlap
        self._overlap = overlap_enabled(overlap, self.device)
        from ..utils.deps import hierarchical_active
        self.hierarchical = hierarchical
        self._hier = hierarchical_active(hierarchical)
        self._ring = (self._overlap and self._P > 1
                      and len(ops) % self._P == 0 and self._all_batched())

    def _all_batched(self) -> bool:
        """Every rank's rows batch (one ``all_reduce`` of the flags: a
        rank sees only its own rows' types)."""
        flag = torch.tensor([float(self._batched is not None)],
                            device=collectives._comm_device())
        return bool(collectives.all_reduce(flag, "min").item())

    def _try_batch(self):
        """Homogeneous matrix rows → one ``(nblk, m, n)`` stack and the
        flag saying the rows are its blocks' adjoints; ``(None, False)``
        for any other list of rows (an empty one included)."""
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
        """Device of the block stack (or of the rank's first row's
        matrix); ``None`` for rows without one, or no rows."""
        if self._batched is not None:
            return self._batched.device
        A = getattr(self.ops[0], "A", None) if self.ops else None
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

    def _rows_apply(self, x: torch.Tensor, forward: bool) -> torch.Tensor:
        """The rank's rows one by one on ``x``: forward their
        concatenation, adjoint the sum of their partials; a block
        ``(len, K)`` column by column."""
        if x.ndim == 2:
            return torch.stack([self._rows_apply(x[:, j].contiguous(),
                                                 forward)
                                for j in range(x.shape[1])], dim=1)
        if not self.ops:
            n = 0 if forward else self.shape[1]
            return x.new_zeros(n, dtype=torch.promote_types(self.dtype,
                                                            x.dtype))
        if forward:
            parts = [op.matvec(x) for op in self.ops]
            return parts[0] if len(parts) == 1 else torch.cat(parts)
        parts = torch.split(x, [op.shape[0] for op in self.ops])
        acc = self.ops[0].rmatvec(parts[0])
        for op, p in zip(self.ops[1:], parts[1:]):
            acc = acc + op.rmatvec(p)
        return acc

    def _apply(self, x: torch.Tensor, forward: bool) -> torch.Tensor:
        arr = (self._batched_apply(x, forward) if self._batched is not None
               else self._rows_apply(x, forward))
        if self._P > 1:
            # every rank's piece at one dtype, whatever its rows
            arr = arr.to(torch.promote_types(self.dtype, x.dtype))
        return arr

    def _matvec(self, x: DistributedArray) -> DistributedArray:
        tail = tuple(x.global_shape[1:])
        arr = self._apply(x._global(), forward=True)
        return DistributedArray._wrap(
            arr, x, global_shape=(self.shape[0],) + tail,
            partition=Partition.SCATTER, axis=0, mask=self.mask,
            local_shapes=tuple(tuple(s) + tail for s in self.local_shapes_n))

    def _rmatvec_ring(self, y: torch.Tensor) -> torch.Tensor:
        """The batched adjoint as a ring reduce-scatter (JAX
        ``ops/stack.py:177-233``): the output, padded to ``P·ceil(out/P)``
        rows, is cut into ``P`` chunks; each rank's partial of a chunk is
        one GEMM on the columns (rows, for adjoint rows) of its stack
        that make that chunk, computed while the hop before it is in
        flight (:func:`~..parallel.collectives.ring_reduce_scatter`:
        ``P`` chunk GEMMs, ``P - 1`` hops), and one ``all_gather``
        restores the whole (BROADCAST) result."""
        A, adj = self._batched, self._batched_adj
        nblk, m, n = A.shape
        out_len = m if adj else n
        cw = -(-out_len // self._P)
        cd, dt = self.compute_dtype, self.dtype
        odt = torch.promote_types(self.dtype, y.dtype)
        tail = tuple(y.shape[1:])

        def chunk(j):
            lo, hi = min(j * cw, out_len), min((j + 1) * cw, out_len)
            if adj:  # Σ_b A_b[lo:hi] y_b
                part = matmul_narrow(A[:, lo:hi], y.reshape(nblk, n, -1),
                                     cd, dt).sum(0).reshape((hi - lo,) + tail)
            else:  # Σ_b A_b[:, lo:hi]ᴴ y_b
                part = matmul_narrow(A.view(nblk * m, n)[:, lo:hi].mH, y,
                                     cd, dt)
            part = part.to(odt)
            if hi - lo < cw:
                part = torch.cat([part, part.new_zeros((cw - hi + lo,)
                                                       + tail)])
            return part

        red = collectives.ring_reduce_scatter(chunk)
        return collectives.all_gather(red, [cw] * self._P)[:out_len]

    @property
    def _two_level(self) -> bool:
        """Whether a two-level schedule runs (the graph bank's key,
        :func:`~..aot.signature.schedule_signature`): the batched
        adjoint's."""
        return self._ring and self._hier

    def _rmatvec_hier(self, y: torch.Tensor) -> torch.Tensor:
        """The batched adjoint's two-level form (JAX
        ``_rmatvec_batched_hier``, ``ops/stack.py:240-283``): the rank's
        whole partial from one GEMM, padded to ``P·ceil(out/P)`` rows,
        reduced by ``hier_reduce_scatter`` and made whole again by
        ``hier_all_gather``."""
        part = self._apply(y, forward=False)
        out_len = part.shape[0]
        cw = -(-out_len // self._P)
        if cw * self._P != out_len:
            part = torch.cat([part, part.new_zeros(
                (cw * self._P - out_len,) + tuple(part.shape[1:]))])
        sizes = [cw] * self._P
        red = collectives.hier_reduce_scatter(part.contiguous(), sizes)
        return collectives.hier_all_gather(red, sizes)[:out_len]

    def _rmatvec(self, x: DistributedArray) -> DistributedArray:
        tail = tuple(x.global_shape[1:])
        y = _chunk_rows(x, [s[0] for s in self.local_shapes_n])
        if self._ring and self._hier:
            arr = self._rmatvec_hier(y)
        elif self._ring:
            arr = self._rmatvec_ring(y)
        else:
            arr = self._apply(y, forward=False)
        if self._P > 1 and not self._ring:
            arr = collectives.all_reduce(arr.contiguous(), "sum")
        n = (self.shape[1],) + tail
        return DistributedArray._wrap(
            arr, x, global_shape=n, partition=Partition.BROADCAST, axis=0,
            local_shapes=(n,) * self._P, mask=self.mask)


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
    package ``ops/stack.py:356-377``): forward input SCATTER (split as
    ``local_shapes_m``; any other split is regathered into it), output
    BROADCAST. The arguments are :class:`MPIVStack`'s."""

    accepts_block = True

    def __init__(self, ops: Sequence[LocalOperator],
                 mask: Optional[Sequence[int]] = None, mesh=None, dtype=None,
                 compute_dtype=None, overlap=None, hierarchical=None):
        self.vstack = MPIVStack([op.H for op in ops], mask, mesh, dtype,
                                compute_dtype, overlap, hierarchical)
        self.ops = self.vstack.ops
        self.mask = self.vstack.mask
        self.local_shapes_m = self.vstack.local_shapes_n
        super().__init__(shape=(self.vstack.shape[1], self.vstack.shape[0]),
                         dtype=self.vstack.dtype)

    @property
    def device(self):
        return self.vstack.device

    def _matvec(self, x: DistributedArray) -> DistributedArray:
        return self.vstack._rmatvec(x)

    def _rmatvec(self, x: DistributedArray) -> DistributedArray:
        return self.vstack._matvec(x)


# the operator's parameters (JAX ``ops/stack.py`` registrations)
from ..linearoperator import register_operator_params  # noqa: E402

register_operator_params(MPIVStack, "_batched")
register_operator_params(MPIHStack, "vstack")
register_operator_params(MPIStackedVStack, "ops")
