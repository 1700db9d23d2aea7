"""Stacking operators.

PyTorch counterpart of ``MPIStackedVStack`` in
``pylops_mpi_tpu/ops/stack.py:333-353`` (ref ``VStack.py:153-203``):
one shared model, stacked data.
"""

from __future__ import annotations

from typing import Sequence

from ..distributedarray import DistributedArray
from ..linearoperator import MPILinearOperator, _result_dtype
from ..stacked import StackedDistributedArray
from ..stackedlinearoperator import MPIStackedLinearOperator

__all__ = ["MPIStackedVStack"]


class MPIStackedVStack(MPIStackedLinearOperator):
    """Vertical stack of distributed operators sharing one model; the
    output is a :class:`StackedDistributedArray` with one component per
    operator."""

    def __init__(self, ops: Sequence[MPILinearOperator]):
        self.ops = list(ops)
        if len({op.shape[1] for op in self.ops}) != 1:
            raise ValueError("column size mismatch in MPIStackedVStack")
        shape = (int(sum(op.shape[0] for op in self.ops)),
                 self.ops[0].shape[1])
        super().__init__(shape=shape,
                         dtype=_result_dtype(*[op.dtype for op in self.ops]))

    def _matvec(self, x: DistributedArray) -> StackedDistributedArray:
        return StackedDistributedArray([op.matvec(x) for op in self.ops])

    def _rmatvec(self, x: StackedDistributedArray) -> DistributedArray:
        y = self.ops[0].rmatvec(x.distarrays[0])
        for op, d in zip(self.ops[1:], x.distarrays[1:]):
            y = y + op.rmatvec(d)
        return y
