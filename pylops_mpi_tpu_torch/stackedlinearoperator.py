"""Stacked linear-operator base.

PyTorch counterpart of ``pylops_mpi_tpu/stackedlinearoperator.py`` (the
reference's ``pylops_mpi/StackedLinearOperator.py:15-568``): operators
whose model or data are :class:`StackedDistributedArray`. The lazy
algebra of :class:`MPILinearOperator` composes either vector type, so
this class only adds the reference's composition guards.
"""

from __future__ import annotations

from .linearoperator import MPILinearOperator

__all__ = ["MPIStackedLinearOperator"]


class MPIStackedLinearOperator(MPILinearOperator):
    """Abstract operator over stacked model/data spaces
    (ref ``StackedLinearOperator.py:15-387``)."""

    def dot(self, x):
        from .ops.blockdiag import MPIStackedBlockDiag
        from .ops.stack import MPIStackedVStack
        # the reference forbids VStack @ VStack and BlockDiag products of
        # different lengths (StackedLinearOperator.py:430-443): the
        # product's components would not line up
        if isinstance(self, MPIStackedVStack) and \
                isinstance(x, MPIStackedVStack):
            raise ValueError("both operands cannot be MPIStackedVStack")
        if (isinstance(self, MPIStackedBlockDiag)
                and isinstance(x, MPIStackedBlockDiag)
                and len(self.ops) != len(x.ops)):
            raise ValueError(
                "both MPIStackedBlockDiag cannot have different number of "
                f"ops, {len(self.ops)} != {len(x.ops)}")
        return super().dot(x)
