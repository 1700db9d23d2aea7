"""Namespace parity with ``pylops_mpi.basicoperators`` (JAX
``pylops_mpi_tpu/basicoperators``)."""
from ..ops.blockdiag import MPIBlockDiag, MPIStackedBlockDiag
from ..ops.stack import MPIVStack, MPIStackedVStack, MPIHStack
from ..ops.derivatives import (MPIFirstDerivative, MPISecondDerivative,
                               MPILaplacian, MPIGradient)
from ..ops.matrixmult import (MPIMatrixMult, active_grid_comm,
                              local_block_split, block_gather)
from ..ops.halo import MPIHalo, halo_block_split
