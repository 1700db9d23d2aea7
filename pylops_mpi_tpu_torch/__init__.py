"""pylops_mpi_tpu_torch — the PyTorch/CUDA port of pylops_mpi_tpu.

Distributed and stacked arrays, the lazy linear-operator algebra, the
block-diagonal, stacking and halo operators, the derivative family, the
non-stationary convolution, the Fredholm and MDC operators, the
distributed dense matrix product (block and SUMMA on a 2-D grid of
ranks) and the pencil FFTs, the post-stack, MDD and least-squares
migration pipelines, the CG/CGLS solvers (functions and classes) with
the preconditioner seam (Jacobi, block-Jacobi, V-cycle), block CG/CGLS
and the communication-avoiding engines, the sparse matrix product,
ISTA/FISTA and the power iteration, with the solvers' guard carries,
the resilience tier (fault injection, precision-escalating restarts and
refinement, segmented solves with checkpoints, the watchdog and the
supervisor), the solve service that packs single-RHS requests into
block solves (``serving``, on the ``diagnostics`` and ``resilience``
layers, one process or a group of ranks), and the training path
(``autodiff``: adjoint autograd rules, implicit gradients through the
solves, ``batched_solve`` and ``fit``), in
PyTorch on NVIDIA Hopper GPUs,
one rank a card or a world of ranks over ``torch.distributed``. Two
hand-written CUDA kernels carry the hot loops:
the CGLS normal product (``csrc/normal_matvec.cu``) and the axis-0 tap
stencil of the derivative operators (``csrc/stencil_taps.cu``). Module layout and public names follow the
JAX package ``pylops_mpi_tpu``, which is the reference the port is
tested against. Entry points run on ``"cuda"`` unless given
``device="cpu"``.
"""

from .utils.deps import apply_environment as _apply_environment

# full-f32 matrix products (no TF32), as the JAX package pins
# jax_default_matmul_precision=highest
_apply_environment()

from .parallel.partition import Partition, local_split
from .parallel.mesh import (default_device, set_default_device,
                            make_mesh_hybrid, sub_mesh, make_mesh,
                            make_mesh_2d, initialize_multihost, default_mesh,
                            set_default_mesh, best_grid_2d)
from .distributedarray import DistributedArray
from .stacked import StackedDistributedArray
from .linearoperator import (MPILinearOperator, LinearOperator,
                             aslinearoperator, asmpilinearoperator)
from .stackedlinearoperator import MPIStackedLinearOperator
from .ops.blockdiag import MPIBlockDiag, MPIStackedBlockDiag
from .ops.stack import MPIVStack, MPIStackedVStack, MPIHStack
from .ops.derivatives import (MPIFirstDerivative, MPISecondDerivative,
                              MPILaplacian, MPIGradient)
from .ops.halo import MPIHalo, halo_block_split
from .ops.nonstatconv import MPINonStationaryConvolve1D
from .ops.fredholm import MPIFredholm1
from .ops.mdc import MPIMDC
from .ops.matrixmult import MPIMatrixMult
from .ops.fft import MPIFFTND, MPIFFT2D
from .ops.precond import (JacobiPrecond, BlockJacobiPrecond, VCyclePrecond,
                          make_precond)
from .ops.sparse import MPISparseMatrixMult, auto_sparse_matmult
from .solvers.basic import CG, CGLS, cg, cgls, cg_guarded, cgls_guarded
from .solvers import clear_fused_cache
from .solvers.block import (block_cg, block_cgls, block_cg_segmented,
                            batched_solve, batched_cache_info)
from .solvers.sparsity import ISTA, FISTA, ista, fista
from .solvers.segmented import cg_segmented, cgls_segmented
from .solvers.eigs import power_iteration
from .parallel.reshard import (Layout, ReshardError, plan_reshard,
                               reshard_budget)
from .parallel.spill import HostArray
from .utils.dottest import dottest
from .plotting import plot_distributed_array, plot_local_arrays
from . import (aot, autodiff, basicoperators, convert, diagnostics, models,
               ops, optimization, parallel, plotting, resilience, serving,
               signalprocessing, solvers, tuning, utils, waveeqprocessing)
from .resilience import resilient_solve

__version__ = "0.1.0"
