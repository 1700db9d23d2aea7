"""pylops_mpi_tpu_torch — the PyTorch/CUDA port of pylops_mpi_tpu.

Distributed arrays, the lazy linear-operator algebra, the block-diagonal
operator and the CG/CGLS solvers, in PyTorch on one NVIDIA Hopper GPU.
The CGLS normal product runs in a hand-written CUDA kernel
(``csrc/normal_matvec.cu``). Module layout and public names follow the
JAX package ``pylops_mpi_tpu``, which is the reference the port is
tested against. Entry points run on ``"cuda"`` unless given
``device="cpu"``.
"""

from .utils.deps import apply_environment as _apply_environment

# full-f32 matrix products (no TF32), as the JAX package pins
# jax_default_matmul_precision=highest
_apply_environment()

from .parallel.partition import Partition, local_split
from .parallel.mesh import default_device, set_default_device
from .distributedarray import DistributedArray
from .linearoperator import (MPILinearOperator, LinearOperator,
                             aslinearoperator, asmpilinearoperator)
from .ops.blockdiag import MPIBlockDiag
from .solvers.basic import cg, cgls
from .utils.dottest import dottest
from . import convert, ops, parallel, solvers, utils

__version__ = "0.1.0"
