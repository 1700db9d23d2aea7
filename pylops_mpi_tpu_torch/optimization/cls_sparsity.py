"""Module-path parity with ``pylops_mpi.optimization.cls_sparsity``."""
from ..solvers.sparsity import ISTA, FISTA  # noqa: F401
