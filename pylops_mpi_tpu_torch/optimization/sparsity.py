"""Module-path parity with ``pylops_mpi.optimization.sparsity``."""
from ..solvers.sparsity import ISTA, FISTA, ista, fista  # noqa: F401
