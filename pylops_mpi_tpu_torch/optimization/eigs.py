"""Module-path parity with ``pylops_mpi.optimization.eigs``."""
from ..solvers.eigs import power_iteration  # noqa: F401
