"""Module-path parity with ``pylops_mpi.optimization.cls_basic``."""
from ..solvers.basic import CG, CGLS  # noqa: F401
