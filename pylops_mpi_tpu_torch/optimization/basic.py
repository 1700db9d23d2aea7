"""Module-path parity with ``pylops_mpi.optimization.basic`` (and the
class API of ``cls_basic``)."""
from ..solvers.basic import CG, CGLS, cg, cgls  # noqa: F401
