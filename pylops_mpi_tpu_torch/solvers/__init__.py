from .basic import CG, CGLS, cg, cgls
from .sparsity import ISTA, FISTA, ista, fista
from .eigs import power_iteration

__all__ = ["CG", "CGLS", "cg", "cgls", "ISTA", "FISTA", "ista", "fista",
           "power_iteration"]
