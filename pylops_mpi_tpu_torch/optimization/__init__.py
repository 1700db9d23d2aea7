"""Namespace parity with ``pylops_mpi.optimization`` (the JAX package's
``pylops_mpi_tpu/optimization``)."""
from ..solvers.basic import CG, CGLS, cg, cgls
from ..solvers.sparsity import ISTA, FISTA, ista, fista
from ..solvers.block import block_cg, block_cgls
from ..solvers.eigs import power_iteration
from ..solvers import basic, sparsity, eigs

__all__ = ["CG", "CGLS", "cg", "cgls", "ISTA", "FISTA", "ista", "fista",
           "block_cg", "block_cgls", "power_iteration", "basic", "sparsity",
           "eigs"]
