from .basic import CG, CGLS, cg, cgls, cg_guarded, cgls_guarded
from .sparsity import ISTA, FISTA, ista, fista
from .block import (block_cg, block_cgls, block_cg_segmented,
                    batched_solve, BatchedResult, batched_cache_info)
from .eigs import power_iteration
from . import ca

__all__ = ["CG", "CGLS", "cg", "cgls", "cg_guarded", "cgls_guarded", "ISTA", "FISTA", "ista", "fista",
           "block_cg", "block_cgls", "block_cg_segmented", "batched_solve",
           "BatchedResult", "batched_cache_info", "power_iteration", "ca"]
