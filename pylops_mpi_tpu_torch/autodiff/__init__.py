"""The training path: gradients through operators and solves.

PyTorch counterpart of ``pylops_mpi_tpu/autodiff/``:

- :mod:`.rules`: adjoint ``autograd.Function`` rules for operator
  applies (the backward of ``A x`` is the operator's own ``rmatvec``),
  with cotangents for the operator's parameters
  (:func:`~..linearoperator.operator_params`);
- :mod:`.implicit`: implicit differentiation through the fused CG/CGLS
  solves and their block forms, the backward one more solve;
- :mod:`.unrolled`: fixed-iteration taped CG/CGLS, the oracles;
- :mod:`.fit`: a training driver (the JAX package's Adam and SGD,
  updating the parameters in place).

The classic entries (``cg``/``cgls``/``block_cg``/``block_cgls``) route
through the implicit rule when an input requires grad under grad mode;
every other solve is untouched. The guarded entries raise on such an
input.
"""

from .rules import DifferentiableOperator, make_differentiable
from .implicit import (block_cg_solve, block_cgls_solve, cg_solve,
                       cgls_solve)
from .unrolled import unrolled_cg, unrolled_cgls
from .fit import fit, param_count, trainable_leaves
from . import rules, implicit, unrolled  # noqa: F401  (submodule access)

__all__ = [
    "DifferentiableOperator", "make_differentiable",
    "cg_solve", "cgls_solve", "block_cg_solve", "block_cgls_solve",
    "unrolled_cg", "unrolled_cgls",
    "fit", "trainable_leaves", "param_count",
]
