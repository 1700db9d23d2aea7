"""Operators of the port: local operators, the block-diagonal,
stacking and halo operators, the derivative family, the non-stationary
convolution, the Fredholm and MDC operators, the distributed dense
matrix product and the pencil FFTs, the preconditioners, the sparse
matrix product, and the wrappers of the hand-written kernels (normal
product, tap stencil).

The distributed operators are importable from here as from the JAX
package's ``ops``. They load on first access: their modules import the
array and operator modules, which import ``ops._precision`` while the
package itself is still loading."""

from importlib import import_module

_EXPORTS = {
    "MPIBlockDiag": "blockdiag", "MPIStackedBlockDiag": "blockdiag",
    "MPIVStack": "stack", "MPIStackedVStack": "stack", "MPIHStack": "stack",
    "MPIFirstDerivative": "derivatives", "MPISecondDerivative": "derivatives",
    "MPILaplacian": "derivatives", "MPIGradient": "derivatives",
    "MPIHalo": "halo", "halo_block_split": "halo",
    "MPINonStationaryConvolve1D": "nonstatconv",
    "MPIFredholm1": "fredholm", "MPIMDC": "mdc",
    "MPIMatrixMult": "matrixmult", "active_grid_comm": "matrixmult",
    "local_block_split": "matrixmult", "block_gather": "matrixmult",
    "MPIFFTND": "fft", "MPIFFT2D": "fft",
    "JacobiPrecond": "precond", "BlockJacobiPrecond": "precond",
    "VCyclePrecond": "precond", "make_precond": "precond",
    "probe_diagonal": "precond",
    "MPISparseMatrixMult": "sparse", "auto_sparse_matmult": "sparse",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(import_module(f".{_EXPORTS[name]}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
