"""Local (single logical block) linear operators on tensors.

PyTorch counterpart of the operator protocol and ``MatrixMult`` of
``pylops_mpi_tpu/ops/local.py:30-204``: the local operator algebra the
distributed operators compose over (the reference delegates this to
serial pylops, e.g. ``MPIBlockDiag([pylops.MatrixMult(...)])``).
``matvec``/``rmatvec`` take and return flat 1-D tensors.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ._precision import as_torch_dtype
from ..parallel.mesh import DeviceLike, resolve_device

__all__ = ["LocalOperator", "MatrixMult"]


class LocalOperator:
    """Minimal pylops-like operator protocol over tensors."""

    def __init__(self, dims, dimsd, dtype=None, name: str = "L"):
        self.dims = tuple(int(d) for d in np.ravel(dims))
        self.dimsd = tuple(int(d) for d in np.ravel(dimsd))
        self.shape = (int(np.prod(self.dimsd)), int(np.prod(self.dims)))
        self.dtype = as_torch_dtype(dtype) or torch.float32
        self.name = name

    def _matvec(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _rmatvec(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self._matvec(x.reshape(-1)).reshape(-1)

    def rmatvec(self, x: torch.Tensor) -> torch.Tensor:
        return self._rmatvec(x.reshape(-1)).reshape(-1)

    # ------------------------------------------------------------ algebra
    @property
    def H(self) -> "LocalOperator":
        return _Adjoint(self)

    @property
    def T(self) -> "LocalOperator":
        return _Transposed(self)

    def conj(self) -> "LocalOperator":
        return _Conj(self)

    def __mul__(self, x):
        if np.isscalar(x):
            return _Scaled(self, x)
        if isinstance(x, LocalOperator):
            return _Product(self, x)
        return self.matvec(x)

    def __rmul__(self, x):
        if np.isscalar(x):
            return _Scaled(self, x)
        return NotImplemented

    def __matmul__(self, x):
        if isinstance(x, LocalOperator):
            return _Product(self, x)
        return self.matvec(x)

    def __add__(self, x):
        return _Sum(self, x)

    def __neg__(self):
        return _Scaled(self, -1)

    def __sub__(self, x):
        return _Sum(self, _Scaled(x, -1))

    def __repr__(self):
        return f"<{self.shape[0]}x{self.shape[1]} {type(self).__name__} dtype={self.dtype}>"


class _Adjoint(LocalOperator):
    def __init__(self, A):
        super().__init__(A.dimsd, A.dims, dtype=A.dtype)
        self.A = A

    def _matvec(self, x):
        return self.A._rmatvec(x)

    def _rmatvec(self, x):
        return self.A._matvec(x)

    @property
    def H(self):
        return self.A


class _Transposed(LocalOperator):
    def __init__(self, A):
        super().__init__(A.dimsd, A.dims, dtype=A.dtype)
        self.A = A

    def _matvec(self, x):
        return self.A._rmatvec(x.conj_physical()).conj_physical()

    def _rmatvec(self, x):
        return self.A._matvec(x.conj_physical()).conj_physical()


class _Conj(LocalOperator):
    def __init__(self, A):
        super().__init__(A.dims, A.dimsd, dtype=A.dtype)
        self.A = A

    def _matvec(self, x):
        return self.A._matvec(x.conj_physical()).conj_physical()

    def _rmatvec(self, x):
        return self.A._rmatvec(x.conj_physical()).conj_physical()


class _Scaled(LocalOperator):
    def __init__(self, A, alpha):
        super().__init__(A.dims, A.dimsd,
                         dtype=torch.result_type(torch.zeros((), dtype=A.dtype),
                                                 alpha))
        self.A, self.alpha = A, alpha

    def _matvec(self, x):
        return self.alpha * self.A._matvec(x)

    def _rmatvec(self, x):
        return np.conj(self.alpha) * self.A._rmatvec(x)


class _Product(LocalOperator):
    def __init__(self, A, B):
        if A.shape[1] != B.shape[0]:
            raise ValueError(f"shape mismatch {A.shape} @ {B.shape}")
        super().__init__(B.dims, A.dimsd,
                         dtype=torch.promote_types(A.dtype, B.dtype))
        self.A, self.B = A, B

    def _matvec(self, x):
        return self.A.matvec(self.B.matvec(x))

    def _rmatvec(self, x):
        return self.B.rmatvec(self.A.rmatvec(x))


class _Sum(LocalOperator):
    def __init__(self, A, B):
        if A.shape != B.shape:
            raise ValueError(f"shape mismatch {A.shape} + {B.shape}")
        super().__init__(A.dims, A.dimsd,
                         dtype=torch.promote_types(A.dtype, B.dtype))
        self.A, self.B = A, B

    def _matvec(self, x):
        return self.A._matvec(x) + self.B._matvec(x)

    def _rmatvec(self, x):
        return self.A._rmatvec(x) + self.B._rmatvec(x)


class MatrixMult(LocalOperator):
    """Dense matrix block. Analog of ``pylops.MatrixMult``.

    ``A`` is a tensor (kept on its device) or a numpy array (placed on
    ``device``, default ``"cuda"``). ``otherdims`` makes the block act
    on ``(n, *otherdims)`` models as one matrix product. ``dtype`` is
    the operator dtype; as in the JAX package it does not cast ``A``."""

    def __init__(self, A, otherdims: Tuple[int, ...] = (), dtype=None,
                 device: DeviceLike = None):
        if isinstance(A, torch.Tensor):
            if device is not None:
                A = A.to(resolve_device(device))
        else:
            A = torch.tensor(np.asarray(A)).to(
                resolve_device(device))
        self.A = A
        self.otherdims = tuple(otherdims)
        nother = int(np.prod(self.otherdims)) if self.otherdims else 1
        super().__init__((A.shape[1] * nother,), (A.shape[0] * nother,),
                         dtype=dtype or A.dtype)

    def _matvec(self, x):
        if self.otherdims:
            return (self.A @ x.reshape(self.A.shape[1], -1)).reshape(-1)
        return self.A @ x

    def _rmatvec(self, x):
        if self.otherdims:
            return (self.A.mH @ x.reshape(self.A.shape[0], -1)).reshape(-1)
        return self.A.mH @ x
