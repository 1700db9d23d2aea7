"""Distributed linear-operator abstraction with lazy composition algebra.

PyTorch counterpart of ``pylops_mpi_tpu/linearoperator.py`` (the
reference's ``pylops_mpi/LinearOperator.py``). Operators map
:class:`DistributedArray` → :class:`DistributedArray`. The lazy wrappers
mirror ref ``LinearOperator.py:408-580``: ``_AdjointLinearOperator``
(swap mat/rmat), ``_TransposedLinearOperator`` (conj∘rmat∘conj),
``_ProductLinearOperator``, ``_ScaledLinearOperator``,
``_SumLinearOperator``, ``_PowerLinearOperator``,
``_ConjLinearOperator``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .distributedarray import DistributedArray
from .ops._precision import as_torch_dtype

__all__ = ["MPILinearOperator", "LinearOperator", "aslinearoperator",
           "asmpilinearoperator"]


def _scalar_like(x) -> bool:
    """Python/numpy scalars and 0-d tensors or arrays."""
    if np.isscalar(x):
        return True
    return isinstance(x, (torch.Tensor, np.ndarray, np.generic)) \
        and np.ndim(x) == 0


def _result_dtype(*dtypes) -> Optional[torch.dtype]:
    """Promotion of the operands' dtypes (``None`` entries skipped)."""
    out = None
    for dt in dtypes:
        if dt is not None:
            dt = as_torch_dtype(dt)
            out = dt if out is None else torch.promote_types(out, dt)
    return out


class MPILinearOperator:
    """Abstract distributed linear operator
    (ref ``pylops_mpi/LinearOperator.py:16-168``).

    Subclasses implement ``_matvec``/``_rmatvec`` on
    :class:`DistributedArray`. ``Op`` wraps a local operator
    (:mod:`ops.local`) applied to the array's global tensor.
    """

    def __init__(self, Op=None, shape: Optional[Tuple[int, int]] = None,
                 dtype=None):
        self.Op = Op
        if Op is not None:
            self.shape = Op.shape if shape is None else shape
            self.dtype = Op.dtype if dtype is None else as_torch_dtype(dtype)
        else:
            self.shape = shape
            self.dtype = as_torch_dtype(dtype)
        if not hasattr(self, "dims") or self.dims is None:
            self.dims = (self.shape[1],) if self.shape else None
        if not hasattr(self, "dimsd") or self.dimsd is None:
            self.dimsd = (self.shape[0],) if self.shape else None

    dims: Optional[Tuple[int, ...]] = None
    dimsd: Optional[Tuple[int, ...]] = None

    # Block (column-batched) applies: a ``(N, K)`` DistributedArray is K
    # model vectors sharing one apply. Operators whose ``_matvec`` and
    # ``_rmatvec`` widen their contraction over the trailing axis set
    # ``accepts_block``; the rest apply column by column.
    accepts_block = False

    # ------------------------------------------------------------- apply
    def _check(self, x, n: int) -> bool:
        block = (isinstance(x, DistributedArray) and x.ndim == 2
                 and x.global_shape[0] == n)
        if isinstance(x, DistributedArray) and not block \
                and x.global_shape != (n,):
            raise ValueError(
                f"dimension mismatch: operator {self.shape}, x {x.global_shape}")
        return block

    def matvec(self, x: DistributedArray) -> DistributedArray:
        """Forward apply with global-shape check
        (ref ``LinearOperator.py:170-192``); accepts ``(N,)`` or the
        block form ``(N, K)``."""
        if self._check(x, self.shape[1]) and not self.accepts_block:
            return self._apply_columns(x, forward=True)
        return self._matvec(x)

    def rmatvec(self, x: DistributedArray) -> DistributedArray:
        """Adjoint apply with global-shape check
        (ref ``LinearOperator.py:206-230``)."""
        if self._check(x, self.shape[0]) and not self.accepts_block:
            return self._apply_columns(x, forward=False)
        return self._rmatvec(x)

    def _apply_columns(self, x: DistributedArray, forward: bool):
        """Block fallback: apply to each column and stack the results."""
        fn = self._matvec if forward else self._rmatvec
        row_locals = tuple((s[0],) for s in x.local_shapes)
        cols = [fn(DistributedArray._wrap(x.array[:, j].contiguous(), x,
                                          global_shape=(x.global_shape[0],),
                                          local_shapes=row_locals))
                for j in range(x.global_shape[1])]
        like = cols[0]
        K = x.global_shape[1]
        return DistributedArray._wrap(
            torch.stack([c.array for c in cols], dim=1), like,
            global_shape=like.global_shape + (K,),
            local_shapes=tuple(tuple(s) + (K,) for s in like.local_shapes))

    def _matvec(self, x: DistributedArray) -> DistributedArray:
        if self.Op is not None:
            return DistributedArray.to_dist(
                self.Op.matvec(x.array.reshape(-1)), partition=x.partition)
        raise NotImplementedError

    def _rmatvec(self, x: DistributedArray) -> DistributedArray:
        if self.Op is not None:
            return DistributedArray.to_dist(
                self.Op.rmatvec(x.array.reshape(-1)), partition=x.partition)
        raise NotImplementedError

    # ------------------------------------------------- normal-equations
    # ``(u, q) = (Opᴴ Op x, Op x)`` — the CGLS hot pair. The default is
    # two sweeps; operators that produce both in one memory pass
    # (MPIBlockDiag's normal-product kernel) override it and set
    # ``has_fused_normal``.
    has_fused_normal = False

    def normal_matvec(self, x: DistributedArray):
        q = self.matvec(x)
        return self.rmatvec(q), q

    # ----------------------------------------------------------- algebra
    def dot(self, x):
        """Operator-operator, operator-scalar or operator-vector product
        (ref ``LinearOperator.py:244-280``)."""
        if isinstance(x, MPILinearOperator):
            return _ProductLinearOperator(self, x)
        if _scalar_like(x):
            return _ScaledLinearOperator(self, x)
        if x.ndim == 1:
            return self.matvec(x)
        if x.ndim == 2 and x.global_shape[0] == self.shape[1]:
            return self.matvec(x)
        raise ValueError(f"expected 1-d DistributedArray, got {x.global_shape!r}")

    def adjoint(self):
        return self._adjoint()

    H = property(adjoint)

    def transpose(self):
        return self._transpose()

    T = property(transpose)

    def conj(self):
        return _ConjLinearOperator(self)

    def _adjoint(self):
        return _AdjointLinearOperator(self)

    def _transpose(self):
        return _TransposedLinearOperator(self)

    def __mul__(self, x):
        return self.dot(x)

    def __rmul__(self, x):
        if _scalar_like(x):
            return _ScaledLinearOperator(self, x)
        return NotImplemented

    def __matmul__(self, x):
        if _scalar_like(x):
            raise ValueError("Scalar not allowed, use * instead")
        return self.__mul__(x)

    def __rmatmul__(self, x):
        if _scalar_like(x):
            raise ValueError("Scalar not allowed, use * instead")
        return self.__rmul__(x)

    def __pow__(self, p):
        return _PowerLinearOperator(self, p)

    def __add__(self, x):
        return _SumLinearOperator(self, x)

    def __neg__(self):
        return _ScaledLinearOperator(self, -1)

    def __sub__(self, x):
        return self.__add__(-x)

    def __repr__(self):
        M, N = self.shape
        dt = "unspecified dtype" if self.dtype is None else f"dtype={self.dtype}"
        return f"<{M}x{N} {self.__class__.__name__} with {dt}>"


LinearOperator = MPILinearOperator


class _AdjointLinearOperator(MPILinearOperator):
    """ref ``LinearOperator.py:408-421``"""

    accepts_block = True

    def __init__(self, A: MPILinearOperator):
        self.dims, self.dimsd = A.dimsd, A.dims
        super().__init__(shape=(A.shape[1], A.shape[0]), dtype=A.dtype)
        self.A = A

    def _matvec(self, x):
        return self.A.rmatvec(x)

    def _rmatvec(self, x):
        return self.A.matvec(x)


class _TransposedLinearOperator(MPILinearOperator):
    """transpose = conj ∘ rmatvec ∘ conj (ref ``LinearOperator.py:424-443``)"""

    accepts_block = True

    def __init__(self, A: MPILinearOperator):
        self.dims, self.dimsd = A.dimsd, A.dims
        super().__init__(shape=(A.shape[1], A.shape[0]), dtype=A.dtype)
        self.A = A

    def _matvec(self, x):
        return self.A.rmatvec(x.conj()).conj()

    def _rmatvec(self, x):
        return self.A.matvec(x.conj()).conj()


class _ProductLinearOperator(MPILinearOperator):
    """ref ``LinearOperator.py:446-466``"""

    accepts_block = True

    def __init__(self, A: MPILinearOperator, B: MPILinearOperator):
        if A.shape[1] != B.shape[0]:
            raise ValueError(f"cannot multiply {A} and {B}: shape mismatch")
        self.args = (A, B)
        self.dims, self.dimsd = B.dims, A.dimsd
        super().__init__(shape=(A.shape[0], B.shape[1]),
                         dtype=_result_dtype(A.dtype, B.dtype))

    def _matvec(self, x):
        return self.args[0].matvec(self.args[1].matvec(x))

    def _rmatvec(self, x):
        return self.args[1].rmatvec(self.args[0].rmatvec(x))

    def _adjoint(self):
        A, B = self.args
        return B.H * A.H


def _conj_scalar(alpha):
    if isinstance(alpha, torch.Tensor):
        return alpha.conj()
    return np.conj(alpha)


class _ScaledLinearOperator(MPILinearOperator):
    """ref ``LinearOperator.py:469-496``"""

    accepts_block = True

    def __init__(self, A: MPILinearOperator, alpha):
        if not _scalar_like(alpha):
            raise ValueError("scalar expected as alpha")
        self.args = (A, alpha)
        self.dims, self.dimsd = A.dims, A.dimsd
        # a Python scalar promotes like a weak scalar in torch: a real
        # one keeps the operator's dtype, a complex one makes it complex
        dtype = A.dtype
        if A.dtype is not None:
            dtype = torch.result_type(torch.zeros((), dtype=A.dtype),
                                      torch.as_tensor(alpha)
                                      if isinstance(alpha, (np.ndarray,
                                                            np.generic))
                                      else alpha)
        super().__init__(shape=A.shape, dtype=dtype)

    def _matvec(self, x):
        return self.args[0].matvec(x) * self.args[1]

    def _rmatvec(self, x):
        return self.args[0].rmatvec(x) * _conj_scalar(self.args[1])

    def _adjoint(self):
        A, alpha = self.args
        return A.H * _conj_scalar(alpha)


class _SumLinearOperator(MPILinearOperator):
    """ref ``LinearOperator.py:499-524``"""

    accepts_block = True

    def __init__(self, A: MPILinearOperator, B: MPILinearOperator):
        if A.shape != B.shape:
            raise ValueError(f"cannot add {A} and {B}: shape mismatch")
        self.args = (A, B)
        self.dims, self.dimsd = A.dims, A.dimsd
        super().__init__(shape=A.shape, dtype=_result_dtype(A.dtype, B.dtype))

    def _matvec(self, x):
        return self.args[0].matvec(x) + self.args[1].matvec(x)

    def _rmatvec(self, x):
        return self.args[0].rmatvec(x) + self.args[1].rmatvec(x)

    def _adjoint(self):
        A, B = self.args
        return A.H + B.H


class _PowerLinearOperator(MPILinearOperator):
    """repeat-apply (ref ``LinearOperator.py:527-552``)"""

    accepts_block = True

    def __init__(self, A: MPILinearOperator, p: int):
        if A.shape[0] != A.shape[1]:
            raise ValueError("square operator expected")
        if not isinstance(p, (int, np.integer)) or p < 0:
            raise ValueError("non-negative integer expected as p")
        self.args = (A, int(p))
        self.dims, self.dimsd = A.dims, A.dimsd
        super().__init__(shape=A.shape, dtype=A.dtype)

    def _power(self, fun, x):
        res = x.copy()
        for _ in range(self.args[1]):
            res = fun(res)
        return res

    def _matvec(self, x):
        return self._power(self.args[0].matvec, x)

    def _rmatvec(self, x):
        return self._power(self.args[0].rmatvec, x)


class _ConjLinearOperator(MPILinearOperator):
    """ref ``LinearOperator.py:555-580``"""

    accepts_block = True

    def __init__(self, A: MPILinearOperator):
        self.dims, self.dimsd = A.dims, A.dimsd
        super().__init__(shape=A.shape, dtype=A.dtype)
        self.A = A

    def _matvec(self, x):
        return self.A.matvec(x.conj()).conj()

    def _rmatvec(self, x):
        return self.A.rmatvec(x.conj()).conj()

    def _adjoint(self):
        return _ConjLinearOperator(self.A.H)


def aslinearoperator(Op) -> MPILinearOperator:
    """Wrap a local operator as a distributed one
    (ref ``asmpilinearoperator``, ``LinearOperator.py:583-602``)."""
    if isinstance(Op, MPILinearOperator):
        return Op
    return MPILinearOperator(Op=Op)


asmpilinearoperator = aslinearoperator
