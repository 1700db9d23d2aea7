"""Local (single logical block) linear operators on tensors.

PyTorch counterpart of the operator protocol and every operator of
``pylops_mpi_tpu/ops/local.py`` (``MatrixMult``, ``Identity``,
``Diagonal``, ``Zero``, ``Transpose``, ``Roll``, ``Flip``, ``Pad``,
``FunctionOperator``, the derivative stencils, ``Laplacian``, the local
``VStack``/``HStack``/``BlockDiag``, ``FFT``, ``Conv1D`` and
``NonStationaryConvolve1D``):
the local operator algebra the distributed operators compose over (the reference delegates this to
serial pylops, e.g. ``MPIBlockDiag([pylops.MatrixMult(...)])``).
``matvec``/``rmatvec`` take and return flat 1-D tensors. As in the JAX
package, the stencils here are plain tensor code; the distributed
derivative operators run their axis-0 stencils through the tap kernel
instead (``ops/derivatives.py``).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ._precision import as_torch_dtype, result_dtype
from ..parallel.mesh import DeviceLike, resolve_device

__all__ = ["LocalOperator", "ShapeOnly", "MatrixMult", "Identity",
           "Diagonal", "Zero", "Transpose", "FirstDerivative",
           "SecondDerivative", "Laplacian",
           "Roll", "Pad", "Flip", "FunctionOperator", "VStack", "HStack",
           "BlockDiag", "FFT", "Conv1D", "NonStationaryConvolve1D"]


def _tensor(a, device: DeviceLike) -> torch.Tensor:
    """``a`` as a tensor: a tensor stays on its device unless ``device``
    is given; anything else is placed on ``device`` (default
    ``"cuda"``)."""
    if isinstance(a, torch.Tensor):
        return a if device is None else a.to(resolve_device(device))
    return torch.tensor(np.asarray(a)).to(resolve_device(device))


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


class ShapeOnly(LocalOperator):
    """Another rank's operator, held by its shapes and dtype only. Every
    rank passes the whole list of blocks or rows to a distributed
    operator, which keeps its own chunk; the others need only their
    sizes, and a rank can stand in this for an operator it would be
    costly to build (``MPILSM``'s batches, ``MPINonStationaryConvolve1D``'s
    shards, the blocks ``convert`` leaves on the host). Applying it
    raises."""

    def _matvec(self, x):
        raise RuntimeError("a ShapeOnly operator stands for another rank's "
                           "operator and cannot be applied")

    _rmatvec = _matvec


class MatrixMult(LocalOperator):
    """Dense matrix block. Analog of ``pylops.MatrixMult``.

    ``A`` is a tensor (kept on its device) or a numpy array (placed on
    ``device``, default ``"cuda"``). ``otherdims`` makes the block act
    on ``(n, *otherdims)`` models as one matrix product. ``dtype`` is
    the operator dtype; as in the JAX package it does not cast ``A``."""

    def __init__(self, A, otherdims: Tuple[int, ...] = (), dtype=None,
                 device: DeviceLike = None):
        self.A = A = _tensor(A, device)
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


class Identity(LocalOperator):
    """``N×M`` identity (JAX package ``ops/local.py:206-226``): for
    ``N < M`` the forward keeps the first ``N`` entries and the adjoint
    zero-pads back; for ``N > M`` the other way round."""

    def __init__(self, N: int, M: Optional[int] = None, dtype=None):
        M = N if M is None else M
        super().__init__((M,), (N,), dtype=dtype)

    @staticmethod
    def _fit(x, n):
        """``x`` cut or zero-padded to ``n`` entries (a view when cut)."""
        if x.shape[0] >= n:
            return x[:n]
        return F.pad(x, (0, n - x.shape[0]))

    def _matvec(self, x):
        return self._fit(x, self.shape[0])

    def _rmatvec(self, x):
        return self._fit(x, self.shape[1])


class Diagonal(LocalOperator):
    """Elementwise product with ``diag`` (JAX package
    ``ops/local.py:228-238``); ``diag`` is a tensor (kept on its device)
    or an array (placed on ``device``, default ``"cuda"``)."""

    def __init__(self, diag, dtype=None, device: DeviceLike = None):
        self.diag = _tensor(diag, device).reshape(-1)
        n = self.diag.shape[0]
        super().__init__((n,), (n,), dtype=dtype or self.diag.dtype)

    def _matvec(self, x):
        return self.diag * x

    def _rmatvec(self, x):
        return self.diag.conj() * x


class Zero(LocalOperator):
    """``N×M`` zero operator (JAX package ``ops/local.py:241-250``)."""

    def __init__(self, N: int, M: Optional[int] = None, dtype=None):
        M = N if M is None else M
        super().__init__((M,), (N,), dtype=dtype)

    def _matvec(self, x):
        return x.new_zeros(self.shape[0])

    def _rmatvec(self, x):
        return x.new_zeros(self.shape[1])


class Transpose(LocalOperator):
    """N-D axes permutation as a flat operator (JAX package
    ``ops/local.py:253-267``)."""

    def __init__(self, dims, axes, dtype=None):
        self.axes = tuple(int(a) for a in axes)
        self.dims_nd = tuple(int(d) for d in dims)
        self.axes_inv = tuple(int(a) for a in np.argsort(self.axes))
        dimsd = tuple(self.dims_nd[a] for a in self.axes)
        super().__init__(self.dims_nd, dimsd, dtype=dtype)

    def _matvec(self, x):
        return x.reshape(self.dims_nd).permute(self.axes).reshape(-1)

    def _rmatvec(self, x):
        return x.reshape(self.dimsd).permute(self.axes_inv).reshape(-1)


class Roll(LocalOperator):
    """Circular shift by ``shift`` (JAX package ``ops/local.py:270-279``)."""

    def __init__(self, N: int, shift: int = 1, dtype=None):
        self.shift = int(shift)
        super().__init__((N,), (N,), dtype=dtype)

    def _matvec(self, x):
        return torch.roll(x, self.shift)

    def _rmatvec(self, x):
        return torch.roll(x, -self.shift)


class Flip(LocalOperator):
    """Reversal (JAX package ``ops/local.py:282-289``)."""

    def __init__(self, N: int, dtype=None):
        super().__init__((N,), (N,), dtype=dtype)

    def _matvec(self, x):
        return torch.flip(x, (0,))

    _rmatvec = _matvec


class Pad(LocalOperator):
    """Zero padding of an N-D layout by ``pad`` = ``((before, after), ...)``
    per axis (JAX package ``ops/local.py:292-306``); the adjoint crops."""

    def __init__(self, dims, pad, dtype=None):
        self.dims_nd = tuple(int(d) for d in np.atleast_1d(dims))
        self.pad_nd = tuple(tuple(int(v) for v in p)
                            for p in np.atleast_2d(pad))
        self.dimsd_nd = tuple(d + p[0] + p[1]
                              for d, p in zip(self.dims_nd, self.pad_nd))
        super().__init__(self.dims_nd, self.dimsd_nd, dtype=dtype)

    def _matvec(self, x):
        # F.pad lists the last axis first
        flat = [v for p in reversed(self.pad_nd) for v in p]
        return F.pad(x.reshape(self.dims_nd), flat).reshape(-1)

    def _rmatvec(self, x):
        sl = tuple(slice(p[0], p[0] + d)
                   for d, p in zip(self.dims_nd, self.pad_nd))
        return x.reshape(self.dimsd_nd)[sl].reshape(-1)


class FunctionOperator(LocalOperator):
    """An ``N×M`` operator from a forward and an adjoint function on flat
    tensors (JAX package ``ops/local.py:309-322``)."""

    def __init__(self, f: Callable, fH: Callable, N: int,
                 M: Optional[int] = None, dtype=None):
        M = N if M is None else M
        self.f, self.fH = f, fH
        super().__init__((M,), (N,), dtype=dtype)

    def _matvec(self, x):
        return self.f(x)

    def _rmatvec(self, x):
        return self.fH(x)


# ------------------------------------------------------- stencil operators
def _sl(v: torch.Tensor, axis: int, start=None, stop=None) -> torch.Tensor:
    """``v[..., start:stop, ...]`` along ``axis`` (a view)."""
    idx = [slice(None)] * v.ndim
    idx[axis] = slice(start, stop)
    return v[tuple(idx)]


def _pad(v: torch.Tensor, axis: int, before: int, after: int) -> torch.Tensor:
    """``v`` with ``before``/``after`` zero rows along ``axis``."""
    return F.pad(v, [0, 0] * (v.ndim - 1 - axis) + [before, after])


class FirstDerivative(LocalOperator):
    """Local first derivative along ``axis`` (pylops' stencils; JAX
    package ``ops/local.py:330-414``). ``kind``: forward | backward |
    centered (3- or 5-point; zero rows at the boundary unless ``edge``).
    The stencil works on the axis in place (no transposed copy); the
    ``edge`` rows are added to the fresh output in place."""

    def __init__(self, dims, axis: int = 0, sampling: float = 1.0,
                 kind: str = "centered", edge: bool = False, order: int = 3,
                 dtype=None):
        self.dims_nd = tuple(int(d) for d in np.atleast_1d(dims))
        self.axis = axis % len(self.dims_nd)
        self.sampling = sampling
        self.kind, self.edge, self.order = kind, edge, order
        if kind == "centered" and order not in (3, 5):
            raise NotImplementedError("'order' must be 3 or 5")
        super().__init__(self.dims_nd, self.dims_nd, dtype=dtype)

    def _matvec(self, x):
        v = x.reshape(self.dims_nd)
        ax, s = self.axis, self.sampling
        n = v.shape[ax]

        def S(a=None, b=None):
            return _sl(v, ax, a, b)

        if self.kind == "forward":
            y = _pad((S(1) - S(None, -1)) / s, ax, 0, 1)
        elif self.kind == "backward":
            y = _pad((S(1) - S(None, -1)) / s, ax, 1, 0)
        elif self.order == 3:
            y = _pad((S(2) - S(None, -2)) / (2 * s), ax, 1, 1)
            if self.edge:
                _sl(y, ax, 0, 1).add_((S(1, 2) - S(0, 1)) / s)
                _sl(y, ax, n - 1).add_((S(-1) - S(-2, -1)) / s)
        else:  # centered, 5-point: (x[i-2] - 8x[i-1] + 8x[i+1] - x[i+2])/12Δ
            y = _pad((S(None, -4) - 8 * S(1, -3) + 8 * S(3, -1) - S(4))
                     / (12 * s), ax, 2, 2)
            if self.edge:
                _sl(y, ax, 0, 1).add_((S(1, 2) - S(0, 1)) / s)
                _sl(y, ax, 1, 2).add_((S(2, 3) - S(0, 1)) / (2 * s))
                _sl(y, ax, n - 2, n - 1).add_((S(-1) - S(-3, -2)) / (2 * s))
                _sl(y, ax, n - 1).add_((S(-1) - S(-2, -1)) / s)
        return y.reshape(-1)

    def _rmatvec(self, x):
        v = x.reshape(self.dims_nd)
        ax, s = self.axis, self.sampling
        n = v.shape[ax]

        def S(a=None, b=None):
            return _sl(v, ax, a, b)

        def P(t, a, b):
            return _pad(t, ax, a, b)

        if self.kind in ("forward", "backward"):
            c = (S(None, -1) if self.kind == "forward" else S(1)) / s
            y = P(c, 1, 0) - P(c, 0, 1)
        elif self.order == 3:
            c = S(1, -1) / (2 * s)
            y = P(c, 2, 0) - P(c, 0, 2)
            if self.edge:
                v0, vl = S(0, 1), S(-1)
                _sl(y, ax, 0, 1).add_(-v0 / s)
                _sl(y, ax, 1, 2).add_(v0 / s)
                _sl(y, ax, n - 2, n - 1).add_(-vl / s)
                _sl(y, ax, n - 1).add_(vl / s)
        else:
            c = S(2, -2) / (12 * s)
            y = P(c, 0, 4) - 8 * P(c, 1, 3) + 8 * P(c, 3, 1) - P(c, 4, 0)
            if self.edge:
                v0, v1 = S(0, 1), S(1, 2)
                v2l, vl = S(-2, -1), S(-1)
                _sl(y, ax, 0, 1).add_(-v0 / s)
                _sl(y, ax, 1, 2).add_(v0 / s)
                _sl(y, ax, 0, 1).add_(-v1 / (2 * s))
                _sl(y, ax, 2, 3).add_(v1 / (2 * s))
                _sl(y, ax, n - 3, n - 2).add_(-v2l / (2 * s))
                _sl(y, ax, n - 1).add_(v2l / (2 * s))
                _sl(y, ax, n - 2, n - 1).add_(-vl / s)
                _sl(y, ax, n - 1).add_(vl / s)
        return y.reshape(-1)


class SecondDerivative(LocalOperator):
    """3-point second derivative along ``axis``, all three pylops kinds
    (JAX package ``ops/local.py:417-471``; ``edge`` affects centered
    only). Core ``d[i] = x[i] - 2 x[i+1] + x[i+2]`` placed at row ``i``
    (forward), ``i+1`` (centered) or ``i+2`` (backward)."""

    # row offset of the stencil core within the output, per kind
    _CORE_OFFSET = {"forward": (0, 2), "centered": (1, 1), "backward": (2, 0)}

    def __init__(self, dims, axis: int = 0, sampling: float = 1.0,
                 kind: str = "centered", edge: bool = False, dtype=None):
        self.dims_nd = tuple(int(d) for d in np.atleast_1d(dims))
        self.axis = axis % len(self.dims_nd)
        self.sampling = sampling
        if kind not in ("forward", "backward", "centered"):
            raise NotImplementedError(
                "'kind' must be 'forward', 'centered' or 'backward'")
        self.kind, self.edge = kind, edge
        super().__init__(self.dims_nd, self.dims_nd, dtype=dtype)

    def _matvec(self, x):
        v = x.reshape(self.dims_nd)
        ax, s2 = self.axis, self.sampling ** 2
        n = v.shape[ax]

        def S(a=None, b=None):
            return _sl(v, ax, a, b)

        before, after = self._CORE_OFFSET[self.kind]
        y = _pad((S(None, -2) - 2 * S(1, -1) + S(2)) / s2, ax, before, after)
        if self.kind == "centered" and self.edge:
            _sl(y, ax, 0, 1).add_((S(0, 1) - 2 * S(1, 2) + S(2, 3)) / s2)
            _sl(y, ax, n - 1).add_((S(-3, -2) - 2 * S(-2, -1) + S(-1)) / s2)
        return y.reshape(-1)

    def _rmatvec(self, x):
        v = x.reshape(self.dims_nd)
        ax, s2 = self.axis, self.sampling ** 2
        n = v.shape[ax]
        before, after = self._CORE_OFFSET[self.kind]
        # the adjoint spreads each output row back over its 3 input rows
        c = _sl(v, ax, before, n - after) / s2
        y = _pad(c, ax, 0, 2) - 2 * _pad(c, ax, 1, 1) + _pad(c, ax, 2, 0)
        if self.kind == "centered" and self.edge:
            v0, vl = _sl(v, ax, 0, 1), _sl(v, ax, n - 1)
            for i, k in ((0, 1), (1, -2), (2, 1)):
                _sl(y, ax, i, i + 1).add_(k * v0 / s2)
                _sl(y, ax, n - 3 + i, n - 2 + i).add_(k * vl / s2)
        return y.reshape(-1)


class Laplacian(LocalOperator):
    """Weighted sum of centered second derivatives along ``axes``
    (JAX package ``ops/local.py:474-490``)."""

    def __init__(self, dims, axes=(-2, -1), weights=(1, 1),
                 sampling=(1, 1), dtype=None):
        dims = tuple(int(d) for d in np.atleast_1d(dims))
        self.ops = [SecondDerivative(dims, axis=ax, sampling=s, dtype=dtype)
                    for ax, s in zip(axes, sampling)]
        self.weights = tuple(weights)
        super().__init__(dims, dims, dtype=dtype)

    def _matvec(self, x):
        return sum(w * op._matvec(x) for w, op in zip(self.weights, self.ops))

    def _rmatvec(self, x):
        return sum(np.conj(w) * op._rmatvec(x)
                   for w, op in zip(self.weights, self.ops))


class VStack(LocalOperator):
    """Vertical stack ``[A0; A1; ...]`` of operators sharing one model
    (JAX package ``ops/local.py:494-512``)."""

    def __init__(self, ops, dtype=None):
        self.ops = list(ops)
        if len({op.shape[1] for op in self.ops}) != 1:
            raise ValueError("column size mismatch in VStack")
        self.nrows = [op.shape[0] for op in self.ops]
        super().__init__((self.ops[0].shape[1],), (sum(self.nrows),),
                         dtype=dtype or result_dtype(
                             *[o.dtype for o in self.ops]))

    def _matvec(self, x):
        return torch.cat([op.matvec(x) for op in self.ops])

    def _rmatvec(self, x):
        parts = torch.split(x, self.nrows)
        return sum(op.rmatvec(p) for op, p in zip(self.ops, parts))


class HStack(LocalOperator):
    """Horizontal stack ``[A0, A1, ...]`` of operators sharing one data
    space (JAX package ``ops/local.py:515-533``)."""

    def __init__(self, ops, dtype=None):
        self.ops = list(ops)
        if len({op.shape[0] for op in self.ops}) != 1:
            raise ValueError("row size mismatch in HStack")
        self.ncols = [op.shape[1] for op in self.ops]
        super().__init__((sum(self.ncols),), (self.ops[0].shape[0],),
                         dtype=dtype or result_dtype(
                             *[o.dtype for o in self.ops]))

    def _matvec(self, x):
        parts = torch.split(x, self.ncols)
        return sum(op.matvec(p) for op, p in zip(self.ops, parts))

    def _rmatvec(self, x):
        return torch.cat([op.rmatvec(x) for op in self.ops])


class BlockDiag(LocalOperator):
    """Block-diagonal operator (JAX package ``ops/local.py:536-557``)."""

    def __init__(self, ops, dtype=None):
        self.ops = list(ops)
        self.nrows = [op.shape[0] for op in self.ops]
        self.ncols = [op.shape[1] for op in self.ops]
        super().__init__((sum(self.ncols),), (sum(self.nrows),),
                         dtype=dtype or result_dtype(
                             *[o.dtype for o in self.ops]))

    def _matvec(self, x):
        return torch.cat([op.matvec(p) for op, p in
                          zip(self.ops, torch.split(x, self.ncols))])

    def _rmatvec(self, x):
        return torch.cat([op.rmatvec(p) for op, p in
                          zip(self.ops, torch.split(x, self.nrows))])


class FFT(LocalOperator):
    """1-D FFT along ``axis`` of an N-D layout (JAX package
    ``ops/local.py:560-652``), with pylops' conventions:
    ``norm="ortho"`` and, for ``real=True``, the √2 scaling of the
    bins ``1 .. _double_hi-1`` (every bin but DC and an even ``nfft``'s
    Nyquist bin) that makes the half-spectrum operator an isometry.
    ``nfft`` pads (or cuts) the transformed axis, whose adjoint crops
    back to ``dims[axis]``; ``ifftshift_before`` shifts the input before
    the transform (and the adjoint's output after it). The operator
    dtype is the complex dtype of the width of ``dtype``.

    The adjoint of the real transform zeroes the imaginary parts of the
    DC bin and of an even ``nfft``'s Nyquist bin before ``irfft``: the
    CPU's FFT ignores them, while cuFFT does not define its result for
    them, and the half-spectra the adjoint receives (from
    ``MPIFredholm1.H`` in MDC) carry them.

    ``planes=True`` (the JAX package's plane-pair layout for TPUs with
    no complex support, ``ops/dft.py``) is not ported."""

    def __init__(self, dims, axis: int = 0, nfft: Optional[int] = None,
                 real: bool = True, ifftshift_before: bool = False,
                 dtype=None, planes: bool = False):
        if planes:
            raise NotImplementedError(
                "FFT(planes=True) is not ported: the port keeps complex "
                "half-spectra")
        dims = tuple(int(d) for d in np.atleast_1d(dims))
        self.dims_nd = dims
        self.axis = axis % len(dims)
        self.nfft = int(nfft or dims[self.axis])
        self.real = real
        self.ifftshift_before = bool(ifftshift_before)
        nf = self.nfft // 2 + 1 if real else self.nfft
        dimsd = list(dims)
        dimsd[self.axis] = nf
        self.dimsd_nd = tuple(dimsd)
        # bins 1..nf-1 except the Nyquist bin of an even nfft
        self._double_hi = nf - 1 if self.nfft % 2 == 0 else nf
        wide = (as_torch_dtype(dtype) or torch.float32).itemsize >= 8
        super().__init__(dims, self.dimsd_nd,
                         dtype=torch.complex128 if wide else torch.complex64)

    def _scale_pos(self, y, factor):
        """``y`` with the bins ``1 .. _double_hi-1`` times ``factor`` (a
        new tensor)."""
        nf = self.dimsd_nd[self.axis]
        fac = torch.ones(nf, dtype=y.real.dtype, device=y.device)
        fac[1:self._double_hi] = factor
        shape = [1] * len(self.dimsd_nd)
        shape[self.axis] = nf
        return y * fac.reshape(shape)

    def _matvec(self, x):
        v = x.reshape(self.dims_nd)
        if self.ifftshift_before:
            v = torch.fft.ifftshift(v, dim=self.axis)
        if self.real:
            y = torch.fft.rfft(v.real, n=self.nfft, dim=self.axis,
                               norm="ortho")
            y = self._scale_pos(y, math.sqrt(2.0))
        else:
            y = torch.fft.fft(v, n=self.nfft, dim=self.axis, norm="ortho")
        return y.reshape(-1)

    def _rmatvec(self, x):
        v = x.reshape(self.dimsd_nd)
        if self.real:
            # adjoint of the (√2-scaled) rfft: halve the doubled bins and
            # let irfft's Hermitian extension supply the other half
            v = self._scale_pos(v, 1.0 / math.sqrt(2.0))
            if v.is_complex():
                im = torch.view_as_real(v).select(-1, 1)
                _sl(im, self.axis, 0, 1).zero_()
                if self.nfft % 2 == 0:
                    _sl(im, self.axis, -1).zero_()
            y = torch.fft.irfft(v, n=self.nfft, dim=self.axis, norm="ortho")
        else:
            y = torch.fft.ifft(v, n=self.nfft, dim=self.axis, norm="ortho")
        y = _sl(y, self.axis, 0, self.dims_nd[self.axis])
        if self.ifftshift_before:
            y = torch.fft.fftshift(y, dim=self.axis)
        return y.reshape(-1)


class Conv1D(LocalOperator):
    """Stationary 1-D convolution with the filter ``h`` along ``axis``
    (zero-phase placement via ``offset``; JAX package
    ``ops/local.py:655-688``): ``y[i] = Σ_k h[k] x[i + offset - k]``.
    The adjoint is the correlation, i.e. the convolution with the
    reversed conjugate filter at the mirrored offset ``nh - 1 - offset``.

    Runs as one ``torch.nn.functional.conv1d`` over the traces (the
    JAX package builds a ``(batch, n, nh)`` patch tensor instead, ``nh``
    times the field). ``h`` is a tensor (kept on its device) or a numpy
    array (placed on ``device``, default ``"cuda"``)."""

    def __init__(self, dims, h, axis: int = 0, offset: int = 0, dtype=None,
                 device: DeviceLike = None):
        dims = tuple(int(d) for d in np.atleast_1d(dims))
        self.dims_nd = dims
        self.axis = axis % len(dims)
        self.h = h = _tensor(h, device)
        self.offset = int(offset)
        super().__init__(dims, dims, dtype=dtype or h.dtype)

    def _conv(self, x, weight, lo):
        """Cross-correlation of each trace, zero-padded by ``lo`` samples
        before and ``nh - 1 - lo`` after, with ``weight``."""
        n = self.dims_nd[self.axis]
        v = torch.movedim(x.reshape(self.dims_nd), self.axis, -1)
        shp = v.shape
        nh = weight.shape[0]
        p = max(lo, nh - 1 - lo)  # conv1d pads symmetrically
        y = F.conv1d(v.reshape(-1, 1, n),
                     weight.to(v.dtype).reshape(1, 1, nh), padding=p)
        y = y[:, 0, p - lo: p - lo + n]
        return torch.movedim(y.reshape(shp), -1, self.axis).reshape(-1)

    def _matvec(self, x):
        nh = self.h.shape[0]
        return self._conv(x, torch.flip(self.h, (0,)), nh - 1 - self.offset)

    def _rmatvec(self, x):
        return self._conv(x, self.h.conj(), self.offset)


class NonStationaryConvolve1D(LocalOperator):
    """1-D non-stationary convolution along ``axis`` with a bank of
    compact odd-length filters ``hs`` (``(nfilt, nh)``) defined at the
    regularly spaced samples ``ih`` and linearly interpolated per sample
    (JAX package ``ops/local.py:691-754``; the rank-local block of
    ``ops/nonstatconv.py``). The per-sample bank ``Hbank`` (``(n, nh)``)
    is built as the JAX package builds it: ``i0`` clipped, the weight
    clipped to [0, 1], so the nearest filter holds outside
    ``[ih[0], ih[-1]]``.

    The forward spreads each input sample through its own filter,
    ``y[i - nh//2 + j] += Hbank[i, j] · x[i]``; the adjoint gathers,
    ``x[i] = Σ_j conj(Hbank[i, j]) · y[i - nh//2 + j]``. Both are a
    per-row stencil ``y[k] = Σ_d W[k, d] · x[k + d - nh//2]`` (the
    forward's ``W[k, d] = Hbank[k + d - nh//2, nh-1-d]``), applied as
    one batched product: the rows are cut into tiles of ``T``, and tile
    ``b`` is a banded ``(T, T + nh - 1)`` matrix times the overlapping
    window of ``T + nh - 1`` input rows (a strided view of the
    zero-padded input), so an apply reads the field about
    ``(T + nh - 1) / T`` times and never forms an ``(n, traces, nh)``
    tensor (the JAX package sums ``nh`` shifted passes instead).
    ``hs`` is a tensor (kept on its device) or an array (placed on
    ``device``, default ``"cuda"``)."""

    _TILE = 64

    def __init__(self, dims, hs, ih, axis: int = -1, dtype=None,
                 device: DeviceLike = None):
        dims = tuple(int(d) for d in np.atleast_1d(dims))
        self.dims_nd = dims
        self.axis = axis % len(dims)
        hs = _tensor(hs, device)
        ih = np.asarray(ih)
        if hs.shape[1] % 2 == 0:
            raise ValueError("filters hs must have odd length")
        if len(np.unique(np.diff(ih))) > 1:
            raise ValueError(
                "the indices of filters 'ih' are must be regularly sampled")
        self.hs, self.ih = hs, ih
        self.nh = nh = int(hs.shape[1])
        super().__init__(dims, dims, dtype=dtype or hs.dtype)
        n = dims[self.axis]
        # per-sample interpolated bank (n, nh), in f64 arithmetic as the
        # JAX package's numpy weights make it
        pos = np.arange(n, dtype=float)
        dh = float(ih[1] - ih[0]) if len(ih) > 1 else 1.0
        q = (pos - ih[0]) / dh
        i0 = np.clip(np.floor(q).astype(int), 0,
                     len(ih) - 2 if len(ih) > 1 else 0)
        if len(ih) > 1:
            w = torch.from_numpy(np.clip(q - i0, 0.0, 1.0)[:, None]).to(
                hs.device)
            i0 = torch.from_numpy(i0).to(hs.device)
            bank = hs[i0] * (1 - w) + hs[i0 + 1] * w
        else:
            bank = hs[0].expand(n, nh)
        self.Hbank = bank.to(self.dtype)
        half = nh // 2
        k = torch.arange(n, device=hs.device)[:, None]
        d = torch.arange(nh, device=hs.device)[None, :]
        padded = F.pad(self.Hbank, (0, 0, half, half))
        self._tiles_fwd = self._tiles(padded[k + d, nh - 1 - d])
        self._tiles_adj = self._tiles(self.Hbank.conj())

    def _tiles(self, weights: torch.Tensor) -> torch.Tensor:
        """The ``(nb, T, T + nh - 1)`` banded tiles of the stencil
        ``weights`` (``(n, nh)``): tile ``b``'s row ``r`` holds
        ``weights[b·T + r]`` from column ``r`` on; rows past ``n`` are
        zero."""
        n, nh = weights.shape
        T = min(self._TILE, n)
        nb = -(-n // T)
        M = weights.new_zeros((nb, T, T + nh - 1))
        r = torch.arange(T, device=weights.device)[:, None]
        cols = r + torch.arange(nh, device=weights.device)[None, :]
        M[:, r, cols] = F.pad(weights, (0, 0, 0, nb * T - n)).view(nb, T, nh)
        return M

    def _apply(self, x, tiles):
        n, nh = self.dims_nd[self.axis], self.nh
        half = nh // 2
        nb, T, _ = tiles.shape
        v = torch.movedim(x.reshape(self.dims_nd), self.axis, 0)
        shp = v.shape
        dt = torch.promote_types(tiles.dtype, v.dtype)
        # the input with nh//2 zero rows before it and enough after it
        # for the last tile's window
        vp = F.pad(v.reshape(n, -1).to(dt), (0, 0, half, nb * T - n + half))
        ntr = vp.shape[1]
        windows = vp.as_strided((nb, T + nh - 1, ntr), (T * ntr, ntr, 1))
        y = torch.bmm(tiles.to(dt), windows).view(nb * T, ntr)[:n]
        return torch.movedim(y.reshape(shp), 0, self.axis).reshape(-1)

    def _matvec(self, x):
        return self._apply(x, self._tiles_fwd)

    def _rmatvec(self, x):
        return self._apply(x, self._tiles_adj)


# the matrix of a MatrixMult block is its parameter
from ..linearoperator import register_operator_params  # noqa: E402

register_operator_params(MatrixMult, "A")
