"""Local (single logical block) linear operators on tensors.

PyTorch counterpart of the operator protocol, ``MatrixMult``,
``Identity``, ``FunctionOperator``, the derivative stencils,
``Laplacian``, ``FFT`` and ``Conv1D`` of ``pylops_mpi_tpu/ops/local.py``:
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

from ._precision import as_torch_dtype
from ..parallel.mesh import DeviceLike, resolve_device

__all__ = ["LocalOperator", "MatrixMult", "Identity", "FunctionOperator",
           "FirstDerivative", "SecondDerivative", "Laplacian", "FFT",
           "Conv1D"]


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
        if isinstance(h, torch.Tensor):
            if device is not None:
                h = h.to(resolve_device(device))
        else:
            h = torch.tensor(np.asarray(h)).to(resolve_device(device))
        self.h = h
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
