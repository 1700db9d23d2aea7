"""Distributed derivative operators.

PyTorch counterpart of ``pylops_mpi_tpu/ops/derivatives.py`` (the
reference's ``FirstDerivative.py``, ``SecondDerivative.py``,
``Laplacian.py`` and ``Gradient.py``). Distribution is along axis 0 of
the N-D layout, as in the reference.

The axis-0 stencils of ``MPIFirstDerivative``, ``MPISecondDerivative``
and ``MPIGradient``'s axis-0 component take the explicit path of the
JAX package (``_apply_explicit``): the ``y = Z·S x + E x`` decomposition
of :func:`_stencil_spec`, with the interior stencil ``S`` in one pass of
the tap kernel (:func:`.stencil_kernels.stencil_taps`). With a world of
one the halo rows beyond the field are zeros, which the kernel reads as
absent pieces of its slab, so the field is never copied into a padded
slab; the ``Z`` rows are the kernel's ``out_pad`` (forward) or absent
input rows (adjoint), and the sparse ``edge=True`` matrix ``E`` is added
in place on its O(1) rows. Non-axis-0 stencils, non-floating dtypes and
fields shorter than the stencil's span take the local operator
(``ops/local.py``), as in the JAX package. ``MPILaplacian`` keeps the
JAX package's local formulation and does not run the kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..distributedarray import DistributedArray, Partition
from ..linearoperator import MPILinearOperator
from ..stacked import StackedDistributedArray
from . import stencil_kernels
from ._precision import as_torch_dtype
from .local import FirstDerivative as _LocalFirst
from .local import SecondDerivative as _LocalSecond
from .stack import MPIStackedVStack

__all__ = ["MPIFirstDerivative", "MPISecondDerivative", "MPILaplacian",
           "MPIGradient"]


def _tuplize(dims) -> Tuple[int, ...]:
    return tuple(int(d) for d in np.atleast_1d(dims))


def _stencil_spec(op) -> Optional[dict]:
    """Every supported axis-0 stencil as ``y = Z · S x + E x``.

    ``S`` is the pure interior stencil with a zero boundary condition
    (``taps``: input offset → coefficient), ``Z`` zeroes the first
    ``lo_z`` / last ``hi_z`` output rows, and ``E`` is the sparse
    ``edge=True`` boundary matrix as ``(out, in, coeff)`` triples with
    rows addressed as ``("lo", i)`` = global row ``i`` or ``("hi", i)``
    = global row ``n-1-i``. The adjoint is ``Sᵀ·Z`` (zero the masked
    input rows, run the offset-reversed taps) plus ``Eᴴ`` (the
    transposed triples). ``w`` is the halo width, max |tap offset|.
    The tables are the JAX package's (``ops/derivatives.py:45-114``)."""
    s = float(op.sampling)
    if isinstance(op, _LocalFirst):
        if op.kind == "forward":
            return dict(w=1, taps={1: 1 / s, 0: -1 / s},
                        lo_z=0, hi_z=1, edge=[])
        if op.kind == "backward":
            return dict(w=1, taps={0: 1 / s, -1: -1 / s},
                        lo_z=1, hi_z=0, edge=[])
        if op.order == 3:
            spec = dict(w=1, taps={1: 1 / (2 * s), -1: -1 / (2 * s)},
                        lo_z=1, hi_z=1, edge=[])
            if op.edge:
                spec["edge"] = [
                    (("lo", 0), ("lo", 1), 1 / s),
                    (("lo", 0), ("lo", 0), -1 / s),
                    (("hi", 0), ("hi", 0), 1 / s),
                    (("hi", 0), ("hi", 1), -1 / s)]
            return spec
        c = 1 / (12 * s)  # centered 5-point
        spec = dict(w=2, taps={-2: c, -1: -8 * c, 1: 8 * c, 2: -c},
                    lo_z=2, hi_z=2, edge=[])
        if op.edge:
            spec["edge"] = [
                (("lo", 0), ("lo", 1), 1 / s),
                (("lo", 0), ("lo", 0), -1 / s),
                (("lo", 1), ("lo", 2), 1 / (2 * s)),
                (("lo", 1), ("lo", 0), -1 / (2 * s)),
                (("hi", 1), ("hi", 0), 1 / (2 * s)),
                (("hi", 1), ("hi", 2), -1 / (2 * s)),
                (("hi", 0), ("hi", 0), 1 / s),
                (("hi", 0), ("hi", 1), -1 / s)]
        return spec
    if isinstance(op, _LocalSecond):
        s2 = s * s
        if op.kind == "forward":
            return dict(w=2, taps={0: 1 / s2, 1: -2 / s2, 2: 1 / s2},
                        lo_z=0, hi_z=2, edge=[])
        if op.kind == "backward":
            return dict(w=2, taps={0: 1 / s2, -1: -2 / s2, -2: 1 / s2},
                        lo_z=2, hi_z=0, edge=[])
        spec = dict(w=1, taps={-1: 1 / s2, 0: -2 / s2, 1: 1 / s2},
                    lo_z=1, hi_z=1, edge=[])
        if op.edge:
            spec["edge"] = [
                (("lo", 0), ("lo", 0), 1 / s2),
                (("lo", 0), ("lo", 1), -2 / s2),
                (("lo", 0), ("lo", 2), 1 / s2),
                (("hi", 0), ("hi", 2), 1 / s2),
                (("hi", 0), ("hi", 1), -2 / s2),
                (("hi", 0), ("hi", 0), 1 / s2)]
        return spec
    return None


def _scatter(x: DistributedArray) -> DistributedArray:
    """The reference's BROADCAST → SCATTER input conversion
    (ref ``FirstDerivative.py:128-132``): with one worker both hold the
    same global tensor."""
    if x.partition in (Partition.BROADCAST, Partition.UNSAFE_BROADCAST):
        return DistributedArray.to_dist(x.array)
    return x


class _StencilOperator(MPILinearOperator):
    """Flat vector in → N-D stencil → flat vector out, SCATTER along
    axis 0, with the explicit kernel path for axis-0 stencils."""

    def __init__(self, dims, dtype=None):
        self.dims_nd = _tuplize(dims)
        n = int(np.prod(self.dims_nd))
        self.dims = self.dimsd = self.dims_nd
        super().__init__(shape=(n, n),
                         dtype=as_torch_dtype(dtype) or torch.float64)

    def _local_op(self):
        raise NotImplementedError

    def _apply(self, x: DistributedArray, forward: bool) -> DistributedArray:
        # x is a 1-D vector here: matvec/rmatvec apply block (2-D)
        # vectors column by column
        x = _scatter(x)
        arr = self._apply_explicit(x, forward)
        if arr is None:
            op = self._local_op()
            g = x.array.reshape(-1)
            arr = op._matvec(g) if forward else op._rmatvec(g)
        return DistributedArray.to_dist(arr.reshape(-1))

    def _apply_explicit(self, x: DistributedArray,
                        forward: bool) -> Optional[torch.Tensor]:
        """The axis-0 stencil as one tap-kernel pass plus the O(1)
        ``edge`` rows (JAX package ``ops/derivatives.py:202-380``, with
        one worker); ``None`` (local operator) for non-axis-0 stencils,
        non-floating dtypes, or a field shorter than the stencil's
        span."""
        op = self._local_op()
        if op.axis != 0:
            return None
        spec = _stencil_spec(op)
        n0 = self.dims_nd[0]
        w = spec["w"]
        # the boundary rows of the edge corrections read a 3-row span
        min_rows = max(w, 3) if spec["edge"] else w
        if n0 < min_rows or not x.dtype.is_floating_point:
            return None
        b = x.array.reshape(self.dims_nd)
        # Z's zero rows, clipped to the field: [0, lo) and [n0 - hi, n0)
        lo = min(spec["lo_z"], n0)
        hi = min(spec["hi_z"], n0 - lo)
        if forward:
            taps = sorted(spec["taps"].items())
            # output rows [lo, n0 - hi) read input rows [lo - w, n0 - hi + w),
            # zeros beyond the field
            y = stencil_kernels.stencil_taps(
                b[max(0, lo - w): min(n0, n0 - hi + w)], taps, w,
                out_pad=(lo, hi), top=max(0, w - lo), bottom=max(0, w - hi))
            triples = spec["edge"]
        else:
            # (Z·S)ᴴ = Sᵀ·Z: the masked input rows are absent (zero) pieces
            taps = sorted((-d, c) for d, c in spec["taps"].items())
            y = stencil_kernels.stencil_taps(b[lo:n0 - hi], taps, w,
                                             top=w + lo, bottom=hi + w)
            triples = [(i, o, c) for (o, i, c) in spec["edge"]]
        for (oside, oi), (iside, ii), coef in triples:
            orow = oi if oside == "lo" else n0 - 1 - oi
            irow = ii if iside == "lo" else n0 - 1 - ii
            y[orow] += coef * b[irow]
        return y

    def _matvec(self, x: DistributedArray) -> DistributedArray:
        return self._apply(x, True)

    def _rmatvec(self, x: DistributedArray) -> DistributedArray:
        return self._apply(x, False)


class MPIFirstDerivative(_StencilOperator):
    """First derivative along axis 0
    (ref ``basicoperators/FirstDerivative.py:18-318``): forward /
    backward / centered stencils of order 3 or 5, with ``edge`` handling
    at the domain boundary."""

    def __init__(self, dims, sampling: float = 1.0, kind: str = "centered",
                 edge: bool = False, order: int = 3, dtype=torch.float64):
        super().__init__(dims, dtype=dtype)
        self.sampling = sampling
        self.kind = kind
        self.edge = edge
        self.order = order
        if kind not in ("forward", "backward", "centered"):
            raise NotImplementedError(
                "'kind' must be 'forward', 'centered', or 'backward'")
        self._op = _LocalFirst(self.dims_nd, axis=0, sampling=sampling,
                               kind=kind, edge=edge, order=order, dtype=dtype)

    def _local_op(self):
        return self._op


class MPISecondDerivative(_StencilOperator):
    """Second derivative along axis 0
    (ref ``basicoperators/SecondDerivative.py:13-256``): forward /
    backward / centered 3-point stencils; ``edge`` adds the one-sided
    boundary rows for centered."""

    def __init__(self, dims, sampling: float = 1.0, kind: str = "centered",
                 edge: bool = False, dtype=torch.float64):
        super().__init__(dims, dtype=dtype)
        self.sampling = sampling
        self.kind = kind
        self.edge = edge
        self._op = _LocalSecond(self.dims_nd, axis=0, sampling=sampling,
                                kind=kind, edge=edge, dtype=dtype)

    def _local_op(self):
        return self._op


class MPILaplacian(_StencilOperator):
    """Laplacian: weighted sum of second derivatives along ``axes``
    (ref ``basicoperators/Laplacian.py:15-126``). As in the JAX package
    it applies the local second derivatives to the whole field and does
    not run the tap kernel."""

    def __init__(self, dims, axes=(-2, -1), weights=(1, 1), sampling=(1, 1),
                 kind: str = "centered", edge: bool = False,
                 dtype=torch.float64):
        super().__init__(dims, dtype=dtype)
        axes = tuple(ax % len(self.dims_nd) for ax in axes)
        if not (len(axes) == len(weights) == len(sampling)):
            raise ValueError("axes, weights, and sampling have different size")
        self.axes, self.weights = axes, tuple(weights)
        self.sampling = tuple(sampling)
        self.kind, self.edge = kind, edge
        self._ops = [_LocalSecond(self.dims_nd, axis=ax, sampling=s,
                                  kind=kind, edge=edge, dtype=dtype)
                     for ax, s in zip(axes, sampling)]

    def _apply(self, x: DistributedArray, forward: bool) -> DistributedArray:
        g = _scatter(x).array.reshape(-1)
        if forward:
            arr = sum(w * op._matvec(g) for w, op in zip(self.weights, self._ops))
        else:
            arr = sum(np.conj(w) * op._rmatvec(g)
                      for w, op in zip(self.weights, self._ops))
        return DistributedArray.to_dist(arr)


class _AxisFirstDerivative(_StencilOperator):
    """First derivative along any axis of the axis-0-sharded layout
    (the reference runs non-0 axes as rank-local pylops operators inside
    MPIBlockDiag, ref ``Gradient.py:88-97``)."""

    def __init__(self, dims, axis, sampling, kind, edge, dtype=torch.float64):
        super().__init__(dims, dtype=dtype)
        self._op = _LocalFirst(self.dims_nd, axis=axis, sampling=sampling,
                               kind=kind, edge=edge, dtype=dtype)

    def _local_op(self):
        return self._op


class MPIGradient(MPILinearOperator):
    """Gradient: vertical stack of first derivatives along every axis
    (ref ``basicoperators/Gradient.py:21-118``). The output is a
    :class:`StackedDistributedArray` with one component per axis."""

    def __init__(self, dims, sampling=1, kind: str = "centered",
                 edge: bool = False, dtype=torch.float64):
        self.dims_nd = _tuplize(dims)
        ndims = len(self.dims_nd)
        # a float spacing: an int cast would truncate e.g. 0.5 to 0
        sampling = tuple(float(s) for s in np.atleast_1d(sampling))
        if len(sampling) == 1:
            sampling = sampling * ndims
        if len(sampling) != ndims:
            raise ValueError(
                f"sampling must have 1 or {ndims} entries, got {len(sampling)}")
        self.sampling = sampling
        self.kind = kind
        self.edge = edge
        stack = MPIStackedVStack([
            _AxisFirstDerivative(self.dims_nd, axis=ax, sampling=sampling[ax],
                                 kind=kind, edge=edge, dtype=dtype)
            for ax in range(ndims)])
        super().__init__(shape=stack.shape, dtype=dtype)
        self.Op = stack  # after super().__init__, which resets self.Op
        self.dims = self.dimsd = self.dims_nd

    def _matvec(self, x: DistributedArray) -> StackedDistributedArray:
        return self.Op._matvec(x)

    def _rmatvec(self, x: StackedDistributedArray) -> DistributedArray:
        return self.Op._rmatvec(x)
