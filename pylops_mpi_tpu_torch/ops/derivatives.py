"""Distributed derivative operators.

PyTorch counterpart of ``pylops_mpi_tpu/ops/derivatives.py`` (the
reference's ``FirstDerivative.py``, ``SecondDerivative.py``,
``Laplacian.py`` and ``Gradient.py``). The N-D field is sharded along
axis 0 over the ranks (the balanced row split, flattened), as in the
reference.

The axis-0 stencils of ``MPIFirstDerivative``, ``MPISecondDerivative``,
``MPIGradient``'s axis-0 component and, across ranks, ``MPILaplacian``'s
axis-0 term take the explicit path of the JAX package
(``_apply_explicit``): the ``y = Z·S x + E x`` decomposition of
:func:`_stencil_spec`, with the interior stencil ``S`` in one pass of
the tap kernel (:func:`.stencil_kernels.stencil_taps`). Each rank's
ghost rows come from :func:`~..parallel.collectives.halo_exchange` and
go into the kernel as the ``top``/``bottom`` pieces of its slab as they
were received; beyond the field (the first rank's top, the last rank's
bottom, and both sides with one rank) they are counts of zero rows, so
no padded copy of the field is ever made. The ``Z`` rows are the
kernel's ``out_pad`` (forward) or absent input rows (adjoint) on the
first and last ranks, and the sparse ``edge=True`` matrix ``E`` is added
in place on its O(1) rows there.

With overlap on (``overlap=``, ``PYLOPS_MPI_TPU_TORCH_OVERLAP``; the
JAX package's ``:297-347``), across ranks whose every shard holds at
least ``2w`` rows, the ghost rows are posted first
(:func:`~..parallel.collectives.ring_halo_ghosts`), the tap kernel runs
on the shard with zero ghosts (the interior, exact everywhere but the
first and last ``w`` rows) while they are in flight, and after the wait
those ``w`` rows on each side that has a neighbour are recomputed from
the received ghosts by the plain tap sum, as the JAX package patches
them outside Pallas. The masked ``Z`` rows and the ``edge`` triples are
the bulk path's. Shorter shards keep the bulk exchange. ``paths``
counts the overlap path as ``"overlap"`` beside ``"explicit"``.

A rank whose shard is shorter than the span the stencil reads (``w``
rows, or 3 with ``edge``), or a non-floating field, takes the gather
path: the field is gathered, the stencil applied whole, and the rank
keeps its rows (where the JAX package hands the apply to its
partitioner). Stencils along other axes apply the local operator
(``ops/local.py``) to the rank's shard. ``paths`` counts which path
ran. With one rank, ``MPILaplacian`` keeps the JAX package's local
formulation and does not run the kernel.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional, Tuple

import numpy as np
import torch

from ..distributedarray import DistributedArray, Partition
from ..linearoperator import MPILinearOperator
from ..parallel import collectives
from ..parallel.mesh import rank, world_size
from ..parallel.partition import local_split, shard_offsets
from ..stacked import StackedDistributedArray
from . import stencil_kernels
from ._precision import as_torch_dtype
from .local import FirstDerivative as _LocalFirst
from .local import SecondDerivative as _LocalSecond
from .stack import MPIStackedVStack

__all__ = ["MPIFirstDerivative", "MPISecondDerivative", "MPILaplacian",
           "MPIGradient", "paths"]

# applies by path since the last paths.clear(): "explicit" (the tap
# kernel, ghost rows exchanged), "overlap" (those of the explicit applies
# whose ghosts flew while the kernel ran), "gather" (a short shard or a
# non-floating field), "local" (the local operator on the rank's shard
# or, with one rank, on the whole field)
paths: Counter = Counter()


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


def _rows_layout(dims) -> Tuple[Tuple[int, ...], ...]:
    """Flat per-rank sizes of the balanced row split of ``dims``."""
    inner = int(np.prod(dims[1:])) if len(dims) > 1 else 1
    return tuple((int(s[0]) * inner,) for s in
                 local_split(tuple(dims), world_size(), Partition.SCATTER, 0))


def _model_layout(x: DistributedArray, layout) -> DistributedArray:
    """``x`` split as the operators' row layout: the reference's
    BROADCAST → SCATTER input conversion (ref ``FirstDerivative.py:128-132``)
    slices each rank's rows, and a SCATTER vector split otherwise is
    regathered into it."""
    if x.partition in (Partition.BROADCAST, Partition.UNSAFE_BROADCAST):
        return DistributedArray.to_dist(x.array, local_shapes=layout,
                                        mask=x.mask)
    return x._relayout(layout)


class _StencilOperator(MPILinearOperator):
    """Flat vector in → N-D stencil → flat vector out, SCATTER along
    axis 0 by rows, with the explicit kernel path for axis-0 stencils."""

    def __init__(self, dims, dtype=None, overlap=None):
        self.dims_nd = _tuplize(dims)
        n = int(np.prod(self.dims_nd))
        self.dims = self.dimsd = self.dims_nd
        self.local_shapes_m = self.local_shapes_n = _rows_layout(self.dims_nd)
        self._rows = [int(s[0]) for s in local_split(
            self.dims_nd, world_size(), Partition.SCATTER, 0)]
        self._shard_ops = {}
        super().__init__(shape=(n, n),
                         dtype=as_torch_dtype(dtype) or torch.float64)
        # the tuner's seam (JAX ``ops/derivatives.py:150-160``): an
        # overlap left at None, and not pinned by the environment, comes
        # from the plan; ``overlap`` keeps the setting, ``_overlap`` the
        # schedule it resolves to
        from ..utils.deps import overlap_enabled, overlap_env_pinned
        if overlap is None and not overlap_env_pinned():
            from ..tuning import plan as _tuneplan
            tplan = _tuneplan.get_plan("derivative", shape=self.dims_nd,
                                       dtype=self.dtype, n_dev=world_size())
            if tplan is not None and tplan.get("overlap") in ("on", "off"):
                overlap = tplan.get("overlap")
        self.overlap = overlap
        self._overlap = overlap_enabled(overlap)

    def _local_op(self):
        raise NotImplementedError

    def _shard_op(self, rows: int):
        """The local operator on a ``(rows, *dims[1:])`` shard."""
        if rows == self.dims_nd[0]:
            return self._local_op()
        if rows not in self._shard_ops:
            op = self._local_op()
            kw = dict(axis=op.axis, sampling=op.sampling, kind=op.kind,
                      edge=op.edge, dtype=op.dtype)
            if isinstance(op, _LocalFirst):
                kw["order"] = op.order
            self._shard_ops[rows] = type(op)((rows,) + self.dims_nd[1:], **kw)
        return self._shard_ops[rows]

    def _apply(self, x: DistributedArray, forward: bool) -> DistributedArray:
        # x is a 1-D vector here: matvec/rmatvec apply block (2-D)
        # vectors column by column
        x = _model_layout(x, self.local_shapes_m)
        arr = self._apply_shard(x.array, forward)
        return DistributedArray._wrap(arr.reshape(-1), x,
                                      local_shapes=self.local_shapes_n)

    def _apply_shard(self, v: torch.Tensor, forward: bool) -> torch.Tensor:
        """The stencil on this rank's flat shard ``v`` of the row layout;
        returns this rank's output rows (flat)."""
        op = self._local_op()
        P = world_size()
        if P == 1:
            arr = self._apply_explicit(v, forward, 0, self.dims_nd[0], True)
            if arr is None:
                paths["local"] += 1
                arr = op._matvec(v) if forward else op._rmatvec(v)
            else:
                paths["explicit"] += 1
            return arr.reshape(-1)
        rows, r = self._rows, rank()
        if op.axis != 0:
            paths["local"] += 1
            if rows[r] == 0:
                return v
            sop = self._shard_op(rows[r])
            return (sop._matvec(v) if forward else sop._rmatvec(v)).reshape(-1)
        spec = _stencil_spec(op)
        # every rank must hold the halo rows its neighbours read, and with
        # edge corrections the end ranks the 3-row span they read
        min_rows = max(spec["w"], 3) if spec["edge"] else spec["w"]
        if min(rows) >= min_rows and v.dtype.is_floating_point:
            base = shard_offsets(rows)[r]
            paths["explicit"] += 1
            # the JAX gate (``:297``): every shard holds the 2w rows each
            # patch reads locally
            overlap = self._overlap and min(rows) >= 2 * spec["w"] > 0
            return self._apply_explicit(v, forward, base, rows[r], True,
                                        overlap).reshape(-1)
        paths["gather"] += 1
        g = collectives.all_gather(v, [s[0] for s in self.local_shapes_m])
        y = self._apply_explicit(g, forward, 0, self.dims_nd[0], False)
        if y is None:
            y = op._matvec(g) if forward else op._rmatvec(g)
        off = shard_offsets([s[0] for s in self.local_shapes_n])[r]
        return y.reshape(-1)[off:off + self.local_shapes_n[r][0]]

    def _apply_explicit(self, v: torch.Tensor, forward: bool, base: int,
                        nrows: int, exchange: bool,
                        overlap: bool = False) -> Optional[torch.Tensor]:
        """The axis-0 stencil on the ``nrows`` rows from global row
        ``base`` held in ``v``, as one tap-kernel pass with the ghost
        rows (exchanged with the neighbouring ranks when ``exchange``,
        zeros otherwise) plus the O(1) ``edge`` rows (JAX package
        ``ops/derivatives.py:202-381``); ``None`` (local operator) for
        non-axis-0 stencils, or a whole field that is non-floating or
        shorter than the stencil's span. With ``overlap`` the ghosts are
        posted, the kernel runs with zero ghosts, and the ``w`` rows next
        to each neighbour are patched after the wait (module
        docstring)."""
        op = self._local_op()
        if op.axis != 0:
            return None
        spec = _stencil_spec(op)
        n0 = self.dims_nd[0]
        w = spec["w"]
        min_rows = max(w, 3) if spec["edge"] else w
        if nrows == n0 and (n0 < min_rows or not v.dtype.is_floating_point):
            return None
        b = v.reshape((nrows,) + self.dims_nd[1:])
        ghosts = None
        if overlap:
            # ghosts first; the interior pass below takes zero ghosts
            paths["overlap"] += 1
            ghosts = collectives.ring_halo_ghosts(b, w, w)
            top, bottom = w, w
        else:
            top, bottom = (collectives.halo_exchange(b, w, w) if exchange
                           else (w, w))
        lo_z, hi_z = spec["lo_z"], spec["hi_z"]
        # Z's zero rows on this shard: global rows [0, lo_z) and
        # [n0 - hi_z, n0), clipped to the shard (the end ranks only)
        lo = min(max(lo_z - base, 0), nrows)
        hi = min(max(base + nrows - (n0 - hi_z), 0), nrows - lo)
        if forward:
            taps = sorted(spec["taps"].items())
            # output rows [lo, nrows - hi) read rows [lo - w, nrows - hi + w)
            # of [top; b; bottom]
            start, end = lo - w, nrows - hi + w
            tp = 0 if start >= 0 else (
                -start if not isinstance(top, torch.Tensor) else top[w + start:])
            bp = 0 if end <= nrows else (
                end - nrows if not isinstance(bottom, torch.Tensor)
                else bottom[:end - nrows])
            y = stencil_kernels.stencil_taps(
                b[max(start, 0):min(end, nrows)], taps, w, out_pad=(lo, hi),
                top=tp, bottom=bp)
            triples = spec["edge"]
        else:
            # (Z·S)ᴴ = Sᵀ·Z: the masked input rows are absent (zero) pieces,
            # or zeroed in the received ghost rows
            taps = sorted((-d, c) for d, c in spec["taps"].items())
            if isinstance(top, torch.Tensor):
                top[:max(0, min(w, lo_z - (base - w)))] = 0
                tp = top
            else:
                tp = w + lo
            if isinstance(bottom, torch.Tensor):
                first = (n0 - hi_z) - (base + nrows)  # first masked ghost row
                bottom[max(0, first):] = 0
                bp = bottom
            else:
                bp = hi + w
            y = stencil_kernels.stencil_taps(b[lo:nrows - hi], taps, w,
                                             top=tp, bottom=bp)
            triples = [(i, o, c) for (o, i, c) in spec["edge"]]
        if ghosts is not None:
            y = self._patch(y, b, ghosts.wait(), taps, w, forward, base,
                            nrows, lo, hi, spec)
        for (oside, oi), (_, ii), coef in triples:
            # every triple pairs rows of one side: the first rank's first
            # rows or the last rank's last rows
            if oside == "lo" and base == 0:
                y[oi] += coef * b[ii]
            elif oside == "hi" and base + nrows == n0:
                y[nrows - 1 - oi] += coef * b[nrows - 1 - ii]
        return y

    def _patch(self, y: torch.Tensor, b: torch.Tensor, ghosts, taps, w: int,
               forward: bool, base: int, nrows: int, lo: int, hi: int,
               spec: dict) -> torch.Tensor:
        """``y`` of the interior pass with its first ``w`` rows (below a
        previous rank) and last ``w`` rows (above a next rank) recomputed
        from the received ghosts: the plain tap sum over the ``3w``-row
        window ``[ghost; 2w rows]`` (or ``[2w rows; ghost]``), as the JAX
        package's ``tap_rows`` (``:326-347``). The forward's masked rows
        are never among them (a rank with a neighbour on that side has
        no ``Z`` row there); the adjoint zeroes the masked input rows of
        the window and of the ghosts, as the bulk path does."""
        gf, gb = ghosts
        n0 = self.dims_nd[0]
        taps_sum = stencil_kernels.stencil_taps_plain

        def keep(part, first, last):
            # part with its rows outside [first, last) zeroed (the
            # adjoint's masked input rows); the forward masks no input
            if forward or (first <= 0 and last >= part.shape[0]):
                return part
            mask = torch.zeros(part.shape[0], dtype=torch.bool,
                               device=part.device)
            mask[max(first, 0):max(last, 0)] = True
            return torch.where(mask.reshape((-1,) + (1,) * (part.ndim - 1)),
                               part, part.new_zeros(()))

        parts = [y]
        if base > 0:  # ghost t is global row base - w + t: masked < lo_z
            head = torch.cat([keep(gf, spec["lo_z"] - (base - w), w),
                              keep(b[:2 * w], lo, nrows - hi)])
            parts = [taps_sum(head, taps, w), y[w:]]
        if base + nrows < n0:  # ghost t is global base + nrows + t
            tail = torch.cat([keep(b[nrows - 2 * w:], lo - (nrows - 2 * w),
                                   nrows - hi - (nrows - 2 * w)),
                              keep(gb, 0, n0 - spec["hi_z"] - base - nrows)])
            parts[-1] = parts[-1][:parts[-1].shape[0] - w]
            parts.append(taps_sum(tail, taps, w))
        return torch.cat(parts) if len(parts) > 1 else y

    def _matvec(self, x: DistributedArray) -> DistributedArray:
        return self._apply(x, True)

    def _rmatvec(self, x: DistributedArray) -> DistributedArray:
        return self._apply(x, False)


def _record_hier(op, hierarchical) -> None:
    """``op.hierarchical`` (the setting) and ``op._hier`` (what it
    resolves to on this world); the exchange does not change with them."""
    from ..utils.deps import hierarchical_active
    op.hierarchical = hierarchical
    op._hier = hierarchical_active(hierarchical)


class MPIFirstDerivative(_StencilOperator):
    """First derivative along axis 0
    (ref ``basicoperators/FirstDerivative.py:18-318``): forward /
    backward / centered stencils of order 3 or 5, with ``edge`` handling
    at the domain boundary. ``overlap`` selects the overlap path across
    ranks (module docstring). ``hierarchical`` is recorded
    (``.hierarchical``, and ``._hier`` what it resolves to on this world):
    the ghost exchange between neighbours is the same on a world laid
    out hosts × ranks, as the JAX package's hybrid stencil kernels are
    bit for bit its flat ones, and its bytes split by fabric pair by pair
    whatever the setting; ``off`` changes nothing."""

    def __init__(self, dims, sampling: float = 1.0, kind: str = "centered",
                 edge: bool = False, order: int = 3, dtype=torch.float64,
                 overlap=None, hierarchical=None):
        super().__init__(dims, dtype=dtype, overlap=overlap)
        _record_hier(self, hierarchical)
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
    boundary rows for centered. ``overlap`` and ``hierarchical`` as
    :class:`MPIFirstDerivative`'s."""

    def __init__(self, dims, sampling: float = 1.0, kind: str = "centered",
                 edge: bool = False, dtype=torch.float64, overlap=None,
                 hierarchical=None):
        super().__init__(dims, dtype=dtype, overlap=overlap)
        _record_hier(self, hierarchical)
        self.sampling = sampling
        self.kind = kind
        self.edge = edge
        self._op = _LocalSecond(self.dims_nd, axis=0, sampling=sampling,
                                kind=kind, edge=edge, dtype=dtype)

    def _local_op(self):
        return self._op


class MPILaplacian(_StencilOperator):
    """Laplacian: weighted sum of second derivatives along ``axes``
    (ref ``basicoperators/Laplacian.py:15-126``). With one rank it
    applies the local second derivatives to the whole field and does not
    run the tap kernel, as the JAX package does; across ranks the axis-0
    term goes through the ghost exchange and the tap kernel (the bulk
    exchange: the JAX package's Laplacian has no overlap path), and the
    other axes apply to each rank's shard."""

    def __init__(self, dims, axes=(-2, -1), weights=(1, 1), sampling=(1, 1),
                 kind: str = "centered", edge: bool = False,
                 dtype=torch.float64):
        super().__init__(dims, dtype=dtype, overlap="off")
        axes = tuple(ax % len(self.dims_nd) for ax in axes)
        if not (len(axes) == len(weights) == len(sampling)):
            raise ValueError("axes, weights, and sampling have different size")
        self.axes, self.weights = axes, tuple(weights)
        self.sampling = tuple(sampling)
        self.kind, self.edge = kind, edge
        self._ops = [_LocalSecond(self.dims_nd, axis=ax, sampling=s,
                                  kind=kind, edge=edge, dtype=dtype)
                     for ax, s in zip(axes, sampling)]
        self._terms = [_AxisStencil(self.dims_nd, op, "off")
                       for op in self._ops]

    def _apply(self, x: DistributedArray, forward: bool) -> DistributedArray:
        x = _model_layout(x, self.local_shapes_m)
        if world_size() == 1:
            paths["local"] += 1
            g = x.array.reshape(-1)
            if forward:
                arr = sum(w * op._matvec(g)
                          for w, op in zip(self.weights, self._ops))
            else:
                arr = sum(np.conj(w) * op._rmatvec(g)
                          for w, op in zip(self.weights, self._ops))
        else:
            arr = sum((w if forward else np.conj(w))
                      * t._apply_shard(x.array, forward)
                      for w, t in zip(self.weights, self._terms))
        return DistributedArray._wrap(arr, x, local_shapes=self.local_shapes_n)


class _AxisStencil(_StencilOperator):
    """A local derivative operator along any axis of the axis-0-sharded
    layout (the reference runs non-0 axes as rank-local pylops operators
    inside MPIBlockDiag, ref ``Gradient.py:88-97``)."""

    def __init__(self, dims, op, overlap=None):
        super().__init__(dims, dtype=op.dtype, overlap=overlap)
        self._op = op

    def _local_op(self):
        return self._op


class _AxisFirstDerivative(_AxisStencil):
    """First derivative along any axis of the axis-0-sharded layout."""

    def __init__(self, dims, axis, sampling, kind, edge, dtype=torch.float64,
                 overlap=None):
        super().__init__(dims, _LocalFirst(_tuplize(dims), axis=axis,
                                           sampling=sampling, kind=kind,
                                           edge=edge, dtype=dtype), overlap)


class MPIGradient(MPILinearOperator):
    """Gradient: vertical stack of first derivatives along every axis
    (ref ``basicoperators/Gradient.py:21-118``). The output is a
    :class:`StackedDistributedArray` with one component per axis.
    ``overlap`` goes to every component (the axis-0 one acts on it);
    ``hierarchical`` is recorded as :class:`MPIFirstDerivative`'s."""

    def __init__(self, dims, sampling=1, kind: str = "centered",
                 edge: bool = False, dtype=torch.float64, overlap=None,
                 hierarchical=None):
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
                                 kind=kind, edge=edge, dtype=dtype,
                                 overlap=overlap)
            for ax in range(ndims)])
        super().__init__(shape=stack.shape, dtype=dtype)
        self.Op = stack  # after super().__init__, which resets self.Op
        _record_hier(self, hierarchical)
        self.local_shapes_m = stack.ops[0].local_shapes_m
        self.dims = self.dimsd = self.dims_nd

    def _matvec(self, x: DistributedArray) -> StackedDistributedArray:
        return self.Op._matvec(x)

    def _rmatvec(self, x: StackedDistributedArray) -> DistributedArray:
        return self.Op._rmatvec(x)


# the operator's parameters (JAX ``ops/derivatives.py`` registrations)
from ..linearoperator import register_operator_params  # noqa: E402

for _c in (MPIFirstDerivative, MPISecondDerivative, MPILaplacian,
           _AxisFirstDerivative):
    register_operator_params(_c)
register_operator_params(MPIGradient, "Op")
