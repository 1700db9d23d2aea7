"""StackedDistributedArray: a vector made of DistributedArrays.

PyTorch counterpart of ``pylops_mpi_tpu/stacked.py`` (the reference's
``pylops_mpi/DistributedArray.py:963-1242``): the solver-facing
arithmetic, ``dot`` and ``norm`` of a stack of distributed arrays, so
that stacked operators (``MPIStackedVStack``, ``MPIGradient``'s output)
plug into CG/CGLS unchanged. Components may themselves be stacks, and
each is sharded over the ranks as a :class:`DistributedArray` is.
``dot`` and ``norm`` stack the components' local partials into one
``all_reduce`` per call, not one per component, and return 0-d tensors
on the components' device.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .distributedarray import DistributedArray
from .parallel import collectives

__all__ = ["StackedDistributedArray"]


class StackedDistributedArray:
    """Stack of :class:`DistributedArray` (or nested stacks) with
    vector-space semantics (ref ``DistributedArray.py:963-1242``)."""

    def __init__(self, distarrays: Sequence[DistributedArray]):
        self.distarrays = list(distarrays)
        self.narrays = len(self.distarrays)

    def __getitem__(self, index):
        return self.distarrays[index]

    def __setitem__(self, index, value):
        self.distarrays[index] = value

    @property
    def global_shape(self):
        """Elementwise sum of the components' global shapes (the
        reference's convention for nested stacking); components of
        different rank raise (use ``size`` for the element count)."""
        if not self.distarrays:
            raise ValueError("global_shape of an empty stack is undefined")
        gs = self.distarrays[0].global_shape
        for d in self.distarrays[1:]:
            ds = d.global_shape
            if len(ds) != len(gs):
                raise ValueError(
                    "global_shape requires equal-rank components, got "
                    f"{len(gs)}-d and {len(ds)}-d; use .size instead")
            gs = tuple(a + b for a, b in zip(gs, ds))
        return gs

    @property
    def size(self) -> int:
        """Number of elements over all components (nested included)."""
        return int(sum(d.size for d in self.distarrays))

    @property
    def dtype(self) -> torch.dtype:
        """Promotion of the components' dtypes."""
        dt = self.distarrays[0].dtype
        for d in self.distarrays[1:]:
            dt = torch.promote_types(dt, d.dtype)
        return dt

    @property
    def device(self) -> torch.device:
        return self.distarrays[0].device

    def asarray(self) -> np.ndarray:
        """The flattened components, each gathered from every rank
        (collective), concatenated on the host
        (ref ``DistributedArray.py:1196-1214``)."""
        return np.concatenate([d.asarray().ravel() for d in self.distarrays])

    def _apply(self, fn, other=None) -> "StackedDistributedArray":
        if other is None:
            return StackedDistributedArray([fn(d) for d in self.distarrays])
        self._check_stacked_size(other)
        return StackedDistributedArray(
            [fn(a, b) for a, b in zip(self.distarrays, other.distarrays)])

    def _check_stacked_size(self, other: "StackedDistributedArray"):
        if self.narrays != getattr(other, "narrays", None):
            raise ValueError("Stacked size mismatch")

    def copy(self):
        return self._apply(lambda d: d.copy())

    def conj(self):
        return self._apply(lambda d: d.conj())

    def zeros_like(self):
        return self._apply(lambda d: d.zeros_like())

    def empty_like(self):
        return self._apply(lambda d: d.empty_like())

    def __neg__(self):
        return self._apply(lambda d: -d)

    def add(self, x):
        return self._apply(lambda a, b: a + b, x)

    def __add__(self, x):
        return self.add(x)

    def __iadd__(self, x):
        self._check_stacked_size(x)
        for i, d in enumerate(x.distarrays):
            self.distarrays[i] = self.distarrays[i] + d
        return self

    def __sub__(self, x):
        return self._apply(lambda a, b: a - b, x)

    def __isub__(self, x):
        self._check_stacked_size(x)
        for i, d in enumerate(x.distarrays):
            self.distarrays[i] = self.distarrays[i] - d
        return self

    def multiply(self, x):
        if isinstance(x, StackedDistributedArray):
            return self._apply(lambda a, b: a * b, x)
        return self._apply(lambda d: d * x)

    def __mul__(self, x):
        return self.multiply(x)

    def __rmul__(self, x):
        return self.multiply(x)

    def _pairs(self, y: "StackedDistributedArray"):
        """The (self, y) leaf pairs in order, nested stacks flattened."""
        self._check_stacked_size(y)
        for a, b in zip(self.distarrays, y.distarrays):
            if isinstance(a, StackedDistributedArray):
                yield from a._pairs(b)
            else:
                yield a, b

    def _fold(self, values, combine):
        """``combine`` of the per-leaf ``values`` (an iterator, in leaf
        order) with this stack's nesting: each nested stack combines its
        own leaves first."""
        parts = [d._fold(values, combine)
                 if isinstance(d, StackedDistributedArray) else next(values)
                 for d in self.distarrays]
        return combine(parts)

    @staticmethod
    def _reduce_partials(leaves, partials, op: str):
        """The leaves' partials reduced over their groups with one
        ``all_reduce`` per group (one for the usual unmasked stack),
        the partials stacked into one tensor at their promoted dtype;
        BROADCAST leaves keep theirs. Each comes back at its own dtype."""
        out = list(partials)
        groups = {}
        for i, d in enumerate(leaves):
            if d._reduces():
                groups.setdefault(d.mask, []).append(i)
        for idx in groups.values():
            dt = partials[idx[0]].dtype
            for i in idx[1:]:
                dt = torch.promote_types(dt, partials[i].dtype)
            red = collectives.all_reduce(
                torch.stack([partials[i].to(dt) for i in idx]), op,
                leaves[idx[0]]._group())
            for k, i in enumerate(idx):
                v = red[k]
                if v.is_complex() and not partials[i].is_complex():
                    v = v.real
                out[i] = v.to(partials[i].dtype)
        return out

    def dot(self, y: "StackedDistributedArray", vdot: bool = False) -> torch.Tensor:
        """Sum of the component dots (ref ``DistributedArray.py:1144-1159``),
        the components' partials reduced in one ``all_reduce``."""
        pairs = list(self._pairs(y))
        leaves = [a for a, _ in pairs]
        partials = [a._dot_local(b, vdot) for a, b in pairs]
        vals = self._reduce_partials(leaves, partials, "sum")
        return self._fold(iter(vals), lambda p: sum(p[1:], p[0]))

    def _leaves(self):
        for d in self.distarrays:
            if isinstance(d, StackedDistributedArray):
                yield from d._leaves()
            else:
                yield d

    def norm(self, ord=None) -> torch.Tensor:
        """Norm of the stacked vector: the component norms combined with
        the cross-component rule of each order
        (ref ``DistributedArray.py:1161-1194``); the components'
        partials are reduced in one ``all_reduce``."""
        ord = 2 if ord is None else ord
        leaves = list(self._leaves())
        partials = [d._norm_local(ord) for d in leaves]
        vals = self._reduce_partials(leaves, partials,
                                     DistributedArray._norm_op(ord))
        vals = [DistributedArray._norm_finish(v, ord) for v in vals]

        def combine(parts):
            dt = parts[0].dtype
            for p in parts[1:]:
                dt = torch.promote_types(dt, p.dtype)
            norms = torch.stack([p.to(dt) for p in parts])
            if ord == 0:
                return torch.sum(norms, dim=0)
            if ord == np.inf:
                return torch.max(norms, dim=0).values
            if ord == -np.inf:
                return torch.min(norms, dim=0).values
            return torch.sum(norms ** ord, dim=0) ** (1.0 / ord)

        return self._fold(iter(vals), combine)

    def __repr__(self):
        return f"<StackedDistributedArray with {self.narrays} arrays>"
