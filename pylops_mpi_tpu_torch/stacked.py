"""StackedDistributedArray: a vector made of DistributedArrays.

PyTorch counterpart of ``pylops_mpi_tpu/stacked.py`` (the reference's
``pylops_mpi/DistributedArray.py:963-1242``): the solver-facing
arithmetic, ``dot`` and ``norm`` of a stack of distributed arrays, so
that stacked operators (``MPIStackedVStack``, ``MPIGradient``'s output)
plug into CG/CGLS unchanged. Components may themselves be stacks.
Reductions return 0-d tensors on the components' device.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .distributedarray import DistributedArray

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
        """The flattened components, concatenated, on the host
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

    def dot(self, y: "StackedDistributedArray", vdot: bool = False) -> torch.Tensor:
        """Sum of the component dots (ref ``DistributedArray.py:1144-1159``)."""
        self._check_stacked_size(y)
        parts = [a.dot(b, vdot=vdot) for a, b in zip(self.distarrays, y.distarrays)]
        return sum(parts[1:], parts[0])

    def norm(self, ord=None) -> torch.Tensor:
        """Norm of the stacked vector: the component norms combined with
        the cross-component rule of each order
        (ref ``DistributedArray.py:1161-1194``)."""
        ord = 2 if ord is None else ord
        parts = [d.norm(ord) for d in self.distarrays]
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

    def __repr__(self):
        return f"<StackedDistributedArray with {self.narrays} arrays>"
