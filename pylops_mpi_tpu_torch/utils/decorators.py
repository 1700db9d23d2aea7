"""Operator decorators.

PyTorch counterpart of ``pylops_mpi_tpu/utils/decorators.py`` (the
reference's ``pylops_mpi/utils/decorators.py:9-86``). ``reshaped`` lets a
custom operator's ``_matvec``/``_rmatvec`` work on the N-D array sharded
on axis 0 and returns its result raveled, as the solvers expect.

The JAX package repacks the flat input as one logical view on a single
controller. Here every rank holds only its shard, so a flat vector whose
split is not the one the N-D layout (or, with ``stacking=True``, the
operator's ``local_shapes_m``/``local_shapes_n``) needs is moved through
the resharding planner (:meth:`~..distributedarray.DistributedArray.
reshard`): a real exchange between ranks, which carries gradients. A
vector already split that way is only reshaped.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np

from ..distributedarray import DistributedArray
from ..parallel.partition import Partition, local_split

__all__ = ["reshaped"]


def _split_as(x: DistributedArray, shapes) -> DistributedArray:
    """``x`` as a SCATTER vector on axis 0 with ``shapes`` as its local
    shapes: itself when it is one, else moved there."""
    shapes = tuple(tuple(int(v) for v in np.atleast_1d(s)) for s in shapes)
    if (x.partition == Partition.SCATTER and x.axis == 0
            and x.local_shapes == shapes):
        return x
    return x.reshard(partition=Partition.SCATTER, axis=0, local_shapes=shapes)


def _flatten_out(y):
    """A wrapped function's N-D result as the flat axis-0 vector the
    solvers expect (ref ``decorators.py:79-81``)."""
    if isinstance(y, DistributedArray) and y.ndim > 1:
        return y.redistribute(0).ravel() if y.axis != 0 else y.ravel()
    return y


def reshaped(func=None, forward: Optional[bool] = None,
             stacking: bool = False):
    """Decorate an ``_matvec``/``_rmatvec`` so that it receives an N-D
    :class:`~..distributedarray.DistributedArray` of shape ``self.dims``
    (forward) or ``self.dimsd`` (adjoint), sharded on axis 0 in the
    balanced split, and its result is raveled back (ref
    ``decorators.py:9-86``). ``forward`` defaults from the function's
    name. With ``stacking=True`` the vector stays flat, split as the
    operator's ``local_shapes_m`` (forward) or ``local_shapes_n``
    (adjoint)."""

    def decorator(f):
        fwd = forward if forward is not None else \
            f.__name__.endswith("matvec") and "r" not in f.__name__[:2]

        @functools.wraps(f)
        def wrapper(self, x: DistributedArray):
            if stacking:
                shapes = self.local_shapes_m if fwd else self.local_shapes_n
                return _flatten_out(f(self, _split_as(x, shapes)))
            dims = tuple(int(d) for d in np.atleast_1d(
                self.dims if fwd else self.dimsd))
            nd_shapes = local_split(dims, x.n_shards, Partition.SCATTER, 0)
            rest = int(np.prod(dims[1:], dtype=np.int64))
            flat = _split_as(x, [(s[0] * rest,) for s in nd_shapes])
            me = flat._me()
            local = flat.array.reshape(nd_shapes[me] if me >= 0
                                       else (0,) + dims[1:])
            nd = DistributedArray._wrap(local, flat, global_shape=dims,
                                        local_shapes=nd_shapes, axis=0)
            return _flatten_out(f(self, nd))
        return wrapper

    if func is not None:
        return decorator(func)
    return decorator
