"""Adjoint (dot) test — PyTorch counterpart of
``pylops_mpi_tpu/utils/dottest.py`` (ref ``pylops_mpi/utils/dottest.py``):
checks ``(Op u)ᴴ v == uᴴ (Opᴴ v)`` on gathered global arrays.

``u``/``v`` may be omitted: random vectors are drawn with numpy from
``seed``, with ``complexflag`` selecting which side is complex (0: both
real, 1: model complex, 2: data complex, 3: both complex). They go to
``device`` (default: the operator's ``device`` if it has one, else the
default device). The data side may be stacked (``MPIGradient``,
``MPIStackedVStack``): ``v`` then takes the structure of ``Op u``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..distributedarray import DistributedArray
from ..stacked import StackedDistributedArray

__all__ = ["dottest"]


def _dtype_for(Op, cmplx):
    return torch.promote_types(Op.dtype,
                               torch.complex64 if cmplx else torch.float32)


def _rand(shape, cmplx, rng, dtype):
    x = rng.standard_normal(shape)
    if cmplx:
        x = x + 1j * rng.standard_normal(shape)
    return torch.from_numpy(x).to(dtype)


def _wide(a: np.ndarray) -> np.ndarray:
    return a.astype(np.promote_types(a.dtype, np.float64), copy=False)


def _rand_like(d, cmplx, rng, dtype):
    """A random vector with the structure and layout of ``d`` (plain or
    stacked): the data side takes its layout from a probe ``matvec``."""
    if isinstance(d, StackedDistributedArray):
        return StackedDistributedArray(
            [_rand_like(a, cmplx, rng, dtype) for a in d.distarrays])
    return DistributedArray.to_dist(
        _rand(d.global_shape, cmplx, rng, dtype), partition=d.partition,
        axis=d.axis, local_shapes=d.local_shapes, device=d.device)


def dottest(Op, u=None, v=None, nr: Optional[int] = None,
            nc: Optional[int] = None, complexflag: int = 0,
            rtol: float = 1e-6, atol: float = 1e-21,
            raiseerror: bool = True, verb: bool = False,
            seed: Optional[int] = 42, device=None) -> bool:
    if nr is None:
        nr = Op.shape[0]
    if nc is None:
        nc = Op.shape[1]
    if (nr, nc) != Op.shape:
        raise AssertionError("Provided nr and nc do not match operator shape")
    if complexflag not in (0, 1, 2, 3):
        raise ValueError(f"complexflag must be 0, 1, 2 or 3, "
                         f"got {complexflag}")
    if device is None:
        device = getattr(Op, "device", None)
    rng = np.random.default_rng(seed)
    if u is None:
        u = DistributedArray.to_dist(
            _rand(nc, complexflag in (1, 3), rng,
                  _dtype_for(Op, complexflag in (1, 3))),
            local_shapes=getattr(Op, "local_shapes_m", None), device=device)
    y = Op.matvec(u)
    if v is None:
        v = _rand_like(y, complexflag in (2, 3), rng,
                       _dtype_for(Op, complexflag in (2, 3)))
    x = Op.rmatvec(v)

    # the inner products in double precision: an f32 sum over a large
    # field would carry more rounding than the operator being tested
    yy = np.vdot(_wide(y.asarray()), _wide(v.asarray()))
    xx = np.vdot(_wide(u.asarray()), _wide(x.asarray()))

    passed = bool(np.isclose(xx, yy, rtol, atol))
    if (not passed and raiseerror) or verb:
        status = "passed" if passed else "failed"
        msg = f"Dot test {status}, v^H(Opu)={yy} - u^H(Op^Hv)={xx}"
        if not passed and raiseerror:
            raise AssertionError(msg)
        print(msg)
    return passed
