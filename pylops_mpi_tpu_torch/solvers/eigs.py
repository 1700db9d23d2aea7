"""Power iteration: an estimate of the dominant eigenpair.

PyTorch counterpart of ``pylops_mpi_tpu/solvers/eigs.py`` (the
reference's ``pylops_mpi/optimization/eigs.py:10-98``): a random start
vector drawn with numpy, normalised by its norm, the Rayleigh quotient
``vdot(b, Op b)`` as the eigenvalue, and an early stop on its relative
change.

``fused=True`` keeps the eigenvalue, the stop flag and the iteration
count on the device: a device ``active`` mask freezes the iterate, the
eigenvalue and the count at the iteration where the stop triggered,
and the host reads the flag only every 8 iterations, as
``solvers/basic.py`` does for CG/CGLS (through :mod:`..aot.graphs`).
``fused=False`` reads the eigenvalue on the host every iteration. Both
return the same result.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

from ..distributedarray import DistributedArray
from ..ops._precision import as_torch_dtype
from ..stacked import StackedDistributedArray
from .basic import _step_scalar

__all__ = ["power_iteration"]

Vector = Union[DistributedArray, StackedDistributedArray]


def _random_start(b_k: Vector, dtype, seed: int) -> Vector:
    """The JAX package's start vector: per component, ``rng.random`` of
    its global shape plus ``1j·`` a second draw for a complex ``dtype``,
    cast to ``dtype`` and then to the component's dtype, moved to its
    device in one copy; each rank keeps its shard of the draw. For a real ``dtype`` the JAX package still draws
    the second array (and multiplies it by 0); the generator is advanced
    past it instead, so later components see the same stream."""
    rng = np.random.default_rng(seed)
    dt = as_torch_dtype(dtype)

    def rand_like(d: DistributedArray) -> DistributedArray:
        vals = rng.random(d.global_shape)
        if dt.is_complex:
            vals = vals + 1j * rng.random(d.global_shape)
        else:
            rng.bit_generator.advance(vals.size)
        # every rank draws the whole array and keeps its shard
        t = torch.from_numpy(np.ascontiguousarray(d._shard_of(vals))).to(dt)
        return DistributedArray._wrap(t.to(device=d.device, dtype=d.dtype), d)

    if isinstance(b_k, StackedDistributedArray):
        return StackedDistributedArray([rand_like(d) for d in b_k.distarrays])
    return rand_like(b_k)


def _scalar(maxeig: complex):
    """The eigenvalue as a Python number, real when ``|imag| < 1e-12``."""
    maxeig = complex(maxeig)
    return maxeig.real if abs(maxeig.imag) < 1e-12 else maxeig


def _where(active: torch.Tensor, new: Vector, old: Vector) -> Vector:
    """``new`` where ``active`` else ``old``, over a (stacked) vector."""
    if isinstance(new, StackedDistributedArray):
        return StackedDistributedArray(
            [_where(active, n, o) for n, o in zip(new.distarrays,
                                                  old.distarrays)])
    return DistributedArray._wrap(torch.where(active, new.array, old.array),
                                  new)


def power_iteration(Op, b_k: Vector, niter: int = 10, tol: float = 1e-5,
                    dtype="float64", seed: int = 42, fused: bool = True,
                    ) -> Tuple[complex, Vector, int]:
    """Dominant eigenvalue of ``Op`` (ref ``eigs.py:10-98``).

    ``b_k`` is only the template of the vector space: its values are
    replaced by the seeded draws of the JAX package (complex when
    ``dtype`` is). Returns ``(maxeig, b_k, iiter)``: the eigenvalue (a
    Python float, or complex where its imaginary part is not
    negligible), the normalised last iterate and the iterations run."""
    b_k = _random_start(b_k, dtype, seed)
    b_k = b_k * (1.0 / b_k.norm())
    if not fused:
        maxeig_old = 0.0
        iiter = 0
        for iiter in range(niter):
            b1_k = Op.matvec(b_k)
            maxeig = _scalar(b_k.dot(b1_k, vdot=True).item())
            b_k = b1_k * (1.0 / b1_k.norm())
            if np.abs(maxeig - maxeig_old) < tol * np.abs(maxeig):
                break
            maxeig_old = maxeig
        return maxeig, b_k, iiter + 1

    from ..aot import graphs

    def one_step(b):
        b1 = Op.matvec(b)
        maxeig = b.dot(b1, vdot=True)
        return b1 * _step_scalar(1.0 / b1.norm(), b1.dtype), maxeig

    def step(state, consts):
        b_k, maxeig, iiter, active = state
        b_new, m_new = one_step(b_k)
        converged = torch.abs(m_new - maxeig) < tol * torch.abs(m_new)
        return (_where(active, b_new, b_k),
                torch.where(active, m_new, maxeig),
                iiter + active.to(iiter.dtype), active & ~converged)

    # the first step seeds the eigenvalue (the eager loop's comparison
    # with maxeig_old = 0), as the JAX package's while loop does
    b_k, maxeig = one_step(b_k)
    state = (b_k, maxeig,
             torch.ones((), dtype=torch.int64, device=maxeig.device),
             ~(torch.abs(maxeig) < tol * torch.abs(maxeig)))
    loop = graphs.Loop("power_iteration", dict(tol=tol), Op, None, b_k,
                       state, (), step)
    b_k, maxeig, iiter, _ = graphs.run_iterations(loop, lambda st: st[3],
                                                  niter, start=1)
    return _scalar(maxeig.item()), b_k, int(iiter)
