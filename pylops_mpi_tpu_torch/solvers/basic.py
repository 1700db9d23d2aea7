"""CG / CGLS solvers.

PyTorch counterpart of the fused engines of
``pylops_mpi_tpu/solvers/basic.py`` (``_cgls_setup``,
``_make_cgls_body`` in both schedules and ``_make_cg_body``, lines
416-703), themselves rebuilds of the reference's
``pylops_mpi/optimization/cls_basic.py``.

The JAX package runs a solve as one ``lax.while_loop`` that leaves when
``iiter == niter`` or ``max(kold) <= tol``. Here the loop is a Python
loop whose scalars all stay on the device: an ``active = kold > tol``
mask, computed on the device each iteration, zeroes the step and stops
``iiter`` and the cost buffers once the tolerance is met, so the result
equals the while loop's exit exactly. The host reads ``active`` only
every ``_CHECK_EVERY`` iterations, to leave the loop early.

Preserved from the JAX package: the recurrence dots at the policy's
reduction dtype (``_rdot``), step scalars re-entering vector updates at
the carry dtype (``_step_scalar``), the machine-precision freeze
(``_mp_floor``), the ``(niter+1)`` cost buffers, and the reference's
setup quirk — CGLS damps the first normal residual by ``damp`` while the
iterations use ``damp**2`` (ref ``cls_basic.py:345-350`` vs ``392-393``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..distributedarray import DistributedArray
from ..ops._precision import reduction_dtype

__all__ = ["cg", "cgls"]

# Iterations between the host's reads of the device-side ``active`` flag.
_CHECK_EVERY = 8


def _rdot(u: DistributedArray, v: DistributedArray) -> torch.Tensor:
    """Recurrence dot ``|u·conj(v)|`` at the policy reduction dtype."""
    return torch.abs(u.dot(v.conj())).to(reduction_dtype(u.dtype))


def _step_scalar(s: torch.Tensor, carry_dtype: torch.dtype) -> torch.Tensor:
    """A recurrence scalar cast to the carry dtype for a vector update
    (real scalars against complex carries pass through)."""
    if carry_dtype.is_complex:
        return s
    return s.to(carry_dtype)


def _mp_floor(k0: torch.Tensor) -> torch.Tensor:
    """Machine-precision floor ``(100·eps)²·k0`` of the squared
    recurrence norm: below it the loop freezes (zero step, zero
    momentum) instead of iterating on noise, which can pump the
    recurrence."""
    return k0 * (100 * torch.finfo(k0.dtype).eps) ** 2


def _zero_like_model(Op, y: DistributedArray) -> DistributedArray:
    return DistributedArray(global_shape=Op.shape[1], partition=y.partition,
                            dtype=y.dtype, device=y.device)


def _record(buf: torch.Tensor, i: int, value, active) -> None:
    """``buf[i] = value`` on the device where ``active`` (no host sync)."""
    buf[i] = torch.where(active, value, buf[i])


def cg(Op, y: DistributedArray, x0: Optional[DistributedArray] = None,
       niter: int = 10, tol: float = 1e-4):
    """Conjugate gradient for a square operator
    (ref ``optimization/basic.py:13-70``).

    Returns ``(x, iiter, cost)``: the solution, the iterations run and
    the residual-norm history ``cost[:iiter+1]`` (a device tensor)."""
    x = _zero_like_model(Op, y) if x0 is None else x0
    xdt = x.dtype
    r = y - Op.matvec(x)
    c = r
    kold = _rdot(r, r)
    floors = _mp_floor(kold)
    cost = torch.zeros(niter + 1, dtype=kold.dtype, device=kold.device)
    cost[0] = torch.sqrt(kold)
    iiter = torch.zeros((), dtype=torch.int64, device=kold.device)
    for it in range(niter):
        active = kold > tol
        frozen = (kold <= floors) | ~active
        Opc = Op.matvec(c)
        a = torch.where(frozen, torch.zeros_like(kold), kold / _rdot(c, Opc))
        x = x + c * _step_scalar(a, xdt)
        r = r - Opc * _step_scalar(a, xdt)
        k = torch.where(frozen, kold, _rdot(r, r))
        b = torch.where(frozen, torch.zeros_like(k), k / kold)
        c = r + c * _step_scalar(b, xdt)
        kold = k
        iiter = iiter + active.to(iiter.dtype)
        _record(cost, it + 1, torch.sqrt(k), active)
        if (it + 1) % _CHECK_EVERY == 0 and not bool(kold > tol):
            break
    iiter = int(iiter)
    return x, iiter, cost[:iiter + 1]


def cgls(Op, y: DistributedArray, x0: Optional[DistributedArray] = None,
         niter: int = 10, damp: float = 0.0, tol: float = 1e-4,
         normal: bool = False):
    """Damped least-squares CGLS (ref ``optimization/basic.py:73-148``).

    ``normal=True`` runs the one-sweep schedule: each iteration takes
    ``(u, q) = Op.normal_matvec(c)`` (one read of the blocks for
    ``MPIBlockDiag``) and updates the gradient by the recurrence
    ``r ← r − a (u + damp² c)``. ``normal=False`` is the classic
    schedule with one ``rmatvec`` and one ``matvec`` per iteration.

    Returns ``(x, istop, iiter, r1norm, r2norm, cost)`` as the JAX
    package does: ``istop`` 1 when ``kold < tol`` else 2, ``r1norm`` the
    final ``kold``, ``r2norm`` the final damped residual norm and
    ``cost`` the residual-norm history ``cost[:iiter+1]`` (device
    tensors)."""
    damp2 = damp ** 2
    x = _zero_like_model(Op, y) if x0 is None else x0
    xdt = x.dtype
    s = y - Op.matvec(x)
    rq = Op.rmatvec(s) - x * damp  # the reference's un-squared setup damp
    c = rq
    if normal:
        # the recurrence tracks the true gradient Opᴴs − damp²x
        r = rq + x * (damp - damp2)
    else:
        q = Op.matvec(c)
    kold = _rdot(rq, rq)
    floors = _mp_floor(kold)
    sn = s.norm()
    cost = torch.zeros(niter + 1, dtype=sn.dtype, device=sn.device)
    cost1 = torch.zeros_like(cost)
    cost[0] = sn
    cost1[0] = torch.sqrt(sn ** 2 + damp2 * _rdot(x, x))
    iiter = torch.zeros((), dtype=torch.int64, device=kold.device)
    for it in range(niter):
        active = kold > tol
        frozen = (kold <= floors) | ~active
        if normal:
            u, q = Op.normal_matvec(c)
        a = torch.abs(kold / (_rdot(q, q) + damp2 * _rdot(c, c)))
        a = torch.where(frozen, torch.zeros_like(a), a)
        x = x + c * _step_scalar(a, xdt)
        s = s - q * _step_scalar(a, xdt)
        if normal:
            r = r - (u + c * damp2) * _step_scalar(a, xdt)
        else:
            r = Op.rmatvec(s) - x * damp2
        k = torch.where(frozen, kold, _rdot(r, r))
        b = torch.where(frozen, torch.zeros_like(k), k / kold)
        c = r + c * _step_scalar(b, xdt)
        if not normal:
            q = Op.matvec(c)
        kold = k
        iiter = iiter + active.to(iiter.dtype)
        sn = s.norm()
        _record(cost, it + 1, sn, active)
        _record(cost1, it + 1, torch.sqrt(sn ** 2 + damp2 * _rdot(x, x)),
                active)
        if (it + 1) % _CHECK_EVERY == 0 and not bool(kold > tol):
            break
    iiter = int(iiter)
    istop = 1 if float(kold) < tol else 2
    return x, istop, iiter, kold, cost1[iiter], cost[:iiter + 1]
