"""Fixed-iteration CG/CGLS that autograd tapes.

PyTorch counterpart of ``pylops_mpi_tpu/autodiff/unrolled.py``: the
oracles the implicit gradients are held against. A plain Python loop of
exactly ``niter`` iterations over the distributed vectors, which
autograd records whole: O(niter · n) saved activations and a backward
that replays every iteration, against the implicit rule's one extra
solve. The arithmetic is the fused loops' (``_rdot`` at the reduction
dtype, step scalars at the carry dtype, the ``_mp_floor`` freeze, so a
tape past convergence holds no ``0/0``), without the early exit on
``tol``. Single right-hand side only.
"""

from __future__ import annotations

import torch

__all__ = ["unrolled_cg", "unrolled_cgls"]


def unrolled_cg(Op, y, x0=None, *, niter: int = 10, M=None):
    """``niter`` iterations of (P)CG as a taped loop; returns ``x``."""
    from ..solvers.basic import (_mp_floor, _precond_apply, _rdot,
                                 _step_scalar, _zero_like_model)
    x = _zero_like_model(Op, y) if x0 is None else x0
    xdt = x.dtype
    r = y - Op.matvec(x)
    z = _precond_apply(M, r, xdt)
    c = z
    kold = _rdot(r, z)
    floors = _mp_floor(kold).detach()
    for _ in range(niter):
        done = kold <= floors
        q = Op.matvec(c)
        a = torch.where(done, torch.zeros_like(kold), kold / _rdot(c, q))
        x = x + c * _step_scalar(a, xdt)
        r = r - q * _step_scalar(a, xdt)
        z = _precond_apply(M, r, xdt)
        k = torch.where(done, kold, _rdot(r, z))
        b = torch.where(done, torch.zeros_like(k), k / kold)
        c = z + c * _step_scalar(b, xdt)
        kold = k
    return x


def unrolled_cgls(Op, y, x0=None, *, niter: int = 10, damp: float = 0.0,
                  M=None):
    """``niter`` iterations of (P)CGLS (the classic two-sweep schedule)
    as a taped loop; returns ``x``. The fused setup's quirk is kept: the
    first gradient is damped by ``damp``, the iterations by ``damp²``."""
    from ..solvers.basic import (_mp_floor, _precond_apply, _rdot,
                                 _step_scalar, _zero_like_model)
    x = _zero_like_model(Op, y) if x0 is None else x0
    damp2 = damp ** 2
    xdt = x.dtype
    s = y - Op.matvec(x)
    rq = Op.rmatvec(s) - x * damp
    z = _precond_apply(M, rq, xdt)
    c = z
    kold = _rdot(rq, z)
    floors = _mp_floor(kold).detach()
    for _ in range(niter):
        done = kold <= floors
        q = Op.matvec(c)
        den = _rdot(q, q) + damp2 * _rdot(c, c)
        a = torch.where(done, torch.zeros_like(kold), kold / den)
        x = x + c * _step_scalar(a, xdt)
        s = s - q * _step_scalar(a, xdt)
        rq = Op.rmatvec(s) - x * damp2
        z = _precond_apply(M, rq, xdt)
        k = torch.where(done, kold, _rdot(rq, z))
        b = torch.where(done, torch.zeros_like(k), k / kold)
        c = z + c * _step_scalar(b, xdt)
        kold = k
    return x
