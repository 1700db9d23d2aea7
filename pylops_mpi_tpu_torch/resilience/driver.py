"""``resilient_solve`` and ``refined_solve``: precision as a resource.

PyTorch counterpart of ``pylops_mpi_tpu/resilience/driver.py:57-373``.
Narrow storage (bf16 blocks through the normal kernel's streaming
variant) buys bandwidth with headroom: a bf16 operator can underflow a
denominator or overflow a recurrence scalar that the same system at f32
absorbs. The guarded loops turn that event into ``BREAKDOWN`` and a last
finite iterate; this driver turns it into a finished solve:

1. run the guarded fused solver at the current precision rung;
2. on ``breakdown``/``stagnation``, rebuild the operator one rung wider
   (:func:`~..ops._precision.escalate_dtype`: bf16 → f32 → f64, c64 →
   c128) and restart from the last finite iterate with the iterations
   left;
3. at most ``max_restarts`` times (``PYLOPS_MPI_TPU_TORCH_RESTARTS``,
   default 2); each restart is a ``solver.restart`` trace event and a
   ``solver.<solver>.restarts`` count.

The caller gives an operator factory ``make_op(compute_dtype)``
(``None`` on the first rung: the operator resolves the precision policy
itself). A plain operator disables escalation.

:func:`refined_solve` is mixed-precision iterative refinement: wide
(f64) true residuals and corrections around narrow inner solves, so a
bf16 or f32 operator reaches f64 accuracy with most applies narrow
(``solver.refine.*`` counts them). ``PYLOPS_MPI_TPU_TORCH_REFINE=1``
routes ``resilient_solve`` there for cg/cgls factories.

Attempt records name dtypes as numpy does (``"bfloat16"``,
``"float32"``), so they compare equal to the JAX package's.
"""

from __future__ import annotations

import math
import os
from collections import namedtuple
from typing import Callable, Optional, Sequence, Union

import torch

from ..diagnostics import metrics as _metrics
from ..diagnostics import trace as _trace
from . import status as _rstatus

__all__ = ["resilient_solve", "refined_solve", "ResilientResult",
           "RefinedResult", "max_restarts_default"]

ResilientResult = namedtuple(
    "ResilientResult",
    ["x", "status", "iiter", "restarts", "compute_dtype", "cost",
     "attempts"])
ResilientResult.__doc__ = (
    "A resilient solve's outcome: the final iterate, the final status "
    "name, the iterations of every attempt together, the restarts, the "
    "last attempt's compute dtype name and cost history, and one record "
    "an attempt (its dtype name, iterations and status).")

_SOLVERS = ("cg", "cgls", "ista", "fista")


def max_restarts_default() -> int:
    """``PYLOPS_MPI_TPU_TORCH_RESTARTS`` (default 2, floored at 0)."""
    try:
        v = int(os.environ.get("PYLOPS_MPI_TPU_TORCH_RESTARTS", "2"))
    except ValueError:
        v = 2
    return max(0, v)


def _run_guarded(solver: str, Op, y, x, niter: int, tol: float,
                 damp: float, solver_kwargs: dict, M=None):
    from ..solvers.basic import _zero_like_model, cg_guarded, cgls_guarded
    from ..solvers.sparsity import fista_guarded, ista_guarded
    if solver == "cg":
        return cg_guarded(Op, y, x, niter=niter, tol=tol, M=M)
    if solver == "cgls":
        xn, it, cost, _, _, code = cgls_guarded(
            Op, y, x, niter=niter, damp=damp, tol=tol,
            normal=bool(solver_kwargs.get("normal", False)), M=M)
        return xn, it, cost, code
    if M is not None:
        raise ValueError(f"M= (preconditioning) is not supported for "
                         f"{solver}")
    if x is None:
        x = _zero_like_model(Op, y)
    fn = ista_guarded if solver == "ista" else fista_guarded
    kw = {k: v for k, v in solver_kwargs.items() if k != "normal"}
    return fn(Op, y, x, niter=niter, tol=tol, **kw)


def resilient_solve(make_op: Union[Callable, object], y, x0=None, *,
                    solver: str = "cgls", niter: int = 100,
                    tol: float = 1e-4, damp: float = 0.0,
                    max_restarts: Optional[int] = None,
                    precisions: Optional[Sequence] = None,
                    M=None, refine: Optional[bool] = None,
                    **solver_kwargs) -> ResilientResult:
    """Solve with breakdown detection and bounded precision-escalating
    restarts (module docstring). ``precisions`` is an explicit sequence
    of compute dtypes for the attempts after the first (default: one
    :func:`~..ops._precision.escalate_dtype` rung a restart). ``M``
    reaches the guarded CG/CGLS. ``refine`` (default the knob) routes
    the solve through :func:`refined_solve`. ``solver_kwargs`` reach
    the guarded sparse solvers (``eps``, ``alpha``, ...) or CGLS
    (``normal``)."""
    from ..ops._precision import (as_torch_dtype, dtype_name,
                                  effective_compute_dtype, escalate_dtype)
    from ..utils.deps import refine_enabled
    if solver not in _SOLVERS:
        raise ValueError(f"solver={solver!r}: expected one of {_SOLVERS}")
    if refine is None:
        refine = refine_enabled()
    if refine and callable(make_op) and solver in ("cg", "cgls"):
        rr = refined_solve(make_op, y, x0, solver=solver, niter=niter,
                           tol=tol, damp=damp, M=M, **solver_kwargs)
        status = {"converged": "converged", "maxpasses": "maxiter",
                  "stalled": "stagnation"}[rr.status]
        return ResilientResult(
            x=rr.x, status=status, iiter=rr.iiter,
            restarts=max(0, rr.passes - 1),
            compute_dtype=rr.attempts[-1]["compute_dtype"]
            if rr.attempts else "none",
            cost=rr.residuals, attempts=rr.attempts)
    if max_restarts is None:
        max_restarts = max_restarts_default()
    factory = make_op if callable(make_op) else None
    ladder = list(precisions) if precisions is not None else None

    x = x0
    cdt = None  # the first rung: the operator's own (policy) dtype
    restarts = 0
    total_iiter = 0
    attempts = []
    cost = None
    while True:
        Op = factory(cdt) if factory is not None else make_op
        eff = effective_compute_dtype(Op)
        remaining = max(1, niter - total_iiter)
        x, it, cost, code = _run_guarded(solver, Op, y, x, remaining, tol,
                                         damp, solver_kwargs, M=M)
        total_iiter += it
        attempts.append({"compute_dtype": dtype_name(eff), "iiter": it,
                         "status": _rstatus.status_name(code)})
        if code in (_rstatus.CONVERGED, _rstatus.MAXITER):
            break
        # breakdown or stagnation: one rung wider, from the last finite
        # iterate
        if ladder is not None:
            nxt = as_torch_dtype(ladder.pop(0)) if ladder else None
        else:
            nxt = escalate_dtype(eff)
        if factory is None or nxt is None or restarts >= max_restarts:
            break
        restarts += 1
        _metrics.inc(f"solver.{solver}.restarts")
        _trace.event("solver.restart", cat="resilience", solver=solver,
                     status=_rstatus.status_name(code), at_iter=total_iiter,
                     restart=restarts, from_dtype=dtype_name(eff),
                     to_dtype=dtype_name(nxt))
        cdt = nxt
    return ResilientResult(x=x, status=_rstatus.status_name(code),
                           iiter=total_iiter, restarts=restarts,
                           compute_dtype=dtype_name(eff), cost=cost,
                           attempts=attempts)


# ------------------------------------------------------------ refinement
RefinedResult = namedtuple(
    "RefinedResult",
    ["x", "status", "iiter", "passes", "residuals", "narrow_frac",
     "attempts"])
RefinedResult.__doc__ = (
    "An iteratively refined solve's outcome: the wide iterate, the "
    "status (``converged``/``maxpasses``/``stalled``), the inner "
    "iterations together, the correction passes, the wide residual norm "
    "of each pass, the share of operator applies run narrow, and one "
    "record a pass.")


class _NormalOperator:
    """``v ↦ OpᴴOp v + damp² v``, the model-space system whose solution
    is a damped CGLS pass's correction."""

    def __init__(self, Op, damp: float):
        n = int(Op.shape[1])
        self.shape = (n, n)
        self.dtype = Op.dtype
        self.device = getattr(Op, "device", None)
        self.local_shapes_m = getattr(Op, "local_shapes_m", None)
        self._Op = Op
        self._damp2 = float(damp) * float(damp)

    def matvec(self, x):
        v = self._Op.rmatvec(self._Op.matvec(x))
        return v + x * self._damp2 if self._damp2 else v

    rmatvec = matvec


def _as(v, dt: torch.dtype):
    """A distributed vector cast to ``dt`` (its shards, its layout)."""
    from ..distributedarray import DistributedArray
    return DistributedArray._wrap(v.array.to(dt), v)


def _norm(v) -> float:
    return float(v.norm())


def refined_solve(make_op: Callable, y, x0=None, *, solver: str = "cg",
                  niter: int = 100, tol: float = 1e-10, damp: float = 0.0,
                  inner_dtype=None, inner_niter: Optional[int] = None,
                  inner_tol: float = 1e-4, max_passes: int = 8, M=None,
                  wide_dtype=None, **solver_kwargs) -> RefinedResult:
    """Mixed-precision iterative refinement (JAX ``driver.py:215-373``):
    narrow inner (P)CG/CGLS solves, wide residuals and corrections.

    Each pass computes the true residual of the wide system, ``s = y −
    Ax`` (cg) or the gradient ``g = Aᴴ(y − Ax) − damp²x`` (cgls), at
    ``wide_dtype`` (default f64, complex for complex data) through
    ``make_op(wide_dtype)``, solves for the correction at the narrow rung
    through ``make_op(inner_dtype)`` (``M`` preconditions it), and adds
    it in wide precision. The narrow solve only sees the residual, so
    its precision bounds the correction's error, not the solution's. An
    inner breakdown or stagnation, or a pass that does not shrink the
    wide residual, escalates the inner rung (``solver.refine_escalate``)
    and retries the pass from the reverted iterate. ``inner_tol`` is
    each correction solve's tolerance relative to its own right-hand
    side."""
    from ..ops._precision import (as_torch_dtype, dtype_name,
                                  effective_compute_dtype, escalate_dtype)
    from ..solvers.basic import _zero_like_model
    if solver not in ("cg", "cgls"):
        raise ValueError(f"solver={solver!r}: refinement supports 'cg' "
                         "and 'cgls'")
    if not callable(make_op):
        raise TypeError(
            "refined_solve needs an operator FACTORY make_op(compute_dtype) "
            "— it must build both the wide and the narrow operator; a "
            "plain operator cannot escalate")
    if wide_dtype is None:
        wide_dtype = torch.promote_types(torch.float64, y.dtype)
    wide_dtype = as_torch_dtype(wide_dtype)
    if inner_niter is None:
        inner_niter = niter

    Opw = make_op(wide_dtype)
    Opn = make_op(as_torch_dtype(inner_dtype))
    per_apply = 2 if solver == "cgls" else 1

    yw = _as(y, wide_dtype)
    if solver == "cgls":
        refnorm = _norm(Opw.rmatvec(yw))
    else:
        refnorm = _norm(yw)
    refnorm = refnorm if refnorm > 0 else 1.0

    x = (_as(x0, wide_dtype) if x0 is not None
         else _zero_like_model(Opw, yw))
    residuals = []
    attempts = []
    total_iiter = 0
    n_narrow = 0.0
    n_wide = 0.0
    status = "maxpasses"
    prev_norm = math.inf
    x_prev = None
    passes = 0
    while passes < max_passes:
        # ---- the wide true residual
        s = yw - _as(Opw.matvec(x), wide_dtype)
        n_wide += 1
        if solver == "cgls":
            g = _as(Opw.rmatvec(s), wide_dtype)
            n_wide += 1
            if damp:
                g = g - x * (float(damp) * float(damp))
            rnorm = _norm(g)
        else:
            rnorm = _norm(s)
        residuals.append(rnorm)
        if rnorm <= tol * refnorm:
            status = "converged"
            break
        if passes > 0 and rnorm >= prev_norm:
            # the last correction did not help: revert, widen the inner
            # rung, retry
            nxt = escalate_dtype(effective_compute_dtype(Opn))
            if nxt is None:
                status = "stalled"
                break
            x = x_prev
            _trace.event("solver.refine_escalate", cat="resilience",
                         solver=solver, at_pass=passes,
                         to_dtype=dtype_name(nxt))
            _metrics.inc("solver.refine.escalations")
            Opn = make_op(nxt)
            prev_norm = math.inf
            continue

        # ---- the narrow correction solve; the fused loops test kold
        # (≈ ‖r‖²) absolutely, so the inner tolerance is made relative to
        # this pass's right-hand side
        passes += 1
        itol = float((inner_tol * rnorm) ** 2)
        eff = effective_compute_dtype(Opn)
        ndt = Opn.dtype
        if solver == "cgls" and damp:
            rhs = _as(g, ndt)
            d, it, _, code = _run_guarded("cg", _NormalOperator(Opn, damp),
                                          rhs, None, inner_niter, itol, 0.0,
                                          {}, M=M)
            napp = 2.0 * (it + 1)  # each normal apply is two of A
        else:
            rhs = _as(s, ndt)
            d, it, _, code = _run_guarded(solver, Opn, rhs, None,
                                          inner_niter, itol, 0.0,
                                          solver_kwargs, M=M)
            napp = float(per_apply) * (it + 1)
        total_iiter += it
        n_narrow += napp
        attempts.append({"compute_dtype": dtype_name(eff), "iiter": it,
                         "status": _rstatus.status_name(code),
                         "residual": rnorm})
        _metrics.inc("solver.refine.passes")

        # ---- the wide correction
        x_prev = x
        prev_norm = rnorm
        x = x + _as(d, wide_dtype)
        if code not in (_rstatus.CONVERGED, _rstatus.MAXITER):
            nxt = escalate_dtype(eff)
            if nxt is not None:
                _trace.event("solver.refine_escalate", cat="resilience",
                             solver=solver, at_pass=passes,
                             to_dtype=dtype_name(nxt))
                _metrics.inc("solver.refine.escalations")
                Opn = make_op(nxt)

    _metrics.inc("solver.refine.narrow_matvecs", n_narrow)
    _metrics.inc("solver.refine.wide_matvecs", n_wide)
    frac = n_narrow / max(1.0, n_narrow + n_wide)
    return RefinedResult(x=x, status=status, iiter=total_iiter,
                         passes=passes, residuals=residuals,
                         narrow_frac=frac, attempts=attempts)
