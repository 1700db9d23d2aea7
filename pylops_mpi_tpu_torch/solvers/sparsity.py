"""ISTA / FISTA sparse solvers.

PyTorch counterpart of ``pylops_mpi_tpu/solvers/sparsity.py`` (the
reference's ``pylops_mpi/optimization/cls_sparsity.py``, ISTA
``49-485`` and FISTA ``486-715``, and the functional ``sparsity.py``).
The thresholds apply elementwise to the model's tensor; the step size
defaults to ``1/λmax(OpᴴOp)`` from :func:`power_iteration`, cached per
operator object; the cost is ``½‖r‖² + ε‖x‖₁``.

Two execution paths, as in the JAX package:

- the class API (:class:`ISTA`, :class:`FISTA`): ``setup``/``step``/
  ``run``/``finalize``/``solve`` with ``callback``, ``show`` and
  ``monitorres``, which read their scalars on the host every
  iteration;
- the fused path (the functional :func:`ista`/:func:`fista` without
  hooks): every scalar stays on the device. A device ``active`` mask
  freezes ``x``, ``z``, ``t``, the count and the cost buffer at the
  iteration where ``xupdate ≤ tol`` stopped the loop, and the host
  reads the mask every ``_CHECK_EVERY`` iterations to leave early, so
  the result equals the JAX package's ``lax.while_loop`` exactly.

With ``guards`` on (JAX ``sparsity.py:278-375``; ``ista_guarded``/
``fista_guarded`` return the word) the fused loop also carries a status
word: a non-finite cost or update rejects the step (``x``, ``z`` and
``t`` keep their last finite values) and ends the loop with
``BREAKDOWN``, a cost that has not improved for ``GUARD_STALL``
iterations with ``STAGNATION``. A guarded solve consumes the armed fault
of :mod:`..resilience.faults` (NaN at ``Op x``, stall at the step). The
JAX package's telemetry is not ported.
"""

from __future__ import annotations

import math
import time
import weakref
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..diagnostics import trace as _trace
from ..distributedarray import DistributedArray
from ..ops._precision import reduction_dtype
from ..stacked import StackedDistributedArray
from .basic import _counter, _record, _slot, _step_scalar
from .eigs import _where, power_iteration

__all__ = ["ISTA", "FISTA", "ista", "fista", "ista_guarded",
           "fista_guarded"]

Vector = Union[DistributedArray, StackedDistributedArray]


def _sqrt(v):
    return torch.sqrt(v) if isinstance(v, torch.Tensor) else math.sqrt(v)


def _softthreshold(x: torch.Tensor, thresh) -> torch.Tensor:
    r = torch.clamp(torch.abs(x) - thresh, min=0.0)
    if x.is_complex():
        # the phase through exp(1j·angle): no division by |x|
        return r * torch.exp(1j * torch.angle(x))
    return r * torch.sign(x)


def _hardthreshold(x: torch.Tensor, thresh) -> torch.Tensor:
    return x.masked_fill(torch.abs(x) <= _sqrt(2 * thresh), 0)


def _halfthreshold(x: torch.Tensor, thresh) -> torch.Tensor:
    # (|x|/3)^-1.5 is inf at x = 0; the clamp takes it to 1, arccos to 0,
    # and the cut below zeroes that entry, so no NaN reaches the result
    arg = torch.clamp((thresh / 8.0) * (torch.abs(x) / 3.0) ** (-1.5),
                      -1.0, 1.0)
    # Xu et al.: h(x) = 2/3 x (1 + cos(2π/3 − 2/3 φ)),
    # φ = arccos((λ/8)(|x|/3)^(−3/2))
    phi = 2.0 / 3.0 * torch.arccos(arg)
    x1 = 2.0 / 3.0 * x * (1 + torch.cos(2.0 * math.pi / 3.0 - phi))
    cut = (54 ** (1.0 / 3.0) / 4.0) * thresh ** (2.0 / 3.0)
    return x1.masked_fill(torch.abs(x) <= cut, 0)


_THRESHF = {"soft": _softthreshold, "hard": _hardthreshold,
            "half": _halfthreshold}


def _apply_thresh(x: Vector, threshf: Callable, thresh) -> Vector:
    """ref ``cls_sparsity.py:21-46``"""
    if isinstance(x, DistributedArray):
        return DistributedArray._wrap(threshf(x.array, thresh), x)
    return StackedDistributedArray([_apply_thresh(d, threshf, thresh)
                                    for d in x.distarrays])


# λmax-based step sizes per operator object and eigsdict: weak keys, so
# an entry goes with its operator and a reused id() cannot hit it
_ALPHA_CACHE: "weakref.WeakKeyDictionary[Any, Dict[tuple, float]]" = \
    weakref.WeakKeyDictionary()


def _step_size(Op, x0: Vector, eigsdict: Optional[Dict[str, Any]]) -> float:
    """``1/λmax(OpᴴOp)`` from :func:`power_iteration` (ref
    ``cls_sparsity.py:239-255``)."""
    Op1 = Op.H @ Op
    b_k = x0.zeros_like() if isinstance(x0, DistributedArray) else x0.copy()
    maxeig = np.abs(power_iteration(Op1, b_k=b_k, dtype=Op1.dtype,
                                    **(eigsdict or {}))[0])
    return float(1.0 / maxeig)


def _cached_step_size(Op, x0: Vector, eigsdict) -> float:
    """:func:`_step_size` computed once per operator object and
    ``eigsdict``."""
    key = tuple(sorted((eigsdict or {}).items()))
    per_op = _ALPHA_CACHE.setdefault(Op, {})
    if key not in per_op:
        per_op[key] = _step_size(Op, x0, eigsdict)
    return per_op[key]


class ISTA:
    """Iterative Shrinkage-Thresholding Algorithm
    (ref ``cls_sparsity.py:49-485``). The class API reads three or four
    scalars on the host every iteration (``xupdate``, the two cost
    terms, and the residual norm under ``monitorres``); the functional
    :func:`ista` without hooks runs the fused path instead."""

    def __init__(self, Op):
        self.Op = Op
        self.callback = lambda x: None
        self.tstart = time.time()

    def setup(self, y: Vector, x0: Vector, niter: Optional[int] = None,
              SOp=None, eps: float = 0.1, alpha: Optional[float] = None,
              eigsdict: Optional[Dict[str, Any]] = None, tol: float = 1e-10,
              threshkind: str = "soft", perc: Optional[float] = None,
              decay: Optional[np.ndarray] = None, monitorres: bool = False,
              show: bool = False) -> Vector:
        if threshkind not in _THRESHF:
            raise NotImplementedError(
                "threshkind should be hard, soft or half")
        if perc is not None:
            raise NotImplementedError(
                "percentile thresholding is not implemented")
        self.y = y
        self.SOp = SOp
        self.niter = niter
        self.eps = eps
        self.tol = tol
        self.monitorres = monitorres
        self.threshf = _THRESHF[threshkind]
        self.eigsdict = {} if eigsdict is None else eigsdict
        self.decay = decay if decay is not None else np.ones(niter or 1)
        self.alpha = (alpha if alpha is not None
                      else _step_size(self.Op, x0, self.eigsdict))
        self.thresh = eps * self.alpha * 0.5
        x = x0.copy()
        if monitorres:
            self.normresold = np.inf
        self.t = 1.0
        self.cost = []
        self.iiter = 0
        if show:
            self._print_setup()
        return x

    def _check_residual(self, res: Vector) -> None:
        """``monitorres``: stop when the residual norm grows
        (ref ``cls_sparsity.py:298-307``)."""
        if not self.monitorres:
            return
        normres = float(res.norm())
        if normres > self.normresold:
            raise ValueError(
                f"{type(self).__name__} stopped at iteration {self.iiter} "
                "due to residual increasing, consider modifying eps "
                "and/or alpha...")
        self.normresold = normres

    def _threshold(self, x_unthresh: Vector) -> Vector:
        """``SOp``-transformed threshold at this iteration's decay."""
        if self.SOp is not None:
            x_unthresh = self.SOp.rmatvec(x_unthresh)
        x = _apply_thresh(x_unthresh, self.threshf,
                          self.decay[min(self.iiter, len(self.decay) - 1)]
                          * self.thresh)
        if self.SOp is not None:
            x = self.SOp.matvec(x)
        return x

    def _finish_step(self, x, xold, res, show):
        xupdate = float((x - xold).norm())
        costdata = 0.5 * float(res.norm()) ** 2
        costreg = self.eps * float(x.norm(1))
        self.cost.append(costdata + costreg)
        self.iiter += 1
        if show:
            self._print_step(x, costdata, costreg, xupdate)
        return x, xupdate

    def step(self, x: Vector, show: bool = False) -> Tuple[Vector, float]:
        """ref ``cls_sparsity.py:309-343``"""
        xold = x.copy()
        res = self.y - self.Op.matvec(x)
        self._check_residual(res)
        x = self._threshold(x + self.Op.rmatvec(res) * self.alpha)
        return self._finish_step(x, xold, res, show)

    def run(self, x: Vector, niter: Optional[int] = None, show: bool = False,
            itershow=(10, 10, 10)) -> Vector:
        xupdate = np.inf
        niter = self.niter if niter is None else niter
        if niter is None:
            raise ValueError("niter must not be None")
        while self.iiter < niter and xupdate > self.tol:
            showstep = show and (self.iiter < itershow[0]
                                 or niter - self.iiter < itershow[1]
                                 or self.iiter % itershow[2] == 0)
            x, xupdate = self.step(x, showstep)
            self.callback(x)
        return x

    def finalize(self, show: bool = False) -> None:
        self.tend = time.time()
        self.telapsed = self.tend - self.tstart
        self.cost = np.asarray(self.cost)

    def solve(self, y: Vector, x0: Vector, niter: Optional[int] = None,
              SOp=None, eps: float = 0.1, alpha: Optional[float] = None,
              eigsdict=None, tol: float = 1e-10, threshkind: str = "soft",
              perc=None, decay=None, monitorres: bool = False,
              show: bool = False, itershow=(10, 10, 10)
              ) -> Tuple[Vector, int, np.ndarray]:
        x = self.setup(y=y, x0=x0, niter=niter, SOp=SOp, eps=eps, alpha=alpha,
                       eigsdict=eigsdict, tol=tol, threshkind=threshkind,
                       perc=perc, decay=decay, monitorres=monitorres,
                       show=show)
        x = self.run(x, niter, show=show, itershow=itershow)
        self.finalize(show)
        return x, self.iiter, self.cost

    def _print_setup(self):
        print(f"{type(self).__name__}\neps = {self.eps:.2e}\t"
              f"alpha = {self.alpha:.2e}\tniter = {self.niter}")

    def _print_step(self, x, costdata, costreg, xupdate):
        print(f"{self.iiter:6g}  {costdata + costreg:11.4e}  "
              f"{xupdate:11.4e}")


class FISTA(ISTA):
    """Fast ISTA with Nesterov momentum
    (ref ``cls_sparsity.py:486-715``; momentum ``645-649``). The cost
    takes a third apply, ``y − Op x_new``."""

    def setup(self, *args, **kwargs) -> Vector:
        x = super().setup(*args, **kwargs)
        self.z = x.copy()
        return x

    def step(self, x: Vector, show: bool = False) -> Tuple[Vector, float]:
        xold = x.copy()
        res = self.y - self.Op.matvec(self.z)
        self._check_residual(res)
        x = self._threshold(self.z + self.Op.rmatvec(res) * self.alpha)
        told = self.t
        self.t = (1.0 + math.sqrt(1.0 + 4.0 * self.t ** 2)) / 2.0
        self.z = x + (x - xold) * ((told - 1.0) / self.t)
        return self._finish_step(x, xold, self.y - self.Op.matvec(x), show)


# --------------------------------------------------------- fused (on-device)
def _sparse_step(Op, SOp, threshf: Callable, eps: float, thresh: float,
                 tol: float, nd: int, niter: int, momentum: bool,
                 guards: bool = False, stall_n: int = 0, fault=None):
    """One iteration of the JAX package's ``_ista_fused`` loop over the
    carry ``(x, z, t, cost, iiter, active, it, status, bestc, stall,
    xup)`` (``z`` and ``t`` only with ``momentum``, the last four only
    with ``guards``) and the constants ``(y, decay_t, step)``; the decay
    is read through the device index ``it``."""
    from ..resilience import faults
    from .basic import _guard_update, _reject
    nan_at, stall_at = faults.fault_sites(fault if guards else None)

    def step(state, consts):
        x, z, t, cost, iiter, active, it, status, bestc, stall, xup = state
        y, decay_t, stp = consts
        xdt = x.dtype
        rdt = cost.dtype
        xin = z if momentum else x
        mv = Op.matvec(xin)
        if nan_at is not None:
            mv = faults.inject_nan(mv, iiter, nan_at)
        res = y - mv
        if stall_at is not None:
            stp = faults.inject_stall(stp, iiter, stall_at)
        x_unthresh = xin + Op.rmatvec(res) * stp
        if SOp is not None:
            x_unthresh = SOp.rmatvec(x_unthresh)
        decay = decay_t.index_select(0, torch.clamp(it, max=nd - 1))
        xnew = _apply_thresh(x_unthresh, threshf,
                             decay.reshape(()) * thresh)
        if SOp is not None:
            xnew = SOp.matvec(xnew)
        if momentum:
            tnew = (1.0 + torch.sqrt(1.0 + 4.0 * t * t)) / 2.0
            znew = xnew + (xnew - x) * _step_scalar((t - 1.0) / tnew, xdt)
            costdata = 0.5 * (y - Op.matvec(xnew)).norm() ** 2
        else:
            costdata = 0.5 * res.norm() ** 2
        costreg = eps * xnew.norm(1)
        xupdate = (xnew - x).norm().to(rdt)
        costval = (costdata + costreg).to(rdt)
        _record(cost, _slot(it, active, niter), costval)
        if guards:
            bad = ~torch.isfinite(costval) | ~torch.isfinite(xupdate)
            hold = ~active | bad
            if momentum:
                z = _reject(hold, z, znew)
                t = torch.where(hold, t, tnew)
            x = _reject(hold, x, xnew)
            # a rejected step must not look converged
            xupdate = torch.where(bad, torch.full_like(xupdate, math.inf),
                                  xupdate)
            status, bestc, stall = _guard_update(
                status, bestc, stall, bad, costval, torch.zeros_like(bad),
                stall_n, active)
            xup = torch.where(active, xupdate, xup)
        else:
            if momentum:
                z = _where(active, znew, z)
                t = torch.where(active, tnew, t)
            x = _where(active, xnew, x)
        iiter = iiter + active.to(iiter.dtype)
        active = active & (xupdate > tol)
        if guards:
            from ..resilience.status import RUNNING
            active = active & (status == RUNNING)
        return x, z, t, cost, iiter, active, it + 1, status, bestc, stall, xup
    return step


def _sparse_fused(Op, y: Vector, x0: Vector, alpha: float, eps: float,
                  tol: float, decay: np.ndarray, *, niter: int,
                  threshf: Callable, SOp=None, momentum: bool = False,
                  guards: bool = False, fault=None):
    """The JAX package's ``_ista_fused`` loop with device scalars,
    through :mod:`..aot.graphs`; the host checks ``active`` at the top
    of iterations 8, 16, …. The step, decay and momentum scalars live
    at the model's reduction dtype (so a Python float never promotes an
    f32 model), as do ``xupdate`` and the cost; the step re-enters the
    update at the model's dtype. Returns ``(x, iiter, cost[:iiter],
    code)``, ``code`` the status word with ``guards``, else ``None``."""
    from ..aot import graphs
    from .basic import _fault_key, _resolve_status, _status0
    xdt = x0.dtype
    rdt = reduction_dtype(xdt)
    dev = x0.device
    thresh = eps * alpha * 0.5
    decay = np.asarray(decay)
    decay_t = torch.as_tensor(decay, dtype=rdt, device=dev)
    step = _step_scalar(torch.tensor(alpha, dtype=rdt, device=dev), xdt)
    stall_n = 0
    guard = (None, None, None, None)
    if guards:
        from ..resilience.status import stall_window
        stall_n = stall_window()
        guard = (_status0(dev), torch.tensor(math.inf, dtype=rdt, device=dev),
                 torch.zeros((), dtype=torch.int32, device=dev),
                 torch.tensor(math.inf, dtype=rdt, device=dev))
    state = (x0, x0.copy() if momentum else None,
             torch.tensor(1.0, dtype=rdt, device=dev) if momentum else None,
             torch.zeros(niter + 1, dtype=rdt, device=dev),
             torch.zeros((), dtype=torch.int64, device=dev),
             torch.ones((), dtype=torch.bool, device=dev),
             _counter(dev)) + guard
    loop = graphs.Loop(
        "fista" if momentum else "ista",
        dict(alpha=alpha, eps=eps, tol=tol, decay=tuple(decay.tolist()),
             threshf=threshf.__name__, sop=SOp is not None,
             **({"guards": True, "stall": stall_n} if guards else {}),
             **_fault_key(guards, fault)),
        Op, SOp, y, state, (y, decay_t, step),
        _sparse_step(Op, SOp, threshf, eps, thresh, tol,
                     decay_t.shape[0], niter, momentum, guards, stall_n,
                     fault))
    x, _, _, cost, iiter, _, _, status, _, _, xup = graphs.run_iterations(
        loop, lambda st: st[5], niter)
    iiter = int(iiter)
    code = _resolve_status(status, xup, tol) if guards else None
    return x, iiter, cost[:iiter], code


def _sparse_solve(name, Op, y, x0, niter, SOp, eps, alpha, eigsdict, tol,
                  threshkind, perc, decay, monitorres, show, itershow,
                  callback, fused, guards=None):
    """Shared body of :func:`ista` and :func:`fista`, inside the
    ``solver.<name>`` span (JAX ``sparsity.py:485``, ``:526``;
    ``telemetry`` is always false here: it is not ported). Returns the
    fused path's ``(x, iiter, cost, code)`` or the class API's
    ``(x, iiter, cost)``."""
    from ..resilience.status import guards_enabled
    use_fused = fused if fused is not None else \
        (callback is None and not show and not monitorres and perc is None)
    use_guards = use_fused and guards_enabled(guards)
    with _trace.span(f"solver.{name}", cat="solver", op=type(Op).__name__,
                     shape=Op.shape, niter=niter, eps=eps,
                     threshkind=threshkind, fused=use_fused,
                     guards=use_guards, telemetry=False):
        out = _sparse_run(name, Op, y, x0, niter, SOp, eps, alpha,
                          eigsdict, tol, threshkind, perc, decay,
                          monitorres, show, itershow, callback, use_fused,
                          use_guards)
    if use_guards:
        from ..resilience import status as _rstatus
        _rstatus.record(name, out[3], out[1])
    return out


def _sparse_run(name, Op, y, x0, niter, SOp, eps, alpha, eigsdict, tol,
                threshkind, perc, decay, monitorres, show, itershow,
                callback, use_fused, guards=False):
    momentum = name == "fista"
    if not use_fused:
        solver = (FISTA if momentum else ISTA)(Op)
        if callback is not None:
            solver.callback = callback
        return solver.solve(y, x0, niter=niter, SOp=SOp, eps=eps,
                            alpha=alpha, eigsdict=eigsdict, tol=tol,
                            threshkind=threshkind, perc=perc, decay=decay,
                            monitorres=monitorres, show=show,
                            itershow=itershow)
    if callback is not None or show or monitorres:
        raise ValueError("fused=True cannot honor callback/show/"
                         "monitorres; use fused=False for hooks")
    if perc is not None:
        raise NotImplementedError("percentile thresholding is not "
                                  "implemented")
    if threshkind not in _THRESHF:
        raise NotImplementedError("threshkind should be hard, soft or half")
    if x0 is None:
        raise ValueError("x0 required")
    if alpha is None:
        alpha = _cached_step_size(Op, x0, eigsdict)
    decay = np.ones(niter) if decay is None else np.asarray(decay)
    fault = None
    if guards:
        from ..resilience import faults
        fault = faults.consume()
    return _sparse_fused(Op, y, x0, alpha, eps, tol, decay, niter=niter,
                         threshf=_THRESHF[threshkind], SOp=SOp,
                         momentum=momentum, guards=guards, fault=fault)


def ista(Op, y: Vector, x0: Optional[Vector] = None,
         niter: int = 10, SOp=None, eps: float = 0.1,
         alpha: Optional[float] = None, eigsdict=None, tol: float = 1e-10,
         threshkind: str = "soft", perc=None, decay=None,
         monitorres: bool = False, show: bool = False, itershow=(10, 10, 10),
         callback: Optional[Callable] = None, fused: Optional[bool] = None,
         guards: Optional[bool] = None):
    """Functional ISTA (ref ``optimization/sparsity.py:11-133``).
    Returns ``(x, iiter, cost)``. Without ``callback``, ``show`` or
    ``monitorres`` it runs the fused path (``cost`` a device tensor);
    with them, or ``fused=False``, the class API (``cost`` a numpy
    array). ``guards`` (``None`` defers to
    ``PYLOPS_MPI_TPU_TORCH_GUARDS``) adds the guard carry to the fused
    loop; the verdict lands in ``resilience.status.last_status("ista")``."""
    return _sparse_solve("ista", Op, y, x0, niter, SOp, eps, alpha,
                         eigsdict, tol, threshkind, perc, decay, monitorres,
                         show, itershow, callback, fused, guards)[:3]


def fista(Op, y: Vector, x0: Optional[Vector] = None,
          niter: int = 10, SOp=None, eps: float = 0.1,
          alpha: Optional[float] = None, eigsdict=None, tol: float = 1e-10,
          threshkind: str = "soft", perc=None, decay=None,
          monitorres: bool = False, show: bool = False, itershow=(10, 10, 10),
          callback: Optional[Callable] = None, fused: Optional[bool] = None,
          guards: Optional[bool] = None):
    """Functional FISTA (ref ``optimization/sparsity.py:136-257``); see
    :func:`ista`."""
    return _sparse_solve("fista", Op, y, x0, niter, SOp, eps, alpha,
                         eigsdict, tol, threshkind, perc, decay, monitorres,
                         show, itershow, callback, fused, guards)[:3]


def ista_guarded(Op, y: Vector, x0: Vector, niter: int = 10, SOp=None,
                 eps: float = 0.1, alpha: Optional[float] = None,
                 eigsdict=None, tol: float = 1e-10, threshkind: str = "soft",
                 decay=None):
    """Guarded fused ISTA (JAX ``sparsity.py:552-566``): ``(x, iiter,
    cost, status_code)``; on breakdown ``x`` is the last finite
    iterate."""
    return _sparse_solve("ista", Op, y, x0, niter, SOp, eps, alpha,
                         eigsdict, tol, threshkind, None, decay, False,
                         False, (10, 10, 10), None, True, True)


def fista_guarded(Op, y: Vector, x0: Vector, niter: int = 10, SOp=None,
                  eps: float = 0.1, alpha: Optional[float] = None,
                  eigsdict=None, tol: float = 1e-10, threshkind: str = "soft",
                  decay=None):
    """Guarded fused FISTA (JAX ``sparsity.py:569-581``): ``(x, iiter,
    cost, status_code)``; see :func:`ista_guarded`."""
    return _sparse_solve("fista", Op, y, x0, niter, SOp, eps, alpha,
                         eigsdict, tol, threshkind, None, decay, False,
                         False, (10, 10, 10), None, True, True)
