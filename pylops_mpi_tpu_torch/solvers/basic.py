"""CG / CGLS solvers.

PyTorch counterpart of ``pylops_mpi_tpu/solvers/basic.py``: the class
API (``CG``, ``CGLS``, lines 152-356) and the fused engines
(``_cgls_setup``, ``_make_cgls_body`` in both schedules and
``_make_cg_body``, lines 416-703), themselves rebuilds of the
reference's ``pylops_mpi/optimization/cls_basic.py``.

The classes keep the reference's ``setup``/``step``/``run``/
``finalize``/``solve`` with a per-iteration ``callback`` and ``show``;
their ``run`` reads ``kold`` on the host every iteration, as the
reference's loop test demands. The functional ``cg``/``cgls`` below are
the fast path. They take the preconditioner seam ``M=`` (JAX
``_precond_apply``, ``basic.py:100-112``): ``z = M r`` replaces ``r`` in
the recurrence norm (``kold = r·z``, tested absolutely against ``tol``)
and in the direction update; ``M=None`` runs the unpreconditioned loop
op for op. Under ``PYLOPS_MPI_TPU_TORCH_CA`` other than ``off`` they
hand the solve to the communication-avoiding engines
(:mod:`.ca`).

The JAX package runs a solve as one ``lax.while_loop`` that leaves when
``iiter == niter`` or ``max(kold) <= tol``. Here the loop is a Python
loop whose scalars all stay on the device: an ``active = kold > tol``
mask, computed on the device each iteration, zeroes the step, holds x
and stops ``iiter`` and the cost buffers once the condition fails, so
the result equals the while loop's exit exactly (a non-finite ``y``
returns ``x0`` with ``iiter = 0``). Each loop is a setup, a step over a
carry of tensors (the iteration index ``it`` a device tensor too, so
the histories are written through it), and the host's read of the
condition every ``SEGMENT`` (8) iterations, to leave the loop early;
:mod:`..aot.graphs` runs the steps, and with
``PYLOPS_MPI_TPU_TORCH_AOT=on`` replays each run of 8 between two
checks as one captured CUDA graph, bit for bit the same. With
``guards`` on (JAX ``basic.py:342-400``) the loop also carries a status
word (:mod:`..resilience.status`) in device tensors; ``cg_guarded`` and
``cgls_guarded`` return it. A guarded solve consumes the armed fault of
:mod:`..resilience.faults` (JAX ``basic.py:444``, ``:448``, ``:550``,
``:561``, ``:599-600``), which then joins its loop's key.

Preserved from the JAX package: the recurrence dots at the policy's
reduction dtype (``_rdot``), step scalars re-entering vector updates at
the carry dtype (``_step_scalar``), the machine-precision freeze
(``_mp_floor``), the ``(niter+1)`` cost buffers, and the reference's
setup quirk — CGLS damps the first normal residual by ``damp`` while the
iterations use ``damp**2`` (ref ``cls_basic.py:345-350`` vs ``392-393``).

Data may be a :class:`StackedDistributedArray` (the regularized systems
of ``MPIStackedVStack``); without ``x0`` the model starts at zero in the
operator's model space (:func:`_zero_like_model`).
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Union

import torch

from ..diagnostics import metrics as _metrics
from ..diagnostics import telemetry
from ..diagnostics import trace as _trace
from ..distributedarray import DistributedArray, Partition
from ..ops._precision import reduction_dtype
from ..parallel.mesh import rank
from ..stacked import StackedDistributedArray

__all__ = ["CG", "CGLS", "cg", "cgls", "cg_guarded", "cgls_guarded"]

Vector = Union[DistributedArray, StackedDistributedArray]

# what the CG-family loops record an iteration with telemetry on (JAX
# ``basic.py:471``, ``:580``, ``:631``): the residual norm of the cost
# history, the recurrence norm and the step
_TELEMETRY = ("resid", "k", "alpha")

def _rdot(u: Vector, v: Vector) -> torch.Tensor:
    """Recurrence dot ``|u·conj(v)|`` at the policy reduction dtype,
    through :func:`~..parallel.collectives.reduce_stall` (the latency
    stand-in, ``k`` itself unless armed; JAX ``basic.py:59-76``)."""
    from ..parallel.collectives import reduce_stall
    return reduce_stall(torch.abs(u.dot(v.conj())).to(
        reduction_dtype(u.dtype)))


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


def _zero_like_model(Op, y: Vector) -> DistributedArray:
    """Zero model of ``Op``'s model shape and split (``local_shapes_m``
    where the operator fixes one) with the data's mask, at the
    operator's dtype (made complex
    for complex data) on the operator's device, or the data's where the
    operator holds no tensors."""
    dtype = y.dtype if Op.dtype is None else torch.promote_types(Op.dtype,
                                                                 y.dtype)
    device = getattr(Op, "device", None) or y.device
    partition = (y.partition if isinstance(y, DistributedArray)
                 else Partition.SCATTER)
    local_shapes = (Op.local_shapes_m if partition == Partition.SCATTER
                    else None)
    return DistributedArray(global_shape=Op.shape[1], partition=partition,
                            local_shapes=local_shapes,
                            mask=getattr(y, "mask", None), dtype=dtype,
                            device=device)


def _damped_norm(sn: torch.Tensor, damp2: float, x: Vector) -> torch.Tensor:
    """``sqrt(sn² + damp²·x·x)``; without damping the ``x·x`` reduction
    (one collective under a group) is skipped: adding ``0·x·x`` changes
    no bit of a finite result."""
    if not damp2:
        return torch.sqrt(sn ** 2)
    return torch.sqrt(sn ** 2 + damp2 * _rdot(x, x))


def _cast_vec(v: Vector, dt: torch.dtype) -> Vector:
    """A (possibly stacked) distributed vector cast to ``dt``."""
    if isinstance(v, StackedDistributedArray):
        return StackedDistributedArray([_cast_vec(d, dt)
                                        for d in v.distarrays])
    return DistributedArray._wrap(v.array.to(dt), v)


def _precond_apply(M, r: Vector, xdt: torch.dtype) -> Vector:
    """The preconditioner seam ``z = M r`` (``M.matvec``: the operator
    is the approximate inverse), cast back to the carry dtype.
    ``M=None`` returns ``r`` itself, so the unpreconditioned loop runs
    the same operations as before the seam existed."""
    if M is None:
        return r
    z = M.matvec(r)
    if z.dtype != xdt:
        z = _cast_vec(z, xdt)
    return z


def _slot(it: torch.Tensor, active, spare: int) -> torch.Tensor:
    """The history row an iteration records into: ``it`` (a ``(1,)``
    device index) while the loop is live, else the buffer's ``spare``
    last row, which no result returns."""
    return torch.where(active, it, spare)


def _record(buf: torch.Tensor, slot: torch.Tensor, value) -> None:
    """``buf[slot] = value`` on the device (no host sync; a captured
    segment replays it at any offset)."""
    buf.index_copy_(0, slot, value.unsqueeze(0).to(buf.dtype))


def _history(first: torch.Tensor, niter: int) -> torch.Tensor:
    """The ``(niter+2, ...)`` history buffer, ``first`` in row 0; rows
    ``1..niter`` take the iterations, the last is :func:`_slot`'s
    spare."""
    buf = torch.zeros((niter + 2,) + tuple(first.shape), dtype=first.dtype,
                      device=first.device)
    buf[0] = first
    return buf


def _counter(device) -> torch.Tensor:
    """The device iteration index ``it`` of a loop's carry."""
    return torch.zeros(1, dtype=torch.int64, device=device)


class _BaseSolver:
    def __init__(self, Op):
        self.Op = Op
        self.callback = lambda x: None
        self.tstart = time.time()

    def memory_usage(self) -> None:
        """No-op hook, reference Solver-ABC parity
        (ref ``cls_basic.py:54-55``)."""

    def run(self, x: Vector, niter: Optional[int] = None,
            show: bool = False, itershow=(10, 10, 10)) -> Vector:
        niter = self.niter if niter is None else niter
        if niter is None:
            raise ValueError("niter must not be None")
        while self.iiter < niter and float(self.kold) > self.tol:
            showstep = show and (self.iiter < itershow[0]
                                 or niter - self.iiter < itershow[1]
                                 or self.iiter % itershow[2] == 0)
            x = self.step(x, showstep)
            self.callback(x)
        return x

    def _print_setup(self):
        if rank() == 0:
            print(f"{type(self).__name__}\ntol = {self.tol:10e}\t"
                  f"niter = {self.niter}")

    def _print_step(self, x):
        cost = float(self.cost[self.iiter])  # every rank reads it
        if rank() == 0:
            print(f"{self.iiter:6g}        {cost:11.4e}")


class CG(_BaseSolver):
    """Conjugate gradient for square operators
    (ref ``cls_basic.py:12-249``); the scalars of a step stay on the
    device, ``run`` reads ``kold`` once an iteration."""

    def setup(self, y: Vector, x0: Vector, niter: Optional[int] = None,
              tol: float = 1e-4, show: bool = False) -> Vector:
        self.y = y
        self.tol = tol
        self.niter = niter
        x = x0.copy()
        self.r = self.y - self.Op.matvec(x)
        self.c = self.r.copy()
        self.kold = _rdot(self.r, self.r)
        self.cost = [torch.sqrt(self.kold)]
        self.iiter = 0
        if show:
            self._print_setup()
        return x

    def step(self, x: Vector, show: bool = False) -> Vector:
        """One CG step (ref ``cls_basic.py:112-141``)."""
        xdt = x.dtype
        Opc = self.Op.matvec(self.c)
        a = _step_scalar(self.kold / _rdot(self.c, Opc), xdt)
        x = x + self.c * a
        self.r = self.r - Opc * a
        k = _rdot(self.r, self.r)
        self.c = self.r + self.c * _step_scalar(k / self.kold, xdt)
        self.kold = k
        self.iiter += 1
        self.cost.append(torch.sqrt(self.kold))
        if show:
            self._print_step(x)
        return x

    def finalize(self, show: bool = False) -> None:
        self.tend = time.time()
        self.telapsed = self.tend - self.tstart
        self.cost = torch.stack(self.cost).cpu().numpy()

    def solve(self, y: Vector, x0: Vector, niter: int = 10, tol: float = 1e-4,
              show: bool = False, itershow=(10, 10, 10)):
        """Returns ``(x, iiter, cost)``, ``cost`` a numpy array."""
        x = self.setup(y=y, x0=x0, niter=niter, tol=tol, show=show)
        x = self.run(x, niter, show=show, itershow=itershow)
        self.finalize(show)
        return x, self.iiter, self.cost


class CGLS(_BaseSolver):
    """Damped least-squares CGLS (ref ``cls_basic.py:252-531``), the
    classic two-sweep schedule; like :class:`CG`, ``run`` reads ``kold``
    once an iteration."""

    def setup(self, y: Vector, x0: Vector, niter: Optional[int] = None,
              damp: float = 0.0, tol: float = 1e-4,
              show: bool = False) -> Vector:
        self.y = y
        self.damp = damp ** 2
        self.tol = tol
        self.niter = niter
        x = x0.copy()
        self.s = self.y - self.Op.matvec(x)
        # the reference's un-squared setup damp (see the module doc)
        r = self.Op.rmatvec(self.s) - x * damp
        self.c = r.copy()
        self.q = self.Op.matvec(self.c)
        self.kold = _rdot(r, r)
        self.cost = [self.s.norm()]
        self.cost1 = [torch.sqrt(self.cost[0] ** 2
                                 + self.damp * _rdot(x, x))]
        self.iiter = 0
        if show:
            self._print_setup()
        return x

    def step(self, x: Vector, show: bool = False) -> Vector:
        """One CGLS step (ref ``cls_basic.py:373-404``)."""
        xdt = x.dtype
        a = torch.abs(self.kold / (_rdot(self.q, self.q)
                                   + self.damp * _rdot(self.c, self.c)))
        a = _step_scalar(a, xdt)
        x = x + self.c * a
        self.s = self.s - self.q * a
        r = self.Op.rmatvec(self.s) - x * self.damp
        k = _rdot(r, r)
        self.c = r + self.c * _step_scalar(k / self.kold, xdt)
        self.q = self.Op.matvec(self.c)
        self.kold = k
        self.iiter += 1
        self.cost.append(self.s.norm())
        self.cost1.append(torch.sqrt(self.cost[self.iiter] ** 2
                                     + self.damp * _rdot(x, x)))
        if show:
            self._print_step(x)
        return x

    def finalize(self, show: bool = False) -> None:
        self.tend = time.time()
        self.telapsed = self.tend - self.tstart
        self.istop = 1 if float(self.kold) < self.tol else 2
        self.r1norm = self.kold
        self.r2norm = self.cost1[self.iiter]
        self.cost = torch.stack(self.cost).cpu().numpy()
        self.cost1 = torch.stack(self.cost1).cpu().numpy()

    def solve(self, y: Vector, x0: Vector, niter: int = 10, damp: float = 0.0,
              tol: float = 1e-4, show: bool = False, itershow=(10, 10, 10)):
        """Returns ``(x, istop, iiter, r1norm, r2norm, cost)``, ``cost``
        a numpy array."""
        x = self.setup(y=y, x0=x0, niter=niter, damp=damp, tol=tol, show=show)
        x = self.run(x, niter, show=show, itershow=itershow)
        self.finalize(show)
        return x, self.istop, self.iiter, self.r1norm, self.r2norm, self.cost


def _use_fused(name: str, callback, show: bool, fused: Optional[bool],
               M, normal: bool = False) -> bool:
    """Whether a functional solve runs the fused loop (no per-iteration
    hooks) or the class API, with the JAX package's checks
    (``basic.py:685-691``, ``:819-829``)."""
    use_fused = fused if fused is not None else (callback is None
                                                 and not show)
    if use_fused and (callback is not None or show):
        raise ValueError("fused=True cannot honor callback/show; use "
                         "fused=False for per-iteration hooks")
    if M is not None and not use_fused:
        raise ValueError("M= (preconditioning) requires the fused path; "
                         "drop callback/show or pass fused=True")
    if normal and not use_fused:
        raise ValueError("normal=True requires the fused path; drop "
                         "callback/show or pass fused=True")
    return use_fused


# ------------------------------------------------------------------ guards
# With guards on (JAX ``basic.py:342-400``) the fused loops carry a status
# word, the best residual and a stall counter, all device tensors updated
# by a few ``torch.where`` an iteration: a non-finite step, momentum or
# norm scalar rejects the update wholesale (the vectors keep their last
# finite values: scaling the step to zero would not do, ``NaN * 0`` is
# ``NaN``) and ends the loop with BREAKDOWN; ``stall_n`` iterations
# without a new best residual end it with STAGNATION. The loop still
# reads the device once every ``SEGMENT`` iterations.

def _reject(hold, old: Vector, new: Vector) -> Vector:
    """``old`` where ``hold`` else ``new``, over a (stacked) vector;
    ``hold`` is a 0-d mask or a ``(K,)`` mask of block columns."""
    if isinstance(new, StackedDistributedArray):
        return StackedDistributedArray(
            [_reject(hold, o, n)
             for o, n in zip(old.distarrays, new.distarrays)])
    return DistributedArray._wrap(torch.where(hold, old.array, new.array),
                                  new)


def _or_idle(mask: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """``mask | ~active`` in one device op: ``mask`` while the loop is
    live, all true once its condition has failed."""
    return torch.where(active, mask, True)


def _nonfinite(*scalars) -> torch.Tensor:
    """Whether any of the recurrence scalars is NaN or Inf, lane by lane
    for ``(K,)`` scalars."""
    bad = ~torch.isfinite(scalars[0])
    for v in scalars[1:]:
        bad = bad | ~torch.isfinite(v)
    return bad


def _status0(device, K: Optional[int] = None) -> torch.Tensor:
    from ..resilience.status import RUNNING
    shape = () if K is None else (K,)
    return torch.full(shape, RUNNING, dtype=torch.int32, device=device)


def _guard_update(status, bestk, stall, bad, k, done, stall_n: int, live):
    """One step of the scalar guard carry (JAX ``_guard_update``), taken
    only while the loop is ``live``: breakdown beats stagnation; the
    stall counter runs only while the recurrence is neither poisoned
    nor parked at the machine floor (``done``)."""
    from ..resilience.status import BREAKDOWN, STAGNATION
    kmax = torch.max(k)
    improved = (kmax < bestk) & ~bad
    frozen = torch.all(done)
    nstall = torch.where(bad | frozen, stall,
                         torch.where(improved, torch.zeros_like(stall),
                                     stall + 1))
    nbest = torch.where(improved, kmax, bestk)
    nstatus = torch.where(bad, torch.full_like(status, BREAKDOWN),
                          torch.where(nstall >= stall_n,
                                      torch.full_like(status, STAGNATION),
                                      status))
    return (torch.where(live, nstatus, status),
            torch.where(live, nbest, bestk),
            torch.where(live, nstall, stall))


def _resolve_status(status, kold, tol: float) -> int:
    """The verdict after the loop: the guard's, else converged when
    ``max(kold) <= tol``, else maxiter; elementwise for block columns
    (then a list)."""
    from ..resilience.status import CONVERGED, MAXITER, RUNNING
    out = torch.where(status != RUNNING, status,
                      torch.where(kold <= tol,
                                  torch.full_like(status, CONVERGED),
                                  torch.full_like(status, MAXITER)))
    return int(out) if out.dim() == 0 else [int(c) for c in out.tolist()]


def _live(kold, tol: float, status=None) -> torch.Tensor:
    """The loop's condition on the device: ``max(kold) > tol``
    (unguarded), or some column above ``tol`` with no verdict yet
    (guarded; JAX ``block.py:247-250``)."""
    if status is None:
        return kold > tol if kold.dim() == 0 else torch.max(kold) > tol
    from ..resilience.status import RUNNING
    return torch.any((kold > tol) & (status == RUNNING))


def _guard_start(kold, guards: bool):
    """The scalar guard carry's start ``(status, bestk, stall)`` and the
    stall window, or Nones and 0 with guards off."""
    if not guards:
        return (None, None, None), 0
    from ..resilience.status import stall_window
    return ((_status0(kold.device), kold.clone(),
             torch.zeros((), dtype=torch.int32, device=kold.device)),
            stall_window())


def _cg_step(Op, M, tol: float, guards: bool, stall_n: int, niter: int,
             fault=None):
    """One iteration of the fused CG loop over the carry ``(x, r, c,
    kold, iiter, it, cost, status, bestk, stall)`` and the constant
    ``(floors,)``; ``fault`` (guarded loops only) injects at the first
    apply and the step scalar."""
    from ..resilience import faults
    nan_at, stall_at = faults.fault_sites(fault if guards else None)

    def step(state, consts):
        x, r, c, kold, iiter, it, cost, status, bestk, stall = state
        (floors,) = consts
        xdt = x.dtype
        active = _live(kold, tol, status)
        done = kold <= floors
        frozen = _or_idle(done, active)
        Opc = Op.matvec(c)
        if nan_at is not None:
            Opc = faults.inject_nan(Opc, iiter, nan_at)
        a = torch.where(frozen, torch.zeros_like(kold), kold / _rdot(c, Opc))
        if stall_at is not None:
            a = faults.inject_stall(a, iiter, stall_at)
        xn = x + c * _step_scalar(a, xdt)
        rn = r - Opc * _step_scalar(a, xdt)
        zn = _precond_apply(M, rn, xdt)
        k = torch.where(frozen, kold, _rdot(rn, zn))
        b = torch.where(frozen, torch.zeros_like(k), k / kold)
        cn = zn + c * _step_scalar(b, xdt)
        if guards:
            bad = _nonfinite(a, k, b)
            hold = _or_idle(bad, active)
            x, r, c = (_reject(hold, x, xn), _reject(hold, r, rn),
                       _reject(hold, c, cn))
            k = torch.where(bad, kold, k)
            status, bestk, stall = _guard_update(status, bestk, stall, bad,
                                                 k, done, stall_n, active)
        else:
            x, r, c = _reject(active, xn, x), rn, cn  # x held once idle
        iiter = iiter + active.to(iiter.dtype)
        it = it + 1
        slot = _slot(it, active, niter + 1)
        _record(cost, slot, torch.sqrt(k))
        telemetry.iteration(slot, torch.sqrt(k), k, a)
        return x, r, c, k, iiter, it, cost, status, bestk, stall
    return step


def _cg_setup(Op, y: Vector, x: Vector, niter: int, M, guards: bool):
    """The fused CG loop's first carry, its constants ``(floors,)`` and
    the stall window (shared with :mod:`.segmented`), under a
    ``solver.setup`` span."""
    with _trace.span("solver.setup", cat="solver", solver="cg"):
        r = y - Op.matvec(x)
        z = _precond_apply(M, r, x.dtype)
        kold = _rdot(r, z)
        cost = _history(torch.sqrt(kold), niter)
        guard, stall_n = _guard_start(kold, guards)
        state = (x, r, z, kold, torch.zeros((), dtype=torch.int64,
                                            device=kold.device),
                 _counter(kold.device), cost) + guard
        return state, (_mp_floor(kold),), stall_n


def _cg_loop(Op, M, y, state, consts, niter: int, tol: float, guards: bool,
             stall_n: int, fault=None):
    """The fused CG loop over ``state`` as an :class:`~..aot.graphs.Loop`
    (one key for the fused and the segmented solve)."""
    from ..aot import graphs
    return graphs.Loop("cg", dict(tol=tol, guards=guards, stall=stall_n,
                                  **_fault_key(guards, fault)),
                       Op, M, y, state, consts,
                       _cg_step(Op, M, tol, guards, stall_n, niter, fault),
                       record=telemetry.Spec("cg", _TELEMETRY, niter + 2))


def _run_cg(Op, y: Vector, x: Vector, niter: int, tol: float, M,
            guards: bool, fault=None):
    """The fused CG loop from ``x``: ``(x, iiter, cost[:iiter+1], code)``,
    ``code`` the status word with guards on, else ``None``. Once the
    loop's condition fails it changes nothing more, so a non-finite
    ``y`` returns ``x`` as given with ``iiter = 0``, as the JAX
    package's ``while_loop`` does. The iterations run through
    :mod:`..aot.graphs` (captured segments when the tier is armed)."""
    from ..aot import graphs
    state, consts, stall_n = _cg_setup(Op, y, x, niter, M, guards)
    loop = _cg_loop(Op, M, y, state, consts, niter, tol, guards, stall_n,
                    fault)
    x, _, _, kold, iiter, _, cost, status, _, _ = graphs.run_iterations(
        loop, lambda st: _live(st[3], tol, st[7]), niter)
    with _trace.span("solver.readback", cat="solver", solver="cg"):
        iiter = int(iiter)
        code = _resolve_status(status, kold, tol) if guards else None
        cost = cost[:iiter + 1]
    return x, iiter, cost, code


def _cgls_step(Op, M, damp: float, tol: float, normal: bool, guards: bool,
               stall_n: int, niter: int, fault=None):
    """One iteration of the fused CGLS loop in either schedule over the
    carry ``(x, s, c, rq, kold, iiter, it, cost, cost1, status, bestk,
    stall)`` (``rq`` the gradient ``r`` with ``normal``, else ``q = Op
    c``) and the constant ``(floors,)``; ``fault`` (guarded loops only)
    injects at ``normal_matvec``'s outputs, or the classic schedule's
    end-of-body ``Op c``, and at the step scalar."""
    from ..resilience import faults
    nan_at, stall_at = faults.fault_sites(fault if guards else None)
    damp2 = damp ** 2

    def step(state, consts):
        x, s, c, rq, kold, iiter, it, cost, cost1, status, bestk, stall = \
            state
        (floors,) = consts
        xdt = x.dtype
        active = _live(kold, tol, status)
        done = kold <= floors
        frozen = _or_idle(done, active)
        if normal:
            u, qn = Op.normal_matvec(c)
            if nan_at is not None:
                u = faults.inject_nan(u, iiter, nan_at)
                qn = faults.inject_nan(qn, iiter, nan_at)
            qq = _rdot(qn, qn)
        else:
            qq = _rdot(rq, rq)
            qn = rq
        a = torch.abs(kold / (qq + damp2 * _rdot(c, c) if damp2 else qq))
        a = torch.where(frozen, torch.zeros_like(a), a)
        if stall_at is not None:
            a = faults.inject_stall(a, iiter, stall_at)
        xn = x + c * _step_scalar(a, xdt)
        sn_ = s - qn * _step_scalar(a, xdt)
        if normal:
            rn = rq - (u + c * damp2) * _step_scalar(a, xdt)
        else:
            rn = Op.rmatvec(sn_) - xn * damp2
        z = _precond_apply(M, rn, xdt)
        k = torch.where(frozen, kold, _rdot(rn, z))
        b = torch.where(frozen, torch.zeros_like(k), k / kold)
        cn = z + c * _step_scalar(b, xdt)
        rqn = rn if normal else Op.matvec(cn)
        if nan_at is not None and not normal:
            rqn = faults.inject_nan(rqn, iiter, nan_at)
        if guards:
            bad = _nonfinite(a, k, b)
            hold = _or_idle(bad, active)
            x, s, c, rq = (_reject(hold, x, xn), _reject(hold, s, sn_),
                           _reject(hold, c, cn), _reject(hold, rq, rqn))
            k = torch.where(bad, kold, k)
            status, bestk, stall = _guard_update(status, bestk, stall, bad,
                                                 k, done, stall_n, active)
        else:
            x, s, c, rq = _reject(active, xn, x), sn_, cn, rqn  # x held
        iiter = iiter + active.to(iiter.dtype)
        it = it + 1
        sn = s.norm()
        slot = _slot(it, active, niter + 1)
        _record(cost, slot, sn)
        _record(cost1, slot, _damped_norm(sn, damp2, x))
        telemetry.iteration(slot, sn, k, a)
        return x, s, c, rq, k, iiter, it, cost, cost1, status, bestk, stall
    return step


def _cgls_setup(Op, y: Vector, x: Vector, niter: int, damp: float,
                normal: bool, M, guards: bool):
    """The fused CGLS loop's first carry, its constants ``(floors,)``
    and the stall window (shared with :mod:`.segmented`), under a
    ``solver.setup`` span."""
    damp2 = damp ** 2
    with _trace.span("solver.setup", cat="solver", solver="cgls"):
        s = y - Op.matvec(x)
        rq = Op.rmatvec(s) - x * damp  # the reference's un-squared damp
        z = _precond_apply(M, rq, x.dtype)
        # the recurrence tracks the true gradient Opᴴs − damp²x (normal),
        # or carries q = Op c (classic)
        carry = rq + x * (damp - damp2) if normal else Op.matvec(z)
        kold = _rdot(rq, z)
        sn = s.norm()
        cost = _history(sn, niter)
        cost1 = _history(_damped_norm(sn, damp2, x), niter)
        guard, stall_n = _guard_start(kold, guards)
        state = (x, s, z, carry, kold,
                 torch.zeros((), dtype=torch.int64, device=kold.device),
                 _counter(kold.device), cost, cost1) + guard
        return state, (_mp_floor(kold),), stall_n


def _cgls_loop(Op, M, y, state, consts, niter: int, damp: float, tol: float,
               normal: bool, guards: bool, stall_n: int, fault=None):
    """The fused CGLS loop over ``state`` as an
    :class:`~..aot.graphs.Loop` (see :func:`_cg_loop`)."""
    from ..aot import graphs
    return graphs.Loop("cgls", dict(damp=damp, tol=tol, normal=normal,
                                    guards=guards, stall=stall_n,
                                    **_fault_key(guards, fault)),
                       Op, M, y, state, consts,
                       _cgls_step(Op, M, damp, tol, normal, guards, stall_n,
                                  niter, fault),
                       record=telemetry.Spec("cgls", _TELEMETRY, niter + 2))


def _run_cgls(Op, y: Vector, x: Vector, niter: int, damp: float, tol: float,
              normal: bool, M, guards: bool, fault=None):
    """The fused CGLS loop from ``x`` in either schedule: ``(x, iiter,
    cost[:iiter+1], cost1, kold, code)``; see :func:`_run_cg`."""
    from ..aot import graphs
    state, consts, stall_n = _cgls_setup(Op, y, x, niter, damp, normal, M,
                                         guards)
    loop = _cgls_loop(Op, M, y, state, consts, niter, damp, tol, normal,
                      guards, stall_n, fault)
    x, _, _, _, kold, iiter, _, cost, cost1, status, _, _ = \
        graphs.run_iterations(loop, lambda st: _live(st[4], tol, st[9]),
                              niter)
    with _trace.span("solver.readback", cat="solver", solver="cgls"):
        iiter = int(iiter)
        code = _resolve_status(status, kold, tol) if guards else None
        cost, cost1 = cost[:iiter + 1], cost1[:iiter + 1]
    return x, iiter, cost, cost1, kold, code


def _fault_key(guards: bool, fault) -> dict:
    """The fault spec's part of a guarded loop's key (JAX
    ``basic.py:856-864``): a poisoned graph is never replayed for a
    clean solve. Unguarded loops never inject and keep their keys."""
    if not guards:
        return {}
    from ..resilience.faults import fault_signature
    return {"fault": fault_signature(fault)}


def _guard_fault(guards, injects: bool = True) -> tuple:
    """``guards`` (or the knob) resolved for a fused solve, and the
    armed fault a guarded solve of a loop that ``injects`` consumes
    (once, JAX ``basic.py:855``)."""
    from ..resilience import faults
    from ..resilience.status import guards_enabled
    on = guards_enabled(guards)
    return on, (faults.consume() if on and injects else None)


def _solve_cg(Op, y, x0, niter, tol, M, guards):
    """The fused CG with its span, metrics and, with guards, its
    published verdict: ``(x, iiter, cost, code)``."""
    from ..resilience import status as _rstatus
    from . import ca
    mode = ca.resolve_mode(Op, "cg")
    use_guards, fault = _guard_fault(guards)
    x = _zero_like_model(Op, y) if x0 is None else x0
    with _trace.span("solver.cg", cat="solver", op=type(Op).__name__,
                     shape=Op.shape, dtype=x.dtype, niter=niter, tol=tol,
                     fused=True, guards=use_guards,
                     telemetry=telemetry.telemetry_enabled()), \
            _metrics.timer("solver.cg"):
        if mode != "off":
            x, iiter, cost, code = ca.run_cg(Op, y, x, niter, tol, M=M,
                                             mode=mode, guards=use_guards,
                                             fault=fault)
        else:
            x, iiter, cost, code = _run_cg(Op, y, x, niter, tol, M,
                                           use_guards, fault)
    if use_guards:
        _rstatus.record("cg", code, iiter)
    _metrics.inc("solver.cg.solves")
    _metrics.inc("solver.cg.iterations", iiter)
    return x, iiter, cost, code


def _solve_cgls(Op, y, x0, niter, damp, tol, normal, M, guards):
    """The fused CGLS with its span, metrics and, with guards, its
    published verdict: ``(x, iiter, cost, cost1, kold, code)``; under a
    CA engine ``cost1`` holds only ``r2norm``."""
    from ..resilience import status as _rstatus
    from . import ca
    mode = ca.resolve_mode(Op, "cgls")
    use_guards, fault = _guard_fault(guards)
    x = _zero_like_model(Op, y) if x0 is None else x0
    with _trace.span("solver.cgls", cat="solver", op=type(Op).__name__,
                     shape=Op.shape, dtype=x.dtype, niter=niter, damp=damp,
                     tol=tol, fused=True, normal=normal,
                     guards=use_guards,
                     telemetry=telemetry.telemetry_enabled()), \
            _metrics.timer("solver.cgls"):
        if mode != "off":
            x, iiter, cost, kold, code = ca.run_cgls(
                Op, y, x, niter, damp, tol, normal, M=M, guards=use_guards,
                fault=fault)
            out = (x, iiter, cost, cost[iiter:iiter + 1], kold, code)
        else:
            out = _run_cgls(Op, y, x, niter, damp, tol, normal, M,
                            use_guards, fault)
    if use_guards:
        _rstatus.record("cgls", out[5], out[1])
    _metrics.inc("solver.cgls.solves")
    _metrics.inc("solver.cgls.iterations", out[1])
    return out


def _grad_route(name: str, Op, y, x0, host_only: bool = False,
                reroutes: bool = True) -> bool:
    """Whether this call goes through :mod:`..autodiff.implicit`: an input
    requires grad under grad mode (``implicit.should_intercept``; JAX
    ``basic.py:911-919``). The host-only options and the entries that do
    not reroute (``reroutes`` false) raise on such a call instead: a solve
    never returns an ``x`` cut from the gradient. Any other call returns
    False and runs as it always has."""
    from ..autodiff import implicit
    if not implicit.should_intercept(Op, y, x0):
        return False
    if not reroutes:
        raise RuntimeError(
            f"{name} has no gradient (guards are excluded from the implicit "
            "rule): an input requires grad under grad mode. Use "
            "autodiff.cg_solve/cgls_solve, or detach the inputs")
    if host_only:
        raise ValueError(
            f"{name} with an input that requires grad differentiates the "
            "fused path only: callback/show/fused=False run the class "
            "loop, which has no implicit gradient")
    return True


def cg(Op, y: Vector, x0: Optional[Vector] = None,
       niter: int = 10, tol: float = 1e-4, show: bool = False,
       itershow=(10, 10, 10), callback: Optional[Callable] = None,
       fused: Optional[bool] = None, guards: Optional[bool] = None, M=None):
    """Conjugate gradient for a square operator
    (ref ``optimization/basic.py:13-70``), in the JAX package's argument
    order. Without ``callback`` or ``show`` it runs the fused loop;
    with them (or ``fused=False``) the :class:`CG` class, printing on
    rank 0. ``M`` (fused loop only) is an SPD approximation of
    ``Op⁻¹``: the loop is then PCG. ``guards`` (``None`` defers to
    ``PYLOPS_MPI_TPU_TORCH_GUARDS``) adds the guard carry to the fused
    loop, which may then leave early; the verdict is published in
    ``resilience.status.last_status("cg")``.

    Returns ``(x, iiter, cost)``: the solution, the iterations run and
    the residual-norm history ``cost[:iiter+1]`` (a device tensor; a
    numpy array from the class).

    An input that requires grad (``y``, ``x0`` or the operator's
    parameters, under grad mode) routes the solve through
    :func:`~..autodiff.implicit.cg_solve`'s rule (fused path only, guards
    excluded)."""
    if _grad_route("cg", Op, y, x0,
                   callback is not None or show or fused is False):
        from ..autodiff import implicit
        return implicit.entry_cg(Op, y, x0, niter, tol, M)
    if not _use_fused("cg", callback, show, fused, M):
        solver = CG(Op)
        if callback is not None:
            solver.callback = callback
        x0 = _zero_like_model(Op, y) if x0 is None else x0
        return solver.solve(y, x0, niter=niter, tol=tol, show=show,
                            itershow=itershow)
    return _solve_cg(Op, y, x0, niter, tol, M, guards)[:3]


def cg_guarded(Op, y: Vector, x0: Optional[Vector] = None, niter: int = 10,
               tol: float = 1e-4, M=None):
    """Guarded fused CG (JAX ``basic.py:949-966``): ``(x, iiter, cost,
    status_code)``, the code one of ``resilience.status.CONVERGED``,
    ``MAXITER``, ``BREAKDOWN``, ``STAGNATION``; on breakdown ``x`` is the
    last finite iterate."""
    _grad_route("cg_guarded", Op, y, x0, reroutes=False)
    return _solve_cg(Op, y, x0, niter, tol, M, True)


def cgls(Op, y: Vector, x0: Optional[Vector] = None,
         niter: int = 10, damp: float = 0.0, tol: float = 1e-4,
         show: bool = False, itershow=(10, 10, 10),
         callback: Optional[Callable] = None, fused: Optional[bool] = None,
         normal: Optional[bool] = None, guards: Optional[bool] = None,
         M=None):
    """Damped least-squares CGLS (ref ``optimization/basic.py:73-148``),
    in the JAX package's argument order. Without ``callback`` or
    ``show`` it runs the fused loop; with them (or ``fused=False``) the
    :class:`CGLS` class, printing on rank 0. ``M`` (fused loop only)
    is an SPD approximation of ``(OpᴴOp + damp²I)⁻¹`` applied to the
    normal residual in both schedules (PCGLS). ``guards`` as in
    :func:`cg` (``last_status("cgls")``).

    ``normal=True`` runs the one-sweep schedule (fused loop only): each
    iteration takes ``(u, q) = Op.normal_matvec(c)`` (one read of the
    blocks for ``MPIBlockDiag``) and updates the gradient by the
    recurrence ``r ← r − a (u + damp² c)``. ``normal=False`` is the
    classic schedule with one ``rmatvec`` and one ``matvec`` per
    iteration.

    Returns ``(x, istop, iiter, r1norm, r2norm, cost)`` as the JAX
    package does: ``istop`` 1 when ``kold < tol`` else 2, ``r1norm`` the
    final ``kold``, ``r2norm`` the final damped residual norm and
    ``cost`` the residual-norm history ``cost[:iiter+1]`` (device
    tensors; ``cost`` a numpy array from the class).

    An input that requires grad routes the solve through
    :func:`~..autodiff.implicit.cgls_solve`'s rule, in the classic
    schedule whatever ``normal`` says (see :func:`cg`)."""
    if _grad_route("cgls", Op, y, x0,
                   callback is not None or show or fused is False):
        from ..autodiff import implicit
        return implicit.entry_cgls(Op, y, x0, niter, damp, tol, M)
    if not _use_fused("cgls", callback, show, fused, M, bool(normal)):
        solver = CGLS(Op)
        if callback is not None:
            solver.callback = callback
        x0 = _zero_like_model(Op, y) if x0 is None else x0
        return solver.solve(y, x0, niter=niter, damp=damp, tol=tol,
                            show=show, itershow=itershow)
    x, iiter, cost, cost1, kold, _ = _solve_cgls(
        Op, y, x0, niter, damp, tol, bool(normal), M, guards)
    istop = 1 if float(kold) < tol else 2
    return x, istop, iiter, kold, cost1[-1], cost


def cgls_guarded(Op, y: Vector, x0: Optional[Vector] = None,
                 niter: int = 10, damp: float = 0.0, tol: float = 1e-4,
                 normal: bool = False, M=None):
    """Guarded fused CGLS (JAX ``basic.py:1088-1106``): ``(x, iiter,
    cost, cost1, kold, status_code)``; see :func:`cg_guarded`."""
    _grad_route("cgls_guarded", Op, y, x0, reroutes=False)
    return _solve_cgls(Op, y, x0, niter, damp, tol, bool(normal), M, True)
