"""Block CG / CGLS: K right-hand sides through one loop.

PyTorch counterpart of ``pylops_mpi_tpu/solvers/block.py:60-532``. The
data and model vectors are 2-D ``(n, K)`` :class:`DistributedArray` s,
rows sharded and columns local; every operator apply moves all K
columns (``accepts_block`` operators widen their contraction, the rest
apply column by column), and each recurrence scalar becomes a ``(K,)``
vector from :meth:`DistributedArray.col_dot`, one ``all_reduce`` each.
Columns converge on their own: a column whose ``kold`` falls below
``max(floor, tol)`` freezes (zero step, zero momentum) while the others
go on. ``M=`` preconditions all K columns in one apply. With ``guards``
on (JAX ``block.py:103-340``) each column carries its own status word:
a column whose step, momentum or norm is not finite keeps its last
finite values and reads ``breakdown`` while the others run on, and the
loop runs while some column above ``tol`` has no verdict.

A block of one column routes to the single-RHS ``cg``/``cgls``, whose
results it returns bit for bit with a trailing unit axis. Under
``PYLOPS_MPI_TPU_TORCH_CA`` other than ``off`` a block of several
columns runs the pipelined engine of :mod:`.ca`.

``block_cg_segmented`` is :mod:`.segmented`'s, exported here too.
:func:`batched_solve` solves a family of same-shape operators (members
differing in their parameter tensors) in one loop over ``(n, B)``
carries, one lane a member, with the members' parameters stacked along a
leading axis (JAX ``block.py:693-849``, where the family is ``vmap``-ed).
"""

from __future__ import annotations

from collections import OrderedDict, namedtuple
from typing import Optional, Sequence

import torch

from ..diagnostics import metrics as _metrics
from ..diagnostics import telemetry
from ..diagnostics import trace as _trace
from ..distributedarray import DistributedArray, Partition
from ..linearoperator import MPILinearOperator, with_params
from .basic import (_counter, _grad_route, _guard_fault, _history, _live,
                    _mp_floor, _nonfinite, _or_idle, _precond_apply, _record,
                    _reject, _resolve_status, _slot, _solve_cg, _solve_cgls,
                    _status0, _step_scalar)
from . import ca
from .ca import _bdot, _tol_floor

__all__ = ["block_cg", "block_cgls", "block_cg_segmented",
           "batched_solve", "BatchedResult", "batched_cache_info"]


def _check_block(Op, y) -> None:
    if not (isinstance(y, DistributedArray) and y.ndim == 2):
        raise ValueError(
            "block solvers need a 2-D (rows, columns) DistributedArray "
            f"data vector; got {type(y).__name__} with shape "
            f"{getattr(y, 'global_shape', None)}")
    if y.global_shape[0] != Op.shape[0]:
        raise ValueError(
            f"data rows {y.global_shape[0]} do not match operator rows "
            f"{Op.shape[0]}")


def _squeeze_col(v: DistributedArray) -> DistributedArray:
    """``(n, 1)`` block vector → the 1-D vector of the single-RHS
    solvers."""
    return DistributedArray._wrap(
        v.array[..., 0], v, global_shape=(v.global_shape[0],),
        local_shapes=tuple((s[0],) for s in v.local_shapes))


def _expand_col(v: DistributedArray) -> DistributedArray:
    """1-D vector → ``(n, 1)`` block vector."""
    return DistributedArray._wrap(
        v.array[..., None], v, global_shape=v.global_shape + (1,),
        local_shapes=tuple(tuple(s) + (1,) for s in v.local_shapes))


def _zero_block_model(Op, y: DistributedArray) -> DistributedArray:
    """Zero ``(Op.shape[1], K)`` model in the operator's model split
    where it fixes one, at the operator's dtype (complex for complex
    data), on the operator's device or the data's."""
    K = int(y.global_shape[1])
    dtype = y.dtype if Op.dtype is None else torch.promote_types(Op.dtype,
                                                                 y.dtype)
    device = getattr(Op, "device", None) or y.device
    local_shapes = None
    if y.partition == Partition.SCATTER and Op.local_shapes_m is not None:
        local_shapes = tuple((s[0], K) for s in Op.local_shapes_m)
    return DistributedArray(global_shape=(Op.shape[1], K),
                            partition=y.partition, axis=0,
                            local_shapes=local_shapes, dtype=dtype,
                            device=device)


def _bguard_update(status, bestk, stall, bad, k, done, stall_n: int, live):
    """One step of the per-column guard carry (JAX ``_bguard_update``),
    taken only while the loop is ``live``: each column's verdict is its
    own and sticky (the first wins), and a frozen or poisoned column
    does not run its stall counter."""
    from ..resilience.status import BREAKDOWN, RUNNING, STAGNATION
    improved = (k < bestk) & ~bad
    nstall = torch.where(bad | done, stall,
                         torch.where(improved, torch.zeros_like(stall),
                                     stall + 1))
    nbest = torch.where(improved, k, bestk)
    verdict = torch.where(bad, torch.full_like(status, BREAKDOWN),
                          torch.where(nstall >= stall_n,
                                      torch.full_like(status, STAGNATION),
                                      torch.full_like(status, RUNNING)))
    nstatus = torch.where(status == RUNNING, verdict, status)
    return (torch.where(live, nstatus, status),
            torch.where(live, nbest, bestk),
            torch.where(live, nstall, stall))


def _guard_carry(kold, guards: bool):
    """The per-column guard carry's start ``(status, bestk, stall)`` and
    the stall window, or Nones and 0 with guards off."""
    if not guards:
        return (None, None, None), 0
    from ..resilience.status import stall_window
    K = kold.shape[0]
    return ((_status0(kold.device, K), kold.clone(),
             torch.zeros(K, dtype=torch.int32, device=kold.device)),
            stall_window())


def _lane_count(lanes, kold, tol: float, active):
    """A family's per-lane iteration counts, one more for each column
    above ``tol`` while the loop is live (JAX's vmapped loop counts each
    lane until its own test fails)."""
    return lanes + ((kold > tol) & active).to(lanes.dtype)


def _spec(solver: str, kold: torch.Tensor, niter: int):
    """The block loops' telemetry (JAX ``block.py:190``, ``:286``): the
    per-column ``resid``, ``k`` and ``alpha``."""
    K = int(kold.shape[0])
    return telemetry.Spec(solver, ("resid", "k", "alpha"), niter + 2,
                          (K, K, K))


def _block_cg_step(Op, M, tol: float, guards: bool, stall_n: int,
                   niter: int):
    """One block CG iteration over the carry ``(x, r, c, kold, iiter, it,
    cost, status, bestk, stall[, lanes])`` and the constant ``(stop,)``;
    a family's carry (:func:`batched_solve`) ends in its per-lane
    counts."""
    from ..resilience.status import RUNNING

    def step(state, consts):
        x, r, c, kold, iiter, it, cost, status, bestk, stall = state[:10]
        (stop,) = consts
        xdt = x.dtype
        active = _live(kold, tol, status)
        done = _or_idle(kold <= stop, active)
        if guards:
            done = done | (status != RUNNING)
        Opc = Op.matvec(c)
        a = torch.where(done, torch.zeros_like(kold), kold / _bdot(c, Opc))
        xn = x + c * _step_scalar(a, xdt)
        rn = r - Opc * _step_scalar(a, xdt)
        zn = _precond_apply(M, rn, xdt)
        k = torch.where(done, kold, _bdot(rn, zn))
        b = torch.where(done, torch.zeros_like(k), k / kold)
        cn = zn + c * _step_scalar(b, xdt)
        if guards:
            # only the poisoned columns' updates are rejected
            bad = _nonfinite(a, k, b)
            hold = _or_idle(bad, active)
            x, r, c = (_reject(hold, x, xn), _reject(hold, r, rn),
                       _reject(hold, c, cn))
            k = torch.where(bad, kold, k)
            status, bestk, stall = _bguard_update(status, bestk, stall, bad,
                                                  k, done, stall_n, active)
        else:
            x, r, c = _reject(active, xn, x), rn, cn  # x held once idle
        lanes = tuple(_lane_count(n, kold, tol, active) for n in state[10:])
        iiter = iiter + active.to(iiter.dtype)
        it = it + 1
        slot = _slot(it, active, niter + 1)
        _record(cost, slot, torch.sqrt(k))
        telemetry.iteration(slot, torch.sqrt(k), k, a)
        return (x, r, c, k, iiter, it, cost, status, bestk, stall) + lanes
    return step


def _block_cg_setup(Op, y, x, niter: int, M, guards: bool):
    """The block CG loop's first carry, its machine floors and the stall
    window (shared with :func:`block_cg_segmented`)."""
    r = y - Op.matvec(x)
    z = _precond_apply(M, r, x.dtype)
    kold = _bdot(r, z)
    guard, stall_n = _guard_carry(kold, guards)
    state = (x, r, z, kold,
             torch.zeros((), dtype=torch.int64, device=kold.device),
             _counter(kold.device), _history(torch.sqrt(kold), niter)) + guard
    return state, _mp_floor(kold), stall_n


def _block_cg_graph(Op, M, y, state, floors, niter: int, tol: float,
                    guards: bool, stall_n: int):
    """The block CG loop over ``state`` as an
    :class:`~..aot.graphs.Loop`."""
    from ..aot import graphs
    return graphs.Loop("block_cg", dict(tol=tol, guards=guards,
                                        stall=stall_n),
                       Op, M, y, state, (_tol_floor(floors, tol),),
                       _block_cg_step(Op, M, tol, guards, stall_n, niter),
                       record=_spec("block_cg", state[3], niter))


def _block_cg_loop(Op, y, x, niter: int, tol: float, M, guards: bool):
    """The block CG loop from ``x``: ``(x, iiter, cost[:iiter+1],
    codes)``, ``codes`` the columns' status words with guards on."""
    from ..aot import graphs
    state, floors, stall_n = _block_cg_setup(Op, y, x, niter, M, guards)
    loop = _block_cg_graph(Op, M, y, state, floors, niter, tol, guards,
                           stall_n)
    x, _, _, kold, iiter, _, cost, status, _, _ = graphs.run_iterations(
        loop, lambda st: _live(st[3], tol, st[7]), niter)
    iiter = int(iiter)
    codes = _resolve_status(status, kold, tol) if guards else None
    return x, iiter, cost[:iiter + 1], codes


def _block_cgls_step(Op, M, damp: float, tol: float, guards: bool,
                     stall_n: int, niter: int):
    """One block CGLS iteration (classic two-sweep schedule) over the
    carry ``(x, s, c, q, kold, iiter, it, cost, cost1, status, bestk,
    stall[, lanes])`` and the constant ``(stop,)``; ``lanes`` as in
    :func:`_block_cg_step`."""
    from ..resilience.status import RUNNING
    damp2 = damp ** 2

    def step(state, consts):
        x, s, c, q, kold, iiter, it, cost, cost1, status, bestk, stall = \
            state[:12]
        (stop,) = consts
        xdt = x.dtype
        active = _live(kold, tol, status)
        done = _or_idle(kold <= stop, active)
        if guards:
            done = done | (status != RUNNING)
        qq = _bdot(q, q)
        a = torch.abs(kold / (qq + damp2 * _bdot(c, c) if damp2 else qq))
        a = torch.where(done, torch.zeros_like(a), a)
        xn = x + c * _step_scalar(a, xdt)
        sn_ = s - q * _step_scalar(a, xdt)
        r = Op.rmatvec(sn_) - xn * damp2
        z = _precond_apply(M, r, xdt)
        k = torch.where(done, kold, _bdot(r, z))
        b = torch.where(done, torch.zeros_like(k), k / kold)
        cn = z + c * _step_scalar(b, xdt)
        qn = Op.matvec(cn)
        if guards:
            bad = _nonfinite(a, k, b)
            hold = _or_idle(bad, active)
            x, s, c, q = (_reject(hold, x, xn), _reject(hold, s, sn_),
                          _reject(hold, c, cn), _reject(hold, q, qn))
            k = torch.where(bad, kold, k)
            status, bestk, stall = _bguard_update(status, bestk, stall, bad,
                                                  k, done, stall_n, active)
        else:
            x, s, c, q = _reject(active, xn, x), sn_, cn, qn  # held idle
        lanes = tuple(_lane_count(n, kold, tol, active) for n in state[12:])
        iiter = iiter + active.to(iiter.dtype)
        it = it + 1
        sn = torch.sqrt(_bdot(s, s))
        slot = _slot(it, active, niter + 1)
        _record(cost, slot, sn)
        _record(cost1, slot, _damped(sn, damp2, x))
        telemetry.iteration(slot, sn, k, a)
        return (x, s, c, q, k, iiter, it, cost, cost1, status, bestk,
                stall) + lanes
    return step


def _block_cgls_setup(Op, y, x, niter: int, damp: float, M, guards: bool):
    """The block CGLS loop's first carry, its machine floors and the
    stall window."""
    s = y - Op.matvec(x)
    rq = Op.rmatvec(s) - x * damp  # the reference's un-squared setup damp
    z = _precond_apply(M, rq, x.dtype)
    q = Op.matvec(z)
    kold = _bdot(rq, z)
    sn = torch.sqrt(_bdot(s, s))
    guard, stall_n = _guard_carry(kold, guards)
    state = (x, s, z, q, kold,
             torch.zeros((), dtype=torch.int64, device=kold.device),
             _counter(kold.device), _history(sn, niter),
             _history(_damped(sn, damp ** 2, x), niter)) + guard
    return state, _mp_floor(kold), stall_n


def _block_cgls_graph(Op, M, y, state, floors, niter: int, damp: float,
                      tol: float, guards: bool, stall_n: int):
    """The block CGLS loop over ``state`` as an
    :class:`~..aot.graphs.Loop`."""
    from ..aot import graphs
    return graphs.Loop("block_cgls", dict(damp=damp, tol=tol, guards=guards,
                                          stall=stall_n),
                       Op, M, y, state, (_tol_floor(floors, tol),),
                       _block_cgls_step(Op, M, damp, tol, guards, stall_n,
                                        niter),
                       record=_spec("block_cgls", state[4], niter))


def _block_cgls_loop(Op, y, x, niter: int, damp: float, tol: float, M,
                     guards: bool):
    """The block CGLS loop (classic two-sweep schedule) from ``x``:
    ``(x, iiter, cost[:iiter+1], cost1, kold, codes)``."""
    from ..aot import graphs
    state, floors, stall_n = _block_cgls_setup(Op, y, x, niter, damp, M,
                                               guards)
    loop = _block_cgls_graph(Op, M, y, state, floors, niter, damp, tol,
                             guards, stall_n)
    x, _, _, _, kold, iiter, _, cost, cost1, status, _, _ = \
        graphs.run_iterations(loop, lambda st: _live(st[4], tol, st[9]),
                              niter)
    iiter = int(iiter)
    codes = _resolve_status(status, kold, tol) if guards else None
    return x, iiter, cost[:iiter + 1], cost1, kold, codes


def block_cg(Op, y: DistributedArray, x0: Optional[DistributedArray] = None,
             niter: int = 10, tol: float = 1e-4,
             guards: Optional[bool] = None, M=None):
    """Block CG (JAX ``block.py:343-452``): K columns of ``y`` (``(n, K)``)
    through one loop. Returns ``(x, iiter, cost)``, ``cost`` of shape
    ``(iiter+1, K)`` (a device tensor). With ``guards`` on (or the knob)
    each column carries its own status word: a poisoned column breaks
    down alone while the others run on, and the verdicts land in
    ``resilience.status.last_status("block_cg")["columns"]``.

    An input that requires grad routes the solve through
    :func:`~..autodiff.implicit.block_cg_solve`'s rule (JAX
    ``block.py:364-367``)."""
    from ..resilience import status as _rstatus
    _check_block(Op, y)
    if _grad_route("block_cg", Op, y, x0):
        from ..autodiff import implicit
        return implicit.entry_block_cg(Op, y, x0, niter, tol, M)
    K = int(y.global_shape[1])
    if K == 1:
        x1, iiter, cost, code = _solve_cg(
            Op, _squeeze_col(y), None if x0 is None else _squeeze_col(x0),
            niter, tol, M, guards)
        if code is not None:
            _rstatus.record_columns("block_cg", [code], iiter)
        return _expand_col(x1), iiter, cost[:, None]
    x = _zero_block_model(Op, y) if x0 is None else x0
    mode = ca.resolve_mode(Op, "block_cg")
    # the classic block loops have no fault sites (as in the JAX package)
    use_guards, fault = _guard_fault(guards, injects=mode != "off")
    with _trace.span("solver.block_cg", cat="solver", op=type(Op).__name__,
                     shape=Op.shape, batch=K, dtype=x.dtype, niter=niter,
                     tol=tol, guards=use_guards, telemetry=telemetry.telemetry_enabled()):
        if mode != "off":
            x, iiter, cost, codes = ca.run_block_cg(
                Op, y, x, niter, tol, M=M, guards=use_guards, fault=fault)
        else:
            x, iiter, cost, codes = _block_cg_loop(Op, y, x, niter, tol, M,
                                                   use_guards)
    if use_guards:
        _rstatus.record_columns("block_cg", codes, iiter)
    _metrics.inc("solver.block_cg.solves")
    _metrics.inc("solver.block_cg.iterations", iiter)
    return x, iiter, cost


def block_cgls(Op, y: DistributedArray,
               x0: Optional[DistributedArray] = None, niter: int = 10,
               damp: float = 0.0, tol: float = 1e-4,
               guards: Optional[bool] = None, M=None):
    """Block CGLS, the classic two-sweep schedule (JAX
    ``block.py:454-532``). Returns ``(x, istop, iiter, kold, r2norm,
    cost)`` as ``cgls`` does, with ``(K,)`` ``istop``/``kold``/``r2norm``
    and a ``(iiter+1, K)`` ``cost`` (device tensors). ``M`` approximates
    ``(OpᴴOp + damp²I)⁻¹``. ``guards`` as in :func:`block_cg`
    (``last_status("block_cgls")``). Inputs that require grad as in
    :func:`block_cg` (JAX ``block.py:468-471``)."""
    from ..resilience import status as _rstatus
    _check_block(Op, y)
    if _grad_route("block_cgls", Op, y, x0):
        from ..autodiff import implicit
        return implicit.entry_block_cgls(Op, y, x0, niter, damp, tol, M)
    K = int(y.global_shape[1])
    if K == 1:
        x1, iiter, cost, cost1, kold, code = _solve_cgls(
            Op, _squeeze_col(y), None if x0 is None else _squeeze_col(x0),
            niter, damp, tol, False, M, guards)
        if code is not None:
            _rstatus.record_columns("block_cgls", [code], iiter)
        kold = kold.reshape(1)
        return (_expand_col(x1), torch.where(kold < tol, 1, 2), iiter, kold,
                cost1[-1].reshape(1), cost[:, None])
    x = _zero_block_model(Op, y) if x0 is None else x0
    mode = ca.resolve_mode(Op, "block_cgls")
    # the classic block loops have no fault sites (as in the JAX package)
    use_guards, fault = _guard_fault(guards, injects=mode != "off")
    with _trace.span("solver.block_cgls", cat="solver",
                     op=type(Op).__name__, shape=Op.shape, batch=K,
                     dtype=x.dtype, niter=niter, damp=damp, tol=tol,
                     guards=use_guards, telemetry=telemetry.telemetry_enabled()):
        if mode != "off":
            *out, codes = ca.run_block_cgls(Op, y, x, niter, damp, tol, M=M,
                                            guards=use_guards, fault=fault)
            out, iiter = tuple(out), out[2]
        else:
            x, iiter, cost, cost1, kold, codes = _block_cgls_loop(
                Op, y, x, niter, damp, tol, M, use_guards)
            out = (x, torch.where(kold < tol, 1, 2), iiter, kold,
                   cost1[iiter], cost)
    if use_guards:
        _rstatus.record_columns("block_cgls", codes, iiter)
    _metrics.inc("solver.block_cgls.solves")
    _metrics.inc("solver.block_cgls.iterations", iiter)
    return out


def _damped(sn: torch.Tensor, damp2: float, x) -> torch.Tensor:
    """Per-column ``sqrt(sn² + damp²·x·x)``; undamped, the ``x·x``
    reduction is skipped (adding ``0·x·x`` changes no finite bit)."""
    if not damp2:
        return torch.sqrt(sn ** 2)
    return torch.sqrt(sn ** 2 + damp2 * _bdot(x, x))


# ---------------------------------------------------- segmented block CG
def block_cg_segmented(*args, **kwargs):
    """Segmented block CG with checkpoints (JAX ``block.py:583-``); see
    :func:`.segmented.block_cg_segmented`."""
    from .segmented import block_cg_segmented as run
    return run(*args, **kwargs)


# ------------------------------------------- a family of same-shape solves
BatchedResult = namedtuple("BatchedResult",
                           ["xs", "iiter", "cost", "cost1", "kold"])
BatchedResult.__doc__ = (
    "The result of :func:`batched_solve`: ``xs`` the members' model "
    "vectors; ``iiter`` (B,) and ``cost`` (B, niter+1), and for CGLS "
    "``cost1`` (B, niter+1) and ``kold`` (B,), numpy arrays with a "
    "leading member axis. ``cost`` rows past a member's own ``iiter`` are "
    "zeros: the loop runs until every member's lane has stopped.")

# (solver, niter, B, class name, parameter specs, data and model specs)
# -> _FamilyOp, least recently used first; at most _BATCHED_MAX families
_BATCHED_CACHE: "OrderedDict" = OrderedDict()
_BATCHED_MAX = 8


def batched_cache_info() -> dict:
    """The family cache's ``{"size", "max", "families"}``, ``families``
    the cached ``(solver, niter, B, class name)`` heads, newest last
    (JAX ``block.py:715-726``). Hits and misses go on the metrics counters
    ``solver.batched.cache.hit``/``.miss``."""
    return {"size": len(_BATCHED_CACHE), "max": _BATCHED_MAX,
            "families": [k[:4] for k in _BATCHED_CACHE]}


class _Members:
    """The family's member operators, each over its slices of the stacked
    parameters (kept out of the operator signature's walk: the bank keys
    the family on the stacked tensors)."""

    def __init__(self, ops, template):
        self.ops = ops
        self.template = template


class _FamilyOp(MPILinearOperator):
    """The ``B`` members of a family as one operator on ``(n, B)`` block
    vectors, column ``b`` through member ``b``. The members' parameters
    are stacked along a leading member axis (``stacked``); a call that
    hits the cache copies its members' parameters into them in place, so
    the family keeps its ``id`` and its tensors' addresses, and its
    captured loops replay. ``MPIBlockDiag`` members fold the member axis
    into the block axis: ``(B, nblk, m, n)`` becomes one
    ``(B·nblk, m, n)`` batched product. Other classes apply each member
    to its column in turn."""

    accepts_block = True

    def __init__(self, op0, stacked, members):
        from ..ops.blockdiag import MPIBlockDiag
        self.dims, self.dimsd = op0.dims, op0.dimsd
        self.local_shapes_m, self.local_shapes_n = (op0.local_shapes_m,
                                                    op0.local_shapes_n)
        super().__init__(shape=op0.shape, dtype=op0.dtype)
        self.stacked = stacked
        self.nmembers = len(members)
        self._fold = (type(op0) is MPIBlockDiag and op0._batched is not None
                      and op0._batched_k == 1 and len(stacked) == 1)
        self._members = _Members(members, op0)

    @property
    def device(self):
        return self.stacked[0].device

    def refresh(self, op0, params) -> None:
        """A later call of the family: copy its members' parameters into
        the stacked tensors (in place: the addresses a captured loop holds
        stay) and take its first member as the template of the rest."""
        with torch.no_grad():
            for S, ps in zip(self.stacked, zip(*params)):
                for b, t in enumerate(ps):
                    S[b].copy_(t)
        self._members = _Members(
            [with_params(op0, [S[b] for S in self.stacked])
             for b in range(self.nmembers)], op0)

    def _apply(self, x: DistributedArray, forward: bool):
        if self._fold:
            return self._apply_fold(x, forward)
        cols = []
        for b, op in enumerate(self._members.ops):
            col = DistributedArray._wrap(
                x.array[:, b].contiguous(), x,
                global_shape=(x.global_shape[0],),
                local_shapes=tuple((s[0],) for s in x.local_shapes))
            cols.append(op.matvec(col) if forward else op.rmatvec(col))
        like = cols[0]
        B = self.nmembers
        return DistributedArray._wrap(
            torch.stack([c.array for c in cols], dim=1), like,
            global_shape=like.global_shape + (B,),
            local_shapes=tuple(tuple(s) + (B,) for s in like.local_shapes))

    def _apply_fold(self, x: DistributedArray, forward: bool):
        from ..ops._precision import matmul_narrow
        tmpl = self._members.template
        S = self.stacked[0]
        B, nblk, m, n = S.shape
        nin = n if forward else m
        xl = tmpl._local_input(x, forward)               # (rows, B)
        X = xl.transpose(0, 1).reshape(B * nblk, nin, 1)
        A = S.reshape(B * nblk, m, n)
        Y = matmul_narrow(A if forward else A.mH, X, tmpl.compute_dtype,
                          tmpl.dtype)
        arr = Y.reshape(B, -1).transpose(0, 1).contiguous()
        return tmpl._output(arr, x, forward)

    def _matvec(self, x):
        return self._apply(x, True)

    def _rmatvec(self, x):
        return self._apply(x, False)


def _run_family(fam, solver: str, Y, X0, niter: int, damp: float,
                tol: float):
    """The family's loop: the block CG or CGLS loop over the ``(n, B)``
    lanes (no preconditioner, guards off) with the per-lane counts as
    one more carry, through the graph bank. Returns ``(x, iiter, cost,
    cost1, kold)``, per-lane tensors, the cost rows past each lane's own
    ``iiter`` zeroed."""
    from ..aot import graphs
    lanes = torch.zeros(fam.nmembers, dtype=torch.int64, device=X0.device)
    if solver == "cg":
        state, floors, _ = _block_cg_setup(fam, Y, X0, niter, None, False)
        loop = _block_cg_graph(fam, None, Y, state + (lanes,), floors,
                               niter, tol, False, 0)
        kidx, hist = 3, (6,)
    else:
        state, floors, _ = _block_cgls_setup(fam, Y, X0, niter, damp, None,
                                             False)
        loop = _block_cgls_graph(fam, None, Y, state + (lanes,), floors,
                                 niter, damp, tol, False, 0)
        kidx, hist = 4, (7, 8)
    out = graphs.run_iterations(loop, lambda st: _live(st[kidx], tol),
                                niter)
    iiter = out[-1]
    # rows 1..iiter[b] are lane b's iterations; _history's spare row goes
    rows = torch.arange(niter + 1, device=iiter.device)[:, None]
    costs = [torch.where(rows <= iiter, out[i][:-1],
                         torch.zeros_like(out[i][:-1])) for i in hist]
    return (out[0], iiter, costs[0], costs[1] if solver == "cgls" else None,
            out[kidx])


def _lanes(vs, like: DistributedArray) -> DistributedArray:
    """Single-RHS vectors as the columns of one block vector."""
    B = len(vs)
    return DistributedArray._wrap(
        torch.stack([v.array for v in vs], dim=1), like,
        global_shape=like.global_shape + (B,),
        local_shapes=tuple(tuple(s) + (B,) for s in like.local_shapes))


def batched_solve(factory, params: Sequence, ys: Sequence, *,
                  solver: str = "cgls", x0s: Optional[Sequence] = None,
                  niter: int = 10, damp: float = 0.0,
                  tol: float = 1e-4) -> BatchedResult:
    """Solve a family of same-shape problems in one loop (JAX
    ``block.py:732-849``).

    ``factory(p)`` builds the operator of parameter set ``p``; the
    members must be of one registered class
    (:func:`~..linearoperator.register_operator_params`), of one shape,
    with parameters of the same shapes and dtypes, differing only in
    their values. Their parameters are stacked along a leading member
    axis and one CG or CGLS loop (``solver``) runs over ``(n, B)``
    carries: each member's lane stops on its own convergence test, as
    the JAX package's vmapped loop does; the loop is the block solvers'
    own. The family's operator and its stacked tensors are cached (an
    LRU of ``_BATCHED_MAX`` families): a later
    call of the same family copies its parameters in and, with the graph
    bank armed, replays the captured loop. ``ys`` (and ``x0s``) are 1-D
    distributed vectors, one a member. Guards are not run (use the block
    solvers for per-column status words); the solve is not
    differentiable (use :mod:`~..autodiff.implicit`)."""
    from ..linearoperator import operator_params, params_registered
    from .basic import _zero_like_model
    if solver not in ("cg", "cgls"):
        raise ValueError(f"solver={solver!r}: expected 'cg' or 'cgls'")
    params = list(params)
    ys = list(ys)
    if not params or len(params) != len(ys):
        raise ValueError(
            f"need one y per parameter set, got {len(params)} params and "
            f"{len(ys)} ys")
    ops = [factory(p) for p in params]
    op0 = ops[0]
    if not params_registered(op0):
        raise TypeError(
            f"batched_solve needs a registered operator class "
            f"(linearoperator.register_operator_params); "
            f"{type(op0).__name__} is not registered")
    for op in ops[1:]:
        if type(op) is not type(op0) or op.shape != op0.shape:
            raise ValueError(
                "batched_solve needs a same-shape operator family; got "
                f"{type(op0).__name__}{op0.shape} and "
                f"{type(op).__name__}{op.shape}")
    fam_params = [operator_params(op) for op in ops]
    if not fam_params[0]:
        raise ValueError(
            f"{type(op0).__name__} holds no parameter tensors, so nothing "
            "varies across the family; solve the members one by one")
    spec0 = [(tuple(t.shape), t.dtype, t.device) for t in fam_params[0]]
    for i, ps in enumerate(fam_params[1:], start=1):
        if [(tuple(t.shape), t.dtype, t.device) for t in ps] != spec0:
            raise ValueError(
                f"operator {i} holds parameters of other shapes or dtypes "
                "than operator 0; batched_solve needs a same-shape family")
    B = len(ops)
    x0s = ([_zero_like_model(op, yv) for op, yv in zip(ops, ys)]
           if x0s is None else list(x0s))
    Y = _lanes(ys, ys[0])
    X0 = _lanes(x0s, x0s[0])
    key = (solver, int(niter), B, type(op0).__name__, tuple(spec0),
           (Y.global_shape, str(Y.dtype)), (X0.global_shape, str(X0.dtype)))
    fam = _BATCHED_CACHE.get(key)
    _metrics.inc("solver.batched.cache.hit" if fam is not None
                 else "solver.batched.cache.miss")
    if fam is None:
        with torch.no_grad():
            stacked = [torch.stack(ts).contiguous()
                       for ts in zip(*fam_params)]
        members = [with_params(op0, [S[b] for S in stacked])
                   for b in range(B)]
        fam = _FamilyOp(op0, stacked, members)
        _BATCHED_CACHE[key] = fam
        while len(_BATCHED_CACHE) > _BATCHED_MAX:
            _BATCHED_CACHE.popitem(last=False)
        compiled = False
    else:
        _BATCHED_CACHE.move_to_end(key)
        fam.refresh(op0, fam_params)
        compiled = True
    with _trace.span(f"solver.batched_{solver}", cat="solver",
                     op=type(op0).__name__, shape=op0.shape, family=B,
                     niter=niter, tol=tol, compiled=compiled,
                     telemetry=telemetry.telemetry_enabled()), torch.no_grad():
        x, iiter, cost, cost1, kold = _run_family(fam, solver, Y, X0,
                                                  int(niter), float(damp),
                                                  float(tol))
    cols = tuple((s[0],) for s in x.local_shapes)
    xs = [DistributedArray._wrap(x.array[:, b].contiguous(), x0s[b],
                                 global_shape=(x.global_shape[0],),
                                 local_shapes=cols)
          for b in range(B)]
    return BatchedResult(
        xs=xs, iiter=iiter.cpu().numpy(),
        cost=cost.transpose(0, 1).cpu().numpy(),
        cost1=None if cost1 is None else cost1.transpose(0, 1).cpu().numpy(),
        kold=None if solver == "cg" else kold.cpu().numpy())
