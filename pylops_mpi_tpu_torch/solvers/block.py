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
``batched_solve``, ``BatchedResult`` and ``batched_cache_info`` are
exported with the JAX package's names and raise: they need a
stacked-operator design of their own (ROADMAP.md §A.6).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..diagnostics import metrics as _metrics
from ..diagnostics import trace as _trace
from ..distributedarray import DistributedArray, Partition
from .basic import (_counter, _guard_fault, _history, _live, _mp_floor,
                    _nonfinite, _or_idle, _precond_apply, _record, _reject,
                    _resolve_status, _slot, _solve_cg, _solve_cgls,
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


def _block_cg_step(Op, M, tol: float, guards: bool, stall_n: int,
                   niter: int):
    """One block CG iteration over the carry ``(x, r, c, kold, iiter, it,
    cost, status, bestk, stall)`` and the constant ``(stop,)``."""
    from ..resilience.status import RUNNING

    def step(state, consts):
        x, r, c, kold, iiter, it, cost, status, bestk, stall = state
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
        iiter = iiter + active.to(iiter.dtype)
        it = it + 1
        _record(cost, _slot(it, active, niter + 1), torch.sqrt(k))
        return x, r, c, k, iiter, it, cost, status, bestk, stall
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
                       _block_cg_step(Op, M, tol, guards, stall_n, niter))


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
    stall)`` and the constant ``(stop,)``."""
    from ..resilience.status import RUNNING
    damp2 = damp ** 2

    def step(state, consts):
        x, s, c, q, kold, iiter, it, cost, cost1, status, bestk, stall = \
            state
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
        iiter = iiter + active.to(iiter.dtype)
        it = it + 1
        sn = torch.sqrt(_bdot(s, s))
        slot = _slot(it, active, niter + 1)
        _record(cost, slot, sn)
        _record(cost1, slot, _damped(sn, damp2, x))
        return x, s, c, q, k, iiter, it, cost, cost1, status, bestk, stall
    return step


def _block_cgls_loop(Op, y, x, niter: int, damp: float, tol: float, M,
                     guards: bool):
    """The block CGLS loop (classic two-sweep schedule) from ``x``:
    ``(x, iiter, cost[:iiter+1], cost1, kold, codes)``."""
    from ..aot import graphs
    damp2 = damp ** 2
    xdt = x.dtype
    s = y - Op.matvec(x)
    rq = Op.rmatvec(s) - x * damp  # the reference's un-squared setup damp
    z = _precond_apply(M, rq, xdt)
    q = Op.matvec(z)
    kold = _bdot(rq, z)
    sn = torch.sqrt(_bdot(s, s))
    guard, stall_n = _guard_carry(kold, guards)
    state = (x, s, z, q, kold,
             torch.zeros((), dtype=torch.int64, device=kold.device),
             _counter(kold.device), _history(sn, niter),
             _history(_damped(sn, damp2, x), niter)) + guard
    loop = graphs.Loop("block_cgls", dict(damp=damp, tol=tol, guards=guards,
                                          stall=stall_n),
                       Op, M, y, state, (_tol_floor(_mp_floor(kold), tol),),
                       _block_cgls_step(Op, M, damp, tol, guards, stall_n,
                                        niter))
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
    ``resilience.status.last_status("block_cg")["columns"]``."""
    from ..resilience import status as _rstatus
    _check_block(Op, y)
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
                     tol=tol, guards=use_guards, telemetry=False):
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
    (``last_status("block_cgls")``)."""
    from ..resilience import status as _rstatus
    _check_block(Op, y)
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
                     guards=use_guards, telemetry=False):
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


# ------------------------------------------------------ waiting items
def _waits(name: str):
    raise NotImplementedError(
        f"{name} is not ported: it waits for its own item of ROADMAP.md "
        "§A.6 (batched_solve and its stacked-operator design)")


def block_cg_segmented(*args, **kwargs):
    """Segmented block CG with checkpoints (JAX ``block.py:583-``); see
    :func:`.segmented.block_cg_segmented`."""
    from .segmented import block_cg_segmented as run
    return run(*args, **kwargs)


def batched_solve(*args, **kwargs):
    """One solve over a stacked family of operators (JAX
    ``block.py:732-849``): not ported, raises."""
    _waits("batched_solve")


class BatchedResult:
    """The result record of :func:`batched_solve`: not ported, raises."""

    def __init__(self, *args, **kwargs):
        _waits("BatchedResult")


def batched_cache_info(*args, **kwargs):
    """The batched engine's cache statistics: not ported, raises."""
    _waits("batched_cache_info")
