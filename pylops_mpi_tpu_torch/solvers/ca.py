"""Communication-avoiding CG/CGLS engines (``PYLOPS_MPI_TPU_TORCH_CA``).

PyTorch counterpart of ``pylops_mpi_tpu/solvers/ca.py:82-893``; its
segmented seams (``:895-1048``) are :func:`seg_fields` and
:func:`check_resume_ca` here, and the epochs run in
:mod:`.segmented` through this module's steps.
A classic fused iteration reduces 2 (CG) to 5 (damped CGLS) scalars,
each its own ``all_reduce`` whose result the next step waits for. The
engines here trade a little algebra for fewer collectives:

- **pipelined (P)CG / (P)CGLS** (``mode="pipelined"``): the
  Ghysels–Vanroose recurrences carry ``u = M r``, ``w = A u`` and the
  companions ``z, q, s, p`` of the search direction, so an iteration's
  two dots ``γ = (r, u)`` and ``δ = (w, u)`` are stacked into one small
  tensor and reduced by ONE ``all_reduce`` (:func:`_stacked`),
  issued before the operator apply it does not depend on. CGLS runs
  pipelined CG on the damped normal system ``(AᴴA + damp²I) x = Aᴴy``
  (with ``normal=True`` through ``Op.normal_matvec``, the one-sweep
  kernel on ``MPIBlockDiag``); its ``cost`` records the normal-residual
  norm ``sqrt(γ)``, not the data residual the classic engine logs. The
  stopping test lags the classic engine by one iteration (cost lane
  ``j`` holds the residual of iterate ``j - 1``).
- **s-step CA-CG** (``mode="sstep"``): each outer step grows the
  monomial chains ``{(MA)^j p}`` and ``{(MA)^j z}`` locally (``2s - 1``
  operator applies), then reduces ONE ``(2s+1, 2s)`` Gram tile; ``s``
  CG steps then run on replicated coordinate vectors with no further
  communication. A non-finite or non-positive pivot (the monomial
  basis conditions like κ^s) rejects the outer update and ends the
  loop with ``BREAKDOWN``; the solve then continues under the
  pipelined engine from the last completed outer iterate, which
  :func:`last_fallback` reports. That is the JAX package's algorithm,
  not a device fallback. s-step serves CG on plain, unmasked, evenly
  split, real vectors; CGLS, block solves and other spaces (masked,
  ragged, complex, stacked) take the pipelined engine.

With ``guards`` on (JAX ``ca.py:50-54``) every engine carries the
classic engines' guard words: a non-finite ``a``, ``b``, ``γ`` or ``δ``
rejects the update (per column for block vectors) and ends the loop with
``BREAKDOWN``, a stalled best ``γ`` with ``STAGNATION``; the pipelined
engines take the armed fault of :mod:`..resilience.faults` at their
operator apply and step scalar, and an armed fault sends an s-step
solve to the pipelined engine (the JAX package's rule).

``off`` never reaches this module. ``auto`` needs the cost model
(ROADMAP.md §A.7 item 4) and raises. The loops follow :mod:`.basic`: a Python
loop whose scalars stay on the device, an ``active`` mask that stops the
updates once the tolerance is met, and a host read every few
iterations to leave early (the s-step loop reads it once per outer
step). Every rank issues the same collectives in the same order: the
decisions read only reduced (replicated) scalars and layout metadata.

One difference from the JAX package: its stacked reduction falls back
to one collective per dot for ragged splits (padded physical layout);
the port's shards are exact-size tensors, so ragged splits stack too.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..distributedarray import DistributedArray
from ..ops._precision import accum_dtype, reduction_dtype
from ..parallel import collectives
from ..resilience import faults
from ..resilience.status import BREAKDOWN, RUNNING
from ..utils import deps
from .basic import (_counter, _fault_key, _guard_update, _history, _live,
                    _mp_floor, _nonfinite, _or_idle, _precond_apply, _rdot,
                    _record, _reject, _resolve_status, _slot, _status0,
                    _step_scalar)

__all__ = ["resolve_mode", "ca_key", "classic_reductions_per_iter",
           "ca_reductions_per_iter", "last_fallback", "clear_fallback",
           "run_cg", "run_cgls", "run_block_cg", "run_block_cgls",
           "seg_fields", "check_resume_ca", "CA_SCHEMA",
           "RUNNING", "BREAKDOWN"]

# A segmented checkpoint of a CA engine carries another field set than
# the classic engines' (schema 1): this schema and the engine's name are
# stamped into it, and a resume under another engine refuses.
CA_SCHEMA = 2


# all_reduce calls per iteration of the classic fused engines (the JAX
# table: undamped CG 2; damped CGLS 5)
_CLASSIC_REDUCTIONS = {"cg": 2, "cgls": 5, "block_cg": 2, "block_cgls": 5}


def classic_reductions_per_iter(solver: str) -> int:
    """All-reduces per iteration of the classic fused engine."""
    return _CLASSIC_REDUCTIONS.get(solver, 2)


def ca_reductions_per_iter(mode: str, s: int = 1) -> float:
    """All-reduces per iteration under a CA mode: pipelined 1, s-step
    ``1/s``."""
    if mode == "sstep":
        return 1.0 / max(1, int(s))
    if mode == "pipelined":
        return 1.0
    return float(_CLASSIC_REDUCTIONS["cg"])


def resolve_mode(Op=None, solver: str = "cg") -> str:
    """``PYLOPS_MPI_TPU_TORCH_CA`` as the engine of this solve: ``off``,
    ``pipelined`` or ``sstep``. ``auto`` raises: the JAX package picks
    by its cost model's latency term, which is ROADMAP.md §A.7 item 4."""
    mode = deps.ca_mode()
    if mode == "auto":
        raise NotImplementedError(
            "PYLOPS_MPI_TPU_TORCH_CA=auto is not ported: it picks the "
            "engine by the cost model, ROADMAP.md §A.7 item 4; set off, "
            "pipelined or sstep")
    return mode


def ca_key(mode: str, s: Optional[int] = None):
    """Key fragment naming a CA engine; ``off`` contributes nothing."""
    if mode == "off":
        return ()
    if mode == "sstep":
        return (("ca", "sstep", int(s)),)
    return (("ca", mode),)


# ------------------------------------------------------ fallback events
_LAST_FALLBACK: Optional[dict] = None


def _record_fallback(solver: str, s: int, iiter: int) -> None:
    global _LAST_FALLBACK
    _LAST_FALLBACK = {"solver": solver, "s": int(s), "iteration": int(iiter)}


def last_fallback() -> Optional[dict]:
    """The latest s-step → pipelined breakdown fallback, ``{solver, s,
    iteration}``, or ``None``."""
    return dict(_LAST_FALLBACK) if _LAST_FALLBACK else None


def clear_fallback() -> None:
    global _LAST_FALLBACK
    _LAST_FALLBACK = None


# ------------------------------------------------------ stacked reductions
def _bdot(u: DistributedArray, v: DistributedArray) -> torch.Tensor:
    """Per-column recurrence dots ``|conj(u)·v|`` of block vectors at the
    reduction dtype, one ``all_reduce`` (``DistributedArray.col_dot``)."""
    return torch.abs(u.col_dot(v, vdot=True)).to(reduction_dtype(u.dtype))


def _fusable(vs) -> bool:
    """The dots over these vectors can share one ``all_reduce``: plain
    unmasked :class:`DistributedArray` s of one layout."""
    v0 = vs[0]
    return all(isinstance(v, DistributedArray) and v.mask is None
               and v.local_shapes == v0.local_shapes
               and v.partition == v0.partition and v.axis == v0.axis
               for v in vs)


def _stacked(pairs, block: bool) -> torch.Tensor:
    """The recurrence dots of ``pairs`` stacked into one tensor before
    ONE ``all_reduce``: ``(m,)`` of ``|u·conj(v)|`` (``(m, K)`` of
    per-column ``|conj(u)·v|`` for block vectors). Spaces that cannot
    share a reduction (stacked, masked, differently split) take one
    collective per dot."""
    flat = [v for p in pairs for v in p]
    if not _fusable(flat):
        one = _bdot if block else _rdot
        return torch.stack([one(u, v) for u, v in pairs])
    u0 = pairs[0][0]
    acc = accum_dtype(u0.dtype)
    if block:
        parts = [torch.sum((u.array.conj() * v.array).to(acc), dim=0)
                 for u, v in pairs]
    else:
        parts = [torch.sum((u.array * v.array.conj()).to(acc))
                 for u, v in pairs]
    k = torch.stack(parts)
    if u0._reduces():
        k = collectives.all_reduce(k, "sum")
    return torch.abs(k).to(reduction_dtype(u0.dtype))


# ------------------------------------------------------ pipelined engine
def _pipe_step(applyA, M, tol: float, block: bool, niter: int,
               first: bool = False, guards: bool = False, stall_n: int = 0,
               fault=None):
    """One pipelined (P)CG iteration (JAX ``_make_pipe_body``) over the
    carry ``(x, r, u, w, z, s, p, q, aold, kold, iiter, it, cost,
    status, bestk, stall)`` (the last three ``None`` without guards) and
    the constants ``(floors, stop)``; ``first`` is iteration 0, whose
    momentum is zero. The freeze is per column for block vectors
    (``kold <= max(floors, tol)``), at the machine floor ``γ <= floors``
    otherwise; once the loop's condition fails nothing moves any more.
    ``fault`` (guarded loops only) injects at the apply ``n = A M w``
    and the step scalar."""
    precond = M is not None
    nan_at, stall_at = faults.fault_sites(fault if guards else None)

    def step(state, consts):
        (x, r, u, w, z, s, p, q, aold, kold, iiter, it, cost, status, bestk,
         stall) = state
        floors, stop = consts
        xdt = x.dtype
        active = _live(kold, tol, status if guards else None)
        # the single reduction, first: the apply below does not wait on it
        g = _stacked(((r, u), (w, u)), block)
        gamma, delta = g[0], g[1]
        m = _precond_apply(M, w, xdt)
        n = applyA(m)
        if nan_at is not None:
            n = faults.inject_nan(n, iiter, nan_at)
        done = (kold <= stop) if block else (gamma <= floors)
        if block and guards:
            done = done | (status != RUNNING)
        done = _or_idle(done, active)
        zero = torch.zeros_like(gamma)
        b = zero if first else torch.where(done, zero, gamma / kold)
        a = torch.where(done, zero, gamma / (delta - b * gamma / aold))
        if stall_at is not None:
            a = faults.inject_stall(a, iiter, stall_at)
        bs = _step_scalar(b, xdt)
        as_ = _step_scalar(a, xdt)
        zn = n + z * bs
        sn = w + s * bs
        pn = u + p * bs
        if precond:
            qn = m + q * bs
            un = u - qn * as_
        xn = x + pn * as_
        rn = r - sn * as_
        wn = w - zn * as_
        if guards:
            from .block import _bguard_update
            bad = _nonfinite(a, b, gamma, delta)
            hold = _or_idle(bad, active)
            x, r, w, z, s, p = (_reject(hold, x, xn), _reject(hold, r, rn),
                                _reject(hold, w, wn), _reject(hold, z, zn),
                                _reject(hold, s, sn), _reject(hold, p, pn))
            if precond:
                u, q = _reject(hold, u, un), _reject(hold, q, qn)
            k = torch.where(bad, kold, gamma)
            update = _bguard_update if block else _guard_update
            status, bestk, stall = update(status, bestk, stall, bad, k, done,
                                          stall_n, active)
            aold = torch.where(bad | done, aold, a)
        else:
            z, s, p = zn, sn, pn
            if precond:
                q, u = qn, un
            # nothing moves once the loop's condition failed (a
            # non-finite lane would otherwise leak into x through p·0)
            x = _reject(active, xn, x)
            r, w = rn, wn
            k = gamma
            aold = torch.where(done, aold, a)
        if not precond:
            u = r
        kold = torch.where(active, k, kold)
        iiter = iiter + active.to(iiter.dtype)
        it = it + 1
        _record(cost, _slot(it, active, niter + 1), torch.sqrt(kold))
        return (x, r, u, w, z, s, p, q, aold, kold, iiter, it, cost, status,
                bestk, stall)
    return step


def _pipe_guard(kold, block: bool, guards: bool):
    """The guard carry's start ``(status, bestk, stall)`` (per column
    for block vectors) and the stall window, or Nones and 0."""
    if not guards:
        return (None, None, None), 0
    from ..resilience.status import stall_window
    shape = tuple(kold.shape) if block else ()
    return ((_status0(kold.device, kold.shape[0] if block else None),
             kold.clone() if block else torch.max(kold),
             torch.zeros(shape, dtype=torch.int32, device=kold.device)),
            stall_window())


def _pipe_state(M, applyA, x, r, u, kold, niter: int, block: bool,
                guards: bool):
    """The pipelined loop's seeded carry before iteration 0 (the
    companions start as aliases, which iteration 0 overwrites) and the
    stall window."""
    w = applyA(u)
    guard, stall_n = _pipe_guard(kold, block, guards)
    state = (x, r, u, w, w, w, u, u if M is not None else None,
             torch.ones_like(kold),
             kold, torch.zeros((), dtype=torch.int64, device=kold.device),
             _counter(kold.device), _history(torch.sqrt(kold), niter)) + guard
    return state, stall_n


def _pipe_graph(Op, M, y, applyA, state, floors, tol: float, niter: int,
                block: bool, solver: str, scalars, guards: bool,
                stall_n: int, fault=None):
    """The pipelined loop (iterations after 0) over ``state`` as an
    :class:`~..aot.graphs.Loop`, and iteration 0's step."""
    from ..aot import graphs
    consts = (floors, _tol_floor(floors, tol))
    loop = graphs.Loop(solver, dict(scalars, tol=tol, mode="pipelined",
                                    guards=guards, stall=stall_n,
                                    **_fault_key(guards, fault)),
                       Op, M, y, state, consts,
                       _pipe_step(applyA, M, tol, block, niter, False,
                                  guards, stall_n, fault))
    first = _pipe_step(applyA, M, tol, block, niter, True, guards, stall_n,
                       fault)
    return loop, lambda st: first(st, consts)


def _pipe_head(Op, M, y, applyA, x, r, u, kold, floors, tol: float,
               niter: int, block: bool, solver: str, scalars, guards: bool,
               fault):
    """The pipelined loop's :class:`~..aot.graphs.Loop` after its peeled
    iteration 0."""
    state, stall_n = _pipe_state(M, applyA, x, r, u, kold, niter, block,
                                 guards)
    loop, first = _pipe_graph(Op, M, y, applyA, state, floors, tol, niter,
                              block, solver, scalars, guards, stall_n, fault)
    if niter > 0:
        loop.state = first(loop.state)
    return loop


def _pipe_live(tol: float, guards: bool):
    return lambda st: _live(st[9], tol, st[13] if guards else None)


def _pipe_loop(solver: str, scalars, Op, M, y, applyA, x, r, u, kold,
               floors, tol: float, niter: int, block: bool,
               guards: bool = False, fault=None):
    """The pipelined (P)CG loop from the seeded ``x, r, u = M r`` and
    ``kold``: iteration 0, then the rest through :mod:`..aot.graphs`.
    Returns ``(x, iiter, cost, kold, code)``, ``code`` the status word
    (a list for block vectors) with guards, else ``None``."""
    from ..aot import graphs
    loop = _pipe_head(Op, M, y, applyA, x, r, u, kold, floors, tol, niter,
                      block, solver, scalars, guards, fault)
    state = graphs.run_iterations(loop, _pipe_live(tol, guards), niter,
                                  start=1)
    x, kold, iiter, cost = state[0], state[9], state[10], state[12]
    code = _resolve_status(state[13], kold, tol) if guards else None
    return x, int(iiter), cost, kold, code


def _tol_floor(floors: torch.Tensor, tol: float) -> torch.Tensor:
    """``max(floors, tol)``: where a lane freezes."""
    return torch.maximum(floors, torch.as_tensor(tol, dtype=floors.dtype,
                                                 device=floors.device))


def _pipe_cg_seed(Op, y, x, M, block: bool):
    """Pipelined (P)CG's seed ``(r, u = M r, kold)``."""
    r = y - Op.matvec(x)
    u = _precond_apply(M, r, x.dtype)
    kold = _bdot(r, u) if block else _rdot(r, u)
    return r, u, kold


def _pipe_cg(Op, y, x, niter: int, tol: float, M, block: bool,
             guards: bool = False, fault=None):
    """Pipelined (P)CG from ``x``: ``(x, iiter, cost, kold, code)``."""
    r, u, kold = _pipe_cg_seed(Op, y, x, M, block)
    return _pipe_loop("block_cg" if block else "cg", {}, Op, M, y, Op.matvec,
                      x, r, u, kold, _mp_floor(kold), tol, niter, block,
                      guards, fault)


def _normal_apply(Op, damp2: float, xdt, normal: bool):
    """``v → (AᴴA + damp²I) v``: one ``Op.normal_matvec`` (the one-sweep
    kernel where the operator has it) with ``normal=True``, else
    ``rmatvec(matvec(v))``."""
    d2 = _step_scalar(torch.tensor(damp2, dtype=torch.float64), xdt)
    if normal:
        def applyA(v):
            u2, _ = Op.normal_matvec(v)
            return u2 + v * d2
    else:
        def applyA(v):
            return Op.rmatvec(Op.matvec(v)) + v * d2
    return applyA


def _pipe_cgls_seed(Op, y, x, damp: float, normal: bool, M, block: bool):
    """Pipelined (P)CGLS's seed (JAX ``_pipe_cgls_seed``) ``(applyA, r,
    u, kold, floors)``: it matches the classic engine's, the reference's
    un-squared setup damp included, so ``kold``, the floors and
    ``cost[0]`` agree with it; the carried residual is the true damped
    normal residual."""
    xdt = x.dtype
    damp2 = damp ** 2
    sc = torch.tensor(damp, dtype=torch.float64)
    applyA = _normal_apply(Op, damp2, xdt, normal)
    s0 = y - Op.matvec(x)
    rq = Op.rmatvec(s0) - x * _step_scalar(sc, xdt)
    zq = _precond_apply(M, rq, xdt)
    kold = _bdot(rq, zq) if block else _rdot(rq, zq)
    floors = _mp_floor(kold)
    r = rq + x * _step_scalar(sc - damp2, xdt)
    u = _precond_apply(M, r, xdt)
    return applyA, r, u, kold, floors


def _pipe_cgls(Op, y, x, niter: int, damp: float, tol: float,
               normal: bool, M, block: bool, guards: bool = False,
               fault=None):
    """Pipelined (P)CGLS from ``x``: ``(x, iiter, cost, kold, code)``."""
    applyA, r, u, kold, floors = _pipe_cgls_seed(Op, y, x, damp, normal, M,
                                                 block)
    return _pipe_loop("block_cgls" if block else "cgls",
                      dict(damp=damp, normal=normal), Op, M, y, applyA, x, r,
                      u, kold, floors, tol, niter, block, guards, fault)


# ------------------------------------------------------ s-step engine
def _even(v: DistributedArray) -> bool:
    return len(set(v.local_shapes)) == 1


def _sstep_eligible(*vs) -> bool:
    """s-step needs signed real Gram algebra on one even layout: plain,
    unmasked, evenly split, real :class:`DistributedArray` s."""
    return all(isinstance(v, DistributedArray) and v.mask is None
               and _even(v) and not v.dtype.is_complex for v in vs)


def _sstep_maps(s: int):
    """Coordinate operators of the ``2s+1``-column basis ``V = [V_0..V_s
    | Z_0..Z_{s-1}]`` with products ``W = [W_0..W_{s-1} | Y_0..Y_{s-2}]``
    (``W_j = A V_j``, ``Y_j = A Z_j``): ``Amap`` takes V-coordinates to
    the W-coordinates of ``A·``, ``Smap`` shifts V-coordinates by one
    application of ``M A`` (JAX ``_sstep_maps``)."""
    nv, nw = 2 * s + 1, 2 * s - 1
    Amap = np.zeros((nw, nv))
    Smap = np.zeros((nv, nv))
    for j in range(s):
        Amap[j, j] = 1.0
        Smap[j + 1, j] = 1.0
    for j in range(s - 1):
        Amap[s + j, s + 1 + j] = 1.0
        Smap[s + 2 + j, s + 1 + j] = 1.0
    return Amap, Smap


def _sstep_outer(Op, M, niter: int, s: int, tol: float = 0.0,
                 guards: bool = False, stall_n: int = 0):
    """One outer step of s-step CA-CG (JAX ``_make_sstep_body``) over the
    carry ``(x, r, z, p, kold, iiter, status, moved, cost, bestk,
    stall)`` (the last two ``None`` without guards) and the constants
    ``(Amap, Smap, tol_floor)``: ``2s - 1`` operator applies, ONE
    reduction of the Gram tile, then ``s`` CG steps on replicated
    coordinate vectors. With ``guards`` the guard carry's stagnation
    window runs too (JAX ``_guard_update`` with ``stall_n``)."""
    precond = M is not None
    nv, nw = 2 * s + 1, 2 * s - 1

    def step(state, consts):
        x, r, z, p, kold, iiter, status, moved, cost, bestk, stall = state
        Amap, Smap, tol_floor = consts
        live = (iiter < niter) & (kold > tol) & (status == RUNNING)
        xdt = x.dtype
        acc = Amap.dtype
        dev = kold.device
        # monomial chains from the direction p and the residual z: all
        # operator applies, no dots
        V, W = [p], []
        v = p
        for _ in range(s):
            Av = Op.matvec(v)
            W.append(Av)
            v = _precond_apply(M, Av, xdt)
            V.append(v)
        Zc, Yc = [z], []
        zc = z
        for _ in range(s - 1):
            Az = Op.matvec(zc)
            Yc.append(Az)
            zc = _precond_apply(M, Az, xdt)
            Zc.append(zc)
        Vm = torch.stack([x._coerce_operand(c) for c in V + Zc]).to(acc)
        Wm = torch.stack([x._coerce_operand(c) for c in W + Yc]
                         + [r.array]).to(acc)
        # THE collective of the outer step: every inner product s CG
        # iterations need, in one (2s+1, 2s) tile
        Gall = (Vm @ Wm.T).contiguous()
        if x._reduces():
            Gall = collectives.all_reduce(Gall, "sum")
        G, g0 = Gall[:, :nw], Gall[:, nw]
        cp = torch.zeros(nv, dtype=acc, device=dev)
        cp[0] = 1.0
        cz = torch.zeros(nv, dtype=acc, device=dev)
        cz[s + 1] = 1.0
        d = torch.zeros(nw, dtype=acc, device=dev)
        e = torch.zeros(nv, dtype=acc, device=dev)
        k_run = kold.to(acc)
        bad = torch.zeros((), dtype=torch.bool, device=dev)
        iit = iiter
        zero = torch.zeros((), dtype=acc, device=dev)
        for _ in range(s):
            gamma = g0 @ cz - d @ (G.T @ cz)
            done = (k_run <= tol_floor) | (iit >= niter)
            acp = Amap @ cp
            delta = acp @ (G.T @ cp)
            alpha = gamma / delta
            sick = (~torch.isfinite(alpha) | ~torch.isfinite(gamma)
                    | ~torch.isfinite(delta) | (delta <= 0))
            bad = bad | (sick & ~done)
            live = ~done & ~bad
            alpha = torch.where(live, alpha, zero)
            e = e + alpha * cp
            d = d + alpha * acp
            cz = cz - alpha * (Smap @ cp)
            gamma_n = g0 @ cz - d @ (G.T @ cz)
            beta = torch.where(live, gamma_n / gamma, zero)
            cp = torch.where(live, cz + beta * cp, cp)
            k_run = torch.where(live, torch.abs(gamma_n), k_run)
            iit = iit + live.to(iit.dtype)
            _record(cost, iit.reshape(1), torch.sqrt(k_run))
        # recombination against the stored basis, local
        xn = x.array + (e @ Vm).to(x.dtype)
        rn = r.array - (d @ Wm[:nw]).to(r.dtype)
        x = DistributedArray._wrap(torch.where(bad, x.array, xn), x)
        r = DistributedArray._wrap(torch.where(bad, r.array, rn), r)
        p = DistributedArray._wrap(
            torch.where(bad, p.array, (cp @ Vm).to(r.dtype)), r)
        if precond:
            z = DistributedArray._wrap(
                torch.where(bad, z.array, (cz @ Vm).to(r.dtype)), r)
        else:
            z = r
        kold = torch.where(bad, kold, k_run.to(kold.dtype))
        if guards:
            status, bestk, stall = _guard_update(
                status, bestk, stall, bad, kold,
                kold <= tol_floor.to(kold.dtype), stall_n, live)
        else:
            status = torch.where(bad, torch.full_like(status, BREAKDOWN),
                                 status)
        # ``moved``: an outer step that ran no inner step (every lane
        # frozen at the machine floor, tol below it) ends the loop; the
        # JAX package's while loop would spin there
        moved = (iit > iiter) | bad
        return x, r, z, p, kold, iit, status, moved, cost, bestk, stall
    return step


def _sstep_seed(Op, y, x, niter: int, tol: float, s: int, M,
                guards: bool = False):
    """s-step's seeded carry, constants and stall window (JAX
    ``_sstep_cg_seed``)."""
    xdt = x.dtype
    r = y - Op.matvec(x)
    r = DistributedArray._wrap(x._coerce_operand(r), x)
    z = _precond_apply(M, r, xdt)
    kold = _rdot(r, z)
    floors = _mp_floor(kold)
    dev = kold.device
    acc = accum_dtype(xdt)
    Amap, Smap = (torch.as_tensor(t, dtype=acc, device=dev)
                  for t in _sstep_maps(s))
    stall_n = 0
    guard = (None, None)
    if guards:
        from ..resilience.status import stall_window
        stall_n = stall_window()
        guard = (kold.clone(), torch.zeros((), dtype=torch.int32,
                                           device=dev))
    state = (x, r, z, z, kold, torch.zeros((), dtype=torch.int64, device=dev),
             torch.tensor(RUNNING, dtype=torch.int32, device=dev),
             torch.ones((), dtype=torch.bool, device=dev),
             _history(torch.sqrt(kold), niter)) + guard
    return state, (Amap, Smap, _tol_floor(floors.to(acc), tol)), stall_n


def _sstep_cg(Op, y, x, niter: int, tol: float, s: int, M,
              guards: bool = False):
    """s-step CA-CG (JAX ``_make_sstep_body``/``_sstep_cg_fused``), its
    outer steps through :mod:`..aot.graphs` (one outer step a segment).
    Returns ``(x, iiter, cost, status, kold)``; the status word is
    ``BREAKDOWN`` when the basis guard rejected an outer step (or, with
    guards, ``STAGNATION``)."""
    from ..aot import graphs
    state, consts, stall_n = _sstep_seed(Op, y, x, niter, tol, s, M, guards)
    loop = graphs.Loop("cg", dict(tol=tol, mode="sstep", s=s, guards=guards,
                                  stall=stall_n), Op, M, y,
                       state, consts,
                       _sstep_outer(Op, M, niter, s, tol, guards, stall_n),
                       per_segment=1)
    x, _, _, _, kold, iiter, status, _, cost, _, _ = graphs.run_while(
        loop, lambda st: ((st[5] < niter) & (st[4] > tol)
                          & (st[6] == RUNNING) & st[7]))
    return x, int(iiter), cost, status, kold


# ------------------------------------------------------ runners
def run_cg(Op, y, x0, niter: int, tol: float, M=None,
           mode: str = "pipelined", guards: bool = False, fault=None):
    """CA twin of the fused ``cg``: ``(x, iiter, cost[:iiter+1], code)``,
    ``code`` the status word with ``guards``, else ``None``. ``sstep``
    on an ineligible space, or with a fault armed, runs pipelined; a
    basis breakdown continues pipelined from the last completed outer
    iterate."""
    if mode == "sstep" and (fault is not None
                            or not _sstep_eligible(y, x0)):
        mode = "pipelined"
    if mode == "sstep":
        s = deps.ca_s_default()
        x, iiter, cost, status, kold = _sstep_cg(Op, y, x0, niter, tol, s,
                                                 M, guards)
        cost = cost[:iiter + 1]
        code = _resolve_status(status, kold, tol) if guards else None
        if int(status) == BREAKDOWN and iiter < niter:
            _record_fallback("cg", s, iiter)
            x, it2, cost2, _, code = _pipe_cg(Op, y, x, niter - iiter, tol,
                                              M, False, guards)
            cost = torch.cat([cost, cost2[1:it2 + 1]])
            iiter += it2
        return x, iiter, cost, code
    x, iiter, cost, _, code = _pipe_cg(Op, y, x0, niter, tol, M, False,
                                       guards, fault)
    return x, iiter, cost[:iiter + 1], code


def run_cgls(Op, y, x0, niter: int, damp: float, tol: float,
             normal: bool, M=None, guards: bool = False, fault=None):
    """CA twin of the fused ``cgls``: ``(x, iiter, cost[:iiter+1], kold,
    code)``, ``cost`` the normal-residual norms. s-step requests run
    pipelined, which already takes one reduction an iteration."""
    x, iiter, cost, kold, code = _pipe_cgls(Op, y, x0, niter, damp, tol,
                                            normal, M, False, guards, fault)
    return x, iiter, cost[:iiter + 1], kold, code


def run_block_cg(Op, y, x0, niter: int, tol: float, M=None,
                 guards: bool = False, fault=None):
    """Pipelined block CG (K > 1; s-step has no block form):
    ``(x, iiter, cost[:iiter+1], codes)`` with ``(K,)`` lanes."""
    x, iiter, cost, _, codes = _pipe_cg(Op, y, x0, niter, tol, M, True,
                                        guards, fault)
    return x, iiter, cost[:iiter + 1], codes


def run_block_cgls(Op, y, x0, niter: int, damp: float, tol: float, M=None,
                   guards: bool = False, fault=None):
    """Pipelined block CGLS (K > 1): ``(x, istop, iiter, kold, r2norm,
    cost, codes)``, the first six as ``block_cgls`` returns, ``cost``
    the normal-residual norms."""
    x, iiter, cost, kold, codes = _pipe_cgls(Op, y, x0, niter, damp, tol,
                                             False, M, True, guards, fault)
    istop = torch.where(kold < tol, 1, 2)
    return x, istop, iiter, kold, cost[iiter], cost[:iiter + 1], codes


# ------------------------------------------------------ segmented seams
def seg_fields(solver: str, mode: str, M) -> tuple:
    """Checkpoint field names of a CA segmented carry (JAX
    ``seg_fields``): the step's carry, ``None`` entries included (a
    field the engine elides is stored as ``None``)."""
    if mode == "sstep":
        return ("x", "r", "z", "p", "kold", "iiter", "status", "moved",
                "cost", "bestk", "stall")
    return ("x", "r", "u", "w", "z", "s", "p", "q", "aold", "kold", "iiter",
            "it", "cost", "status", "bestk", "stall")


def check_resume_ca(state: dict, mode: str, s: Optional[int] = None):
    """Refuse a resume whose checkpoint was written under another CA
    engine (JAX ``check_resume_ca``): the carries are different. A
    checkpoint with no ``ca`` stamp counts as ``off``."""
    got = str(state.get("ca", "off"))
    if got != mode:
        raise ValueError(
            f"fused-carry checkpoint was written with ca={got!r} but this "
            f"run requests ca={mode!r}: resume must replay the same plan "
            "(set PYLOPS_MPI_TPU_TORCH_CA to match or restart without "
            "resume=True)")
    if mode == "sstep":
        got_s = int(state.get("ca_s", 0))
        if s is not None and got_s != int(s):
            raise ValueError(
                f"fused-carry checkpoint was written with s={got_s} but "
                f"this run requests s={int(s)}: resume must replay the "
                "same plan")
