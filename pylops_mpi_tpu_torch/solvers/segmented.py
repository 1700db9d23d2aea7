"""Segmented fused solves: epochs of the fused loop, with checkpoints.

PyTorch counterpart of ``pylops_mpi_tpu/solvers/segmented.py:58-464``
and of ``block_cg_segmented`` (``solvers/block.py:583-``). A fused solve
runs ``niter`` iterations in one loop and loses them all with its
process. A segmented solve runs them in **epochs** of ``E`` iterations;
between epochs the carry can be checkpointed
(:func:`~..utils.checkpoint.save_fused_carry`) and inspected
(``on_epoch``). A process killed between epochs resumes from the file.

Each epoch runs the fused loop's own step functions (:mod:`.basic`'s
``_cg_step``/``_cgls_step``, :mod:`.ca`'s engines, :mod:`.block`'s)
through :func:`~..aot.graphs.run_iterations` on one
:class:`~..aot.graphs.Loop`, under the fused solve's key: a segmented
solve is bit for bit the fused one, eagerly and through the bank of
captured graphs, and a resumed one bit for bit the uninterrupted one.
(The loop freezes once its condition fails, so where the epochs end
changes nothing.)

``E`` is ``epoch=``, else ``PYLOPS_MPI_TPU_TORCH_SEGMENT`` (unset or 0:
one epoch of ``niter``). The checkpoint holds the plan (``niter``,
``tol``, ``damp``, ``guards``, the preconditioner's signature, and for a
communication-avoiding engine its name and :data:`~.ca.CA_SCHEMA`); a
resume under another plan refuses (``resume must replay the same
plan``). ``resume_state`` resumes from a carry held in memory instead,
for example one converted from a JAX checkpoint by
:func:`~..convert.fused_carry_from_jax` or banked in memory by the
in-place recovery (:func:`~..resilience.elastic.restore_carry`). A
guarded solve ends its epoch early on a verdict and stops with it, the
last finite iterate in the final checkpoint. Under a supervisor the
heartbeat starts with the solve.

**In-place recovery** (JAX ``solvers/segmented.py:397-435``): while
:func:`~..resilience.elastic.inplace_armed`, each epoch boundary first
polls :func:`~..resilience.elastic.pending_reconfig` and raises
:class:`~..resilience.elastic.ElasticReconfig` when the supervisor has
shrunk the world (as does an epoch whose collective raised because the
peer died inside it, once the reconfig lands), and after each epoch
banks the carry
(:func:`~..resilience.elastic.bank_carry`) **before** the checkpoint is
written, so that an epoch the supervisor can see saved is also banked.

``cgls_segmented(normal=True)`` runs the one-sweep schedule of the
fused ``cgls(normal=True)`` (the normal kernel once an iteration on
``MPIBlockDiag``), a port extension: the JAX package's segmented CGLS
is the classic schedule only. The checkpoint then banks ``normal``, and
a resume under the other schedule refuses.
"""

from __future__ import annotations

import contextlib
import os
from collections import namedtuple
from typing import Callable, Optional

import numpy as np
import torch

from ..diagnostics import trace as _trace
from ..distributedarray import DistributedArray
from ..resilience import status as _rstatus
from . import ca as _ca
from .basic import (_cg_loop, _cg_setup, _cgls_loop, _cgls_setup, _live,
                    _mp_floor, _zero_like_model)

__all__ = ["cg_segmented", "cgls_segmented", "block_cg_segmented",
           "SegmentedResult", "resolve_epoch", "precond_signature"]

SegmentedResult = namedtuple(
    "SegmentedResult",
    ["x", "istop", "iiter", "r1norm", "r2norm", "cost", "status",
     "epochs"])
SegmentedResult.__doc__ = (
    "A segmented solve's result: the fused solve's fields (``x``, "
    "``istop``, ``iiter``, ``r1norm``, ``r2norm``, ``cost``), the status "
    "name and the epochs run in this process (a resumed solve counts "
    "only its own).")

_FUSED_SCHEMA = 1  # classic carries; CA carries stamp ca.CA_SCHEMA

# checkpoint fields: each loop's carry, in its order ("it" is the device
# step index, equal to "iiter" while the loop runs)
_CG_FIELDS = ("x", "r", "c", "kold", "iiter", "it", "cost", "status",
              "bestk", "stall")
_CGLS_FIELDS = ("x", "s", "c", "q", "kold", "iiter", "it", "cost", "cost1",
                "status", "bestk", "stall")
_BLOCK_CG_FIELDS = _CG_FIELDS


def resolve_epoch(epoch: Optional[int], niter: int) -> int:
    """The epoch length: ``epoch`` beats ``PYLOPS_MPI_TPU_TORCH_SEGMENT``
    (unset or 0: one epoch of ``niter``), clamped to ``[1, niter]``."""
    if epoch is None:
        try:
            epoch = int(os.environ.get("PYLOPS_MPI_TPU_TORCH_SEGMENT", "0"))
        except ValueError:
            epoch = 0
        if epoch < 1:
            epoch = niter
    return max(1, min(int(epoch), niter))


def precond_signature(M) -> str:
    """A preconditioner's configuration (not its instance), as the
    checkpoint banks it (JAX ``_precond_signature``)."""
    if M is None:
        return "none"
    sig = getattr(M, "precond_signature", None)
    if callable(sig):
        return str(sig())
    return f"{type(M).__name__}{tuple(M.shape)}"


def _check_plan(state: dict, expect: dict, what: str) -> dict:
    for key, want in expect.items():
        got = state.get(key)
        if isinstance(want, float):
            ok = got is not None and float(got) == float(want)
        else:
            ok = got == want
        if not ok:
            raise ValueError(
                f"{what} was saved with {key}={got!r}, resume requested "
                f"{key}={want!r}; resume must replay the same plan")
    return dict(state)


def _load_carry(path, solver, device, backend, expect):
    """The validated carry of ``path``, or ``None`` when it does not
    exist."""
    from ..utils import checkpoint as _ckpt
    if not path or not os.path.exists(path):
        return None
    state = _ckpt.load_fused_carry(path, solver, device=device,
                                   backend=backend)
    return _check_plan(state, expect,
                       f"fused-carry checkpoint {path!r}")


def _tensor(v, device):
    """A stored field back on the device (numpy → tensor; ``None``
    stays)."""
    if v is None or isinstance(v, (torch.Tensor, DistributedArray)):
        return v
    return torch.as_tensor(np.asarray(v)).to(device)


def _carry_tuple(state: dict, fields, device):
    """The loop carry of a loaded ``state``: numpy fields as tensors, a
    missing step index ``it`` (a carry of the JAX package) from
    ``iiter``."""
    out = []
    for f in fields:
        v = state.get(f)
        if f == "it" and v is None:
            v = np.asarray(state["iiter"]).reshape(1)
        out.append(_tensor(v, device))
    return tuple(out)


def _final_status(status, kold, tol: float) -> int:
    """The verdict when the epochs end: the guard's, else breakdown for
    a non-finite recurrence (a backstop even unguarded), else converged
    or maxiter."""
    code = _rstatus.RUNNING if status is None else int(status)
    if code != _rstatus.RUNNING:
        return code
    kmax = float(torch.max(kold))
    if not np.isfinite(kmax):
        return _rstatus.BREAKDOWN
    return _rstatus.CONVERGED if kmax <= tol else _rstatus.MAXITER


def cg_segmented(Op, y, x0=None, niter: int = 100, tol: float = 1e-4,
                 epoch: Optional[int] = None,
                 checkpoint_path: Optional[str] = None, resume: bool = True,
                 backend: Optional[str] = None,
                 guards: Optional[bool] = None,
                 on_epoch: Optional[Callable] = None,
                 resume_state: Optional[dict] = None, M=None
                 ) -> SegmentedResult:
    """Segmented fused CG: epochs of ``epoch`` iterations, checkpointed
    to ``checkpoint_path`` after each (when given) and resumed from it
    (``resume``) after a kill; ``resume_state`` resumes from a carry in
    memory. ``M`` preconditions the epochs; its signature is banked, so
    a resume under another preconditioner refuses."""
    return _segmented(Op, y, x0, "cg", niter, 0.0, tol, epoch,
                      checkpoint_path, resume, backend, guards, on_epoch,
                      resume_state, M, False)


def cgls_segmented(Op, y, x0=None, niter: int = 100, damp: float = 0.0,
                   tol: float = 1e-4, epoch: Optional[int] = None,
                   checkpoint_path: Optional[str] = None,
                   resume: bool = True, backend: Optional[str] = None,
                   guards: Optional[bool] = None,
                   on_epoch: Optional[Callable] = None,
                   resume_state: Optional[dict] = None, M=None,
                   normal: bool = False) -> SegmentedResult:
    """Segmented fused CGLS; see :func:`cg_segmented`. The classic
    two-sweep schedule, or with ``normal=True`` the one-sweep schedule
    of ``cgls(normal=True)`` (module docstring). A killed process called
    again with the same ``checkpoint_path`` and plan resumes from the
    last saved epoch and ends bit for bit where the uninterrupted solve
    ends."""
    return _segmented(Op, y, x0, "cgls", niter, damp, tol, epoch,
                      checkpoint_path, resume, backend, guards, on_epoch,
                      resume_state, M, normal)


class _Engine:
    """One segmented loop: its field names, its seeded carry, the
    :class:`~..aot.graphs.Loop` the epochs run on and how an epoch
    advances it."""

    def __init__(self, Op, y, x0, solver, mode, niter, damp, tol,
                 guards, M, ca_s, normal=False):
        self.Op, self.y, self.solver, self.mode = Op, y, solver, mode
        self.niter, self.damp, self.tol = niter, damp, tol
        self.guards, self.M, self.ca_s = guards, M, ca_s
        self.normal = bool(normal)
        self.x0 = x0
        cgls = solver == "cgls"
        if mode == "off":
            self.fields = _CGLS_FIELDS if cgls else _CG_FIELDS
        else:
            self.fields = _ca.seg_fields(solver, mode, M)

    # -- the first carry
    def setup(self) -> dict:
        Op, y, x, M = self.Op, self.y, self.x0, self.M
        g, n = self.guards, self.niter
        if self.mode == "sstep":
            state, consts, _ = _ca._sstep_seed(Op, y, x, n, self.tol,
                                               self.ca_s, M, g)
            floors = _mp_floor(state[4])
        elif self.mode == "pipelined":
            applyA, r, u, kold, floors = self._pipe_seed()
            state, _ = _ca._pipe_state(M, applyA, x, r, u, kold, n, False,
                                       g)
        elif self.solver == "cgls":
            state, (floors,), _ = _cgls_setup(Op, y, x, n, self.damp,
                                              self.normal, M, g)
        else:
            state, (floors,), _ = _cg_setup(Op, y, x, n, M, g)
        out = dict(zip(self.fields, state))
        out["floors"] = floors
        return out

    def _pipe_seed(self):
        if self.solver == "cgls":
            return _ca._pipe_cgls_seed(self.Op, self.y, self.x0, self.damp,
                                       self.normal, self.M, False)
        r, u, kold = _ca._pipe_cg_seed(self.Op, self.y, self.x0, self.M,
                                       False)
        return self.Op.matvec, r, u, kold, _mp_floor(kold)

    # -- the loop
    def build(self, state: dict) -> None:
        from ..resilience.status import stall_window
        carry = tuple(state[f] for f in self.fields)
        floors = state["floors"]
        g, n, tol = self.guards, self.niter, self.tol
        stall_n = stall_window() if g else 0
        Op, M, y = self.Op, self.M, self.y
        self.first = None
        if self.mode == "sstep":
            from ..aot import graphs
            acc = _ca.accum_dtype(carry[0].dtype)
            Amap, Smap = (torch.as_tensor(t, dtype=acc,
                                          device=floors.device)
                          for t in _ca._sstep_maps(self.ca_s))
            self.loop = graphs.Loop(
                "cg", dict(tol=tol, mode="sstep", s=self.ca_s, guards=g,
                           stall=stall_n), Op, M, y, carry,
                (Amap, Smap, _ca._tol_floor(floors.to(acc), tol)),
                _ca._sstep_outer(Op, M, n, self.ca_s, tol, g, stall_n),
                per_segment=1)
        elif self.mode == "pipelined":
            if self.solver == "cgls":
                applyA = _ca._normal_apply(Op, self.damp ** 2,
                                           carry[0].dtype, self.normal)
                scalars = dict(damp=self.damp, normal=self.normal)
            else:
                applyA, scalars = Op.matvec, {}
            self.loop, self.first = _ca._pipe_graph(
                Op, M, y, applyA, carry, floors, tol, n, False, self.solver,
                scalars, g, stall_n)
        elif self.solver == "cgls":
            self.loop = _cgls_loop(Op, M, y, carry, (floors,), n, self.damp,
                                   tol, self.normal, g, stall_n)
        else:
            self.loop = _cg_loop(Op, M, y, carry, (floors,), n, tol, g,
                                 stall_n)

    def epoch(self, end: int) -> tuple:
        """Advance the loop to iteration ``end`` (an s-step epoch may
        overshoot by up to ``s - 1``); returns the carry."""
        from ..aot import graphs
        tol, g = self.tol, self.guards
        if self.mode == "sstep":
            n = self.niter
            return graphs.run_while(
                self.loop, lambda st: ((st[5] < min(end, n)) & (st[4] > tol)
                                       & (st[6] == _rstatus.RUNNING)
                                       & st[7]))
        k, s = ((9, 13) if self.mode == "pipelined"
                else (4, 9) if self.solver == "cgls" else (3, 7))
        start = int(self.loop.state[self.fields.index("it")])
        if self.first is not None and start == 0:
            self.loop.state = self.first(self.loop.state)
            start = 1
        return graphs.run_iterations(
            self.loop, lambda st: _live(st[k], tol, st[s] if g else None),
            end, start=start)


def _segmented(Op, y, x0, solver, niter, damp, tol, epoch, checkpoint_path,
               resume, backend, guards, on_epoch, resume_state, M, normal):
    from ..resilience.elastic import maybe_start_heartbeat
    from ..resilience.status import guards_enabled
    from ..utils import deps as _deps
    # under a supervisor the epochs are what must prove liveness
    maybe_start_heartbeat()
    is_cgls = solver == "cgls"
    guards_on = guards_enabled(guards)
    E = resolve_epoch(epoch, niter)
    if x0 is None:
        x0 = _zero_like_model(Op, y)
    device = x0.device
    mode = _ca.resolve_mode(Op, solver)
    if mode == "sstep" and (is_cgls or not _ca._sstep_eligible(y, x0)):
        mode = "pipelined"
    ca_s = _deps.ca_s_default() if mode == "sstep" else None
    meta = {"niter": niter, "tol": float(tol), "guards": guards_on,
            "precond": precond_signature(M)}
    if is_cgls:
        meta["damp"] = float(damp)
    if normal:
        meta["normal"] = True
    if resume_state is not None:
        state = _check_plan(resume_state, meta, "resume_state")
    else:
        state = (_load_carry(checkpoint_path, solver, device, backend, meta)
                 if resume else None)
    if state is not None:
        _ca.check_resume_ca(state, mode, ca_s)
        if bool(state.get("normal", False)) != bool(normal):
            raise ValueError(
                f"the carry was saved with normal={bool(state.get('normal'))}"
                f", resume requested normal={bool(normal)}; resume must "
                "replay the same plan")
    resumed = state is not None
    eng = _Engine(Op, y, x0, solver, mode, niter, damp, tol, guards_on, M,
                  ca_s, normal)
    with _trace.span(f"solver.{solver}_segmented", cat="solver",
                     op=type(Op).__name__, shape=Op.shape, niter=niter,
                     epoch=E, guards=guards_on, resumed=resumed,
                     checkpoint=bool(checkpoint_path)):
        if state is None:
            state = eng.setup()
        else:
            carry = _carry_tuple(state, eng.fields, device)
            state = dict(zip(eng.fields, carry),
                         floors=_tensor(state["floors"], device))
        eng.build(state)
        epochs = _run_epochs(eng, state["floors"], solver, niter, tol, E,
                             meta, mode, ca_s, checkpoint_path, backend,
                             on_epoch)
        state = dict(zip(eng.fields, eng.loop.state),
                     floors=state["floors"])
        iiter = int(state["iiter"])
        code = _final_status(state["status"], state["kold"], tol)
        if guards_on:
            _rstatus.record(solver, code, iiter)
        cost = state["cost"][:iiter + 1]
        istop = 1 if code == _rstatus.CONVERGED else 2
        if is_cgls and mode == "off":
            r2 = state["cost1"][iiter]
        else:
            # the CA engines carry one cost lane (sqrt of the normal
            # residual's norm for cgls)
            r2 = cost[-1]
        return SegmentedResult(x=state["x"], istop=istop, iiter=iiter,
                               r1norm=state["kold"], r2norm=r2, cost=cost,
                               status=_rstatus.status_name(code),
                               epochs=epochs)


def _run_epochs(eng, floors, solver, niter, tol, E, meta, mode, ca_s,
                checkpoint_path, backend, on_epoch) -> int:
    """The epochs, each banked (in-place recovery armed), checkpointed
    and reported; returns their count."""
    from ..resilience import elastic as _elastic
    from ..utils import checkpoint as _ckpt
    ip_armed = _elastic.inplace_armed()
    epochs = 0
    while True:
        _poll_reconfig(ip_armed)
        st = dict(zip(eng.fields, eng.loop.state))
        iiter = int(st["iiter"])
        code = (_rstatus.RUNNING if st["status"] is None
                else int(st["status"]))
        kmax = float(torch.max(st["kold"]))
        # an s-step outer step that moved nothing (every lane frozen at
        # the machine floor) ends the solve, as in the fused loop
        stuck = mode == "sstep" and not bool(st["moved"])
        if (iiter >= niter or kmax <= tol or code != _rstatus.RUNNING
                or not np.isfinite(kmax) or stuck):
            return epochs
        with _on_peer_loss(ip_armed):
            out = eng.epoch(min(iiter + E, niter))
            st = dict(zip(eng.fields, out))
            epochs += 1
            if ip_armed or checkpoint_path:
                carry = {**meta, "epoch": E,
                         "schema": (_FUSED_SCHEMA if mode == "off"
                                    else _ca.CA_SCHEMA)}
                if mode != "off":
                    carry["ca"] = mode
                    if mode == "sstep":
                        carry["ca_s"] = int(ca_s)
                carry.update(st)
                carry["floors"] = floors
            if ip_armed:
                # banked before the checkpoint: an epoch the supervisor
                # can see saved is also banked, so an in-place resume is
                # never behind the disk
                _elastic.bank_carry(solver, carry)
            if checkpoint_path:
                _ckpt.save_fused_carry(checkpoint_path, solver, carry,
                                       backend=backend)
                _trace.event("solver.checkpoint", cat="resilience",
                             solver=solver, iiter=int(st["iiter"]),
                             epoch=epochs, path=checkpoint_path)
        if on_epoch is not None:
            it = int(st["iiter"])
            on_epoch({"epoch": epochs, "iiter": it,
                      "resid": float(torch.max(st["cost"][it])),
                      "status": _rstatus.status_name(
                          _rstatus.RUNNING if st["status"] is None
                          else int(torch.max(st["status"])))})


@contextlib.contextmanager
def _on_peer_loss(armed: bool):
    """An armed epoch whose collective raised (the peer died inside it)
    becomes :class:`~..resilience.elastic.ElasticReconfig` once the
    supervisor's reconfig lands (:func:`~..resilience.elastic.
    await_reconfig`); the survivor resumes from the last banked epoch.
    Anything else, or no reconfig in time, propagates as it was."""
    try:
        yield
    except RuntimeError as exc:
        if armed:
            from ..resilience import elastic as _elastic
            if not isinstance(exc, _elastic.ElasticReconfig):
                _elastic.await_reconfig(exc)
        raise


def _poll_reconfig(armed: bool) -> None:
    """At an epoch boundary of an armed solve: raise
    :class:`~..resilience.elastic.ElasticReconfig` when the supervisor
    has written this worker a shrunk world."""
    if not armed:
        return
    from ..resilience import elastic as _elastic
    rc = _elastic.pending_reconfig()
    if rc is not None:
        raise _elastic.ElasticReconfig(rc)


# ------------------------------------------------------ block CG
def block_cg_segmented(Op, y: DistributedArray,
                       x0: Optional[DistributedArray] = None,
                       niter: int = 100, tol: float = 1e-4,
                       epoch: Optional[int] = None,
                       checkpoint_path: Optional[str] = None,
                       resume: bool = True, backend: Optional[str] = None,
                       guards: Optional[bool] = None, on_epoch=None, M=None):
    """Segmented block CG (JAX ``block.py:583-``): epochs of the block
    loop with its whole ``(n, K)`` carry checkpointed between them.
    Returns ``(x, iiter, cost, status)``, ``status`` a list of the
    columns' codes."""
    from ..resilience import elastic as _elastic
    from ..resilience.elastic import maybe_start_heartbeat
    from ..resilience.status import guards_enabled, stall_window
    from ..utils import checkpoint as _ckpt
    from ..aot import graphs
    from .block import (_block_cg_graph, _block_cg_setup, _check_block,
                        _zero_block_model)
    _check_block(Op, y)
    maybe_start_heartbeat()
    K = int(y.global_shape[1])
    guards_on = guards_enabled(guards)
    E = resolve_epoch(epoch, niter)
    if x0 is None:
        x0 = _zero_block_model(Op, y)
    device = x0.device
    meta = {"niter": niter, "tol": float(tol), "guards": guards_on,
            "batch": K, "precond": precond_signature(M)}
    state = (_load_carry(checkpoint_path, "block_cg", device, backend, meta)
             if resume else None)
    fields = _BLOCK_CG_FIELDS
    with _trace.span("solver.block_cg_segmented", cat="solver",
                     op=type(Op).__name__, shape=Op.shape, batch=K,
                     niter=niter, epoch=E, guards=guards_on,
                     resumed=state is not None,
                     checkpoint=bool(checkpoint_path)):
        if state is None:
            carry, floors, _ = _block_cg_setup(Op, y, x0, niter, M,
                                               guards_on)
        else:
            carry = _carry_tuple(state, fields, device)
            floors = _tensor(state["floors"], device)
        stall_n = stall_window() if guards_on else 0
        loop = _block_cg_graph(Op, M, y, carry, floors, niter, tol,
                               guards_on, stall_n)

        def live(st):
            return _live(st[3], tol, st[7] if guards_on else None)

        ip_armed = _elastic.inplace_armed()
        epochs = 0
        while True:
            _poll_reconfig(ip_armed)
            st = dict(zip(fields, loop.state))
            iiter = int(st["iiter"])
            kold = st["kold"]
            lanes = (kold > tol) & torch.isfinite(kold)
            if guards_on:
                lanes = lanes & (st["status"] == _rstatus.RUNNING)
            if iiter >= niter or not bool(lanes.any()):
                break
            with _on_peer_loss(ip_armed):
                out = graphs.run_iterations(loop, live,
                                            min(iiter + E, niter),
                                            start=int(st["it"]))
                st = dict(zip(fields, out))
                epochs += 1
                c = {**meta, "epoch": E, "schema": _FUSED_SCHEMA, **st,
                     "floors": floors}
                if ip_armed:
                    _elastic.bank_carry("block_cg", c)
                if checkpoint_path:
                    _ckpt.save_fused_carry(checkpoint_path, "block_cg", c,
                                           backend=backend)
                    _trace.event("solver.checkpoint", cat="resilience",
                                 solver="block_cg", iiter=int(st["iiter"]),
                                 epoch=epochs, path=checkpoint_path)
            if on_epoch is not None:
                it = int(st["iiter"])
                on_epoch({"epoch": epochs, "iiter": it,
                          "resid": float(torch.max(st["cost"][it])),
                          "columns": [_rstatus.status_name(c) for c in (
                              st["status"].tolist() if guards_on
                              else [_rstatus.RUNNING] * K)]})
        st = dict(zip(fields, loop.state))
        iiter = int(st["iiter"])
        kold = st["kold"]
        codes = (st["status"] if guards_on else
                 torch.full((K,), _rstatus.RUNNING, dtype=torch.int32,
                            device=kold.device))
        final = torch.where(
            codes != _rstatus.RUNNING, codes,
            torch.where(~torch.isfinite(kold),
                        torch.full_like(codes, _rstatus.BREAKDOWN),
                        torch.where(kold <= tol,
                                    torch.full_like(codes,
                                                    _rstatus.CONVERGED),
                                    torch.full_like(codes,
                                                    _rstatus.MAXITER))))
        final = [int(c) for c in final.tolist()]
        if guards_on:
            _rstatus.record_columns("block_cg", final, iiter)
        return st["x"], iiter, st["cost"][:iiter + 1], final
