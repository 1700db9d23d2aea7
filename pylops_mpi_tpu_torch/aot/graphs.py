"""The bank of captured loops: each fused solve as CUDA graphs.

PyTorch counterpart of ``pylops_mpi_tpu/aot/executable.py`` and of the
fused-program cache ``_FUSED_CACHE`` (``solvers/basic.py:758-830``). The
JAX package compiles a fused solver loop once, as one XLA program, and
replays it; here the solver loops are Python loops that launch every
elementwise op and reduction from the host, and the host reads the
device once a *segment* (the iterations between two host checks). With
``PYLOPS_MPI_TPU_TORCH_AOT=on`` (:func:`~.store.aot_enabled`) a segment
is captured once as a ``torch.cuda.CUDAGraph`` and replayed:

1. the loop's first segment runs eagerly: it warms the kernels' plans
   and attributes, the library handles and the caching allocator;
2. the segment is then captured once, on a side stream, into static
   buffers holding the loop's carry; its last ops copy its outputs into
   those buffers, so replays chain;
3. replays run until the host check says stop; the iterations that do
   not fill a segment (the ``niter`` tail, a loop's odd first segment)
   run eagerly, with the same ops;
4. the carry is cloned out of the static buffers before it is returned.

A captured program computes exactly what the eager segment does, so a
solve through the bank gives the eager loop's result bit for bit, and
the early exit falls at the same iteration.

**The key** (:func:`key`) is everything the captured program bakes in:
the solver and its schedule, the Python scalars that enter its kernels,
the ``id`` of the operator and of the preconditioner (a segment runs
their methods, with whatever Python scalars they hold: a derivative's
sampling, kind and edge, a scaled operator's factor), their
``op_signature`` and ``storage_signature`` (a graph holds their tensors'
addresses, and a tensor attribute swapped on the same object changes
them), the operator's ``schedule_signature`` (its resolved overlap and
chunk count), ``compile_signature()``, the reduction stall
(``collectives.stall_signature``) and the telemetry state
(``telemetry.telemetry_signature``), the shapes, dtypes and devices of
the data and of the carry, the segment length and the process group's
size and backend. The bank keeps the operator and the preconditioner alive
(the JAX package's ``keepalive``), so neither an ``id`` nor a freed
address is reused under an old key. A write in place to an operator's
tensor keeps its address: the next replay reads the new values, as the
eager loop would.

**Telemetry.** A loop given a ``record`` :class:`~..diagnostics.
telemetry.Spec` while telemetry is on carries one more tensor, the
telemetry buffer its steps write through
:func:`~..diagnostics.telemetry.iteration`; it rides in the captured
carry like the cost rows. :meth:`Loop.fold` copies the rows recorded
since the last fold to the host at each host check and at the end.

**What a capture records once.** The launch and path counters
(``normal_kernels.launches`` and ``.launches_by_dtype``,
``stencil_kernels.launches``,
``derivatives.paths``, ``collectives.counts``/``received`` and the
registry's ``collective.*`` counters) move in Python, which a capture
runs once without computing and a replay does not run. The bank takes
the capture's deltas back off them after the capture and adds them at
every replay, so a run through the bank reports the eager run's counts.
The deltas are read process-wide: what another thread counts during a
capture is added back at once but also counted at every replay (the
serving daemon solves on its one dispatcher thread). Spans opened
inside a segment are recorded at capture only, as the JAX package
records ``op_span`` once at trace time; the ``solver.segment`` and
``solver.check`` spans around them (:func:`run_iterations`) are opened
at every segment, replayed or not.

**Eligibility** is decided before any capture: the carry on CUDA, and no
gloo group (gloo stages CUDA tensors through the host, which a graph
cannot hold). Anything else runs eagerly and is counted under
``aot.graph.eager`` with its reason (``cpu``, ``gloo``); so is an
eligible solve that never reached a capture (``short``: no full segment
after the first fits in ``niter``; ``stopped``: the loop ended at a host
check before its capture). A capture or replay that fails raises:
nothing falls back quietly.

Metrics (``PYLOPS_MPI_TPU_TORCH_METRICS``): ``aot.graph.captures``,
``.hits``, ``.replays``, ``.eager`` and ``.eager.<reason>``, each with a
trace event, and the gauge ``aot.graph.bank_bytes``. :func:`stats`
holds the same counts whatever the metrics knob says.
"""

from __future__ import annotations

import threading
import time
from collections import Counter
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from ..diagnostics import metrics as _metrics
from ..diagnostics import trace as _trace
from . import store as _store

__all__ = ["SEGMENT", "capture_count", "reset_capture_count", "stats",
           "bank_bytes", "capturing", "recording_keys", "key", "Loop",
           "run_iterations", "run_while"]

# iterations between two host checks: one captured segment
SEGMENT = 8

_STATS: Counter = Counter()
_STATS_LOCK = threading.Lock()
_tls = threading.local()
_SIDE_STREAMS: Dict[Any, Any] = {}


def capture_count() -> int:
    """Captures made in this process since the last reset (the
    counterpart of ``compile_count``; replays do not count)."""
    return _STATS["captures"]


def reset_capture_count() -> None:
    """Zero :func:`capture_count` and the other :func:`stats`."""
    with _STATS_LOCK:
        _STATS.clear()


def stats() -> Dict[str, int]:
    """``captures``, ``hits``, ``replays``, ``eager`` and
    ``eager.<reason>`` since the last reset."""
    with _STATS_LOCK:
        return dict(_STATS)


def _bump(name: str, n: int = 1, **tags) -> None:
    with _STATS_LOCK:
        _STATS[name] += n
    _metrics.inc(f"aot.graph.{name}", n)
    if "." not in name:
        _trace.event(f"aot.graph.{name}", cat="aot", n=n, **tags)


def bank_bytes() -> int:
    """Device bytes the banked entries hold: their static buffers and
    what the caching allocator reserved while each was captured."""
    return sum(e.nbytes for e in _store.mem_entries())


@contextmanager
def capturing():
    """Within this block, an eligible loop that reached no capture
    captures its segment after its first one all the same (where a full
    segment fits in ``niter``), then stops: the prewarm of a serving
    bucket, whose zero-RHS solve ends at its first host check."""
    prev = getattr(_tls, "force", False)
    _tls.force = True
    try:
        yield
    finally:
        _tls.force = prev


@contextmanager
def recording_keys():
    """Yield a list that collects the keys this thread's loops hit or
    capture within the block: the serving pool's prewarm ledger."""
    prev = getattr(_tls, "keys", None)
    _tls.keys = keys = []
    try:
        yield keys
    finally:
        _tls.keys = prev


def _note(k: tuple) -> None:
    keys = getattr(_tls, "keys", None)
    if keys is not None:
        keys.append(k)


# ------------------------------------------------------ the carry
def _flat(obj, out: Optional[List] = None) -> List[torch.Tensor]:
    """The tensors of a carry: tensors, (stacked) distributed vectors and
    tuples of them, in order; ``None`` holds nothing."""
    from ..distributedarray import DistributedArray
    from ..stacked import StackedDistributedArray
    out = [] if out is None else out
    if obj is None:
        pass
    elif isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, DistributedArray):
        out.append(obj.array)
    elif isinstance(obj, StackedDistributedArray):
        for d in obj.distarrays:
            _flat(d, out)
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            _flat(v, out)
    else:
        raise TypeError(f"a solver carry holds tensors and distributed "
                        f"vectors, not {type(obj).__name__}")
    return out


def _rebuild(template, tensors):
    """``template``'s structure over the next tensors of ``tensors``."""
    from ..distributedarray import DistributedArray
    from ..stacked import StackedDistributedArray
    if template is None:
        return None
    if isinstance(template, torch.Tensor):
        return next(tensors)
    if isinstance(template, DistributedArray):
        return DistributedArray._wrap(next(tensors), template)
    if isinstance(template, StackedDistributedArray):
        return StackedDistributedArray([_rebuild(d, tensors)
                                        for d in template.distarrays])
    return type(template)(_rebuild(v, tensors) for v in template)


def _specs(tensors: Sequence[torch.Tensor]):
    return tuple((tuple(t.shape), str(t.dtype), str(t.device))
                 for t in tensors)


def _freeze(v):
    if isinstance(v, dict):
        return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    return v


def _group():
    from ..parallel.mesh import initialized, world_size
    if not initialized():
        return (1, None)
    import torch.distributed as dist
    return (world_size(), str(dist.get_backend()))


def key(solver: str, scalars: Dict[str, Any], Op, M, y,
        carry: Sequence[torch.Tensor]) -> tuple:
    """The bank key of one loop (module docstring)."""
    from ..diagnostics.telemetry import telemetry_signature
    from ..parallel.collectives import stall_signature
    from .signature import (compile_signature, op_signature,
                            schedule_signature, storage_signature)
    return (solver, _freeze(scalars),
            id(Op), op_signature(Op), storage_signature(Op),
            schedule_signature(Op),
            None if M is None else (id(M), op_signature(M),
                                    storage_signature(M)),
            _freeze(compile_signature()), stall_signature(),
            telemetry_signature(), _specs(_flat(y)), _specs(carry),
            SEGMENT, _group())


def _ineligible(tensors: Sequence[torch.Tensor]) -> Optional[str]:
    """Why a loop over these tensors cannot be captured, or ``None``."""
    if not all(t.is_cuda for t in tensors):
        return "cpu"
    from ..parallel.mesh import initialized
    if initialized():
        import torch.distributed as dist
        if dist.get_backend() == "gloo":
            return "gloo"
    return None


# ------------------------------------------------------ the counters
def _counters() -> Dict[str, Any]:
    """Every count a segment's Python code moves (module docstring)."""
    from ..ops import derivatives, normal_kernels, stencil_kernels
    from ..parallel import collectives
    reg = _metrics.snapshot()["counters"]
    return {"normal": normal_kernels.launches,
            "normal_dtype": Counter(normal_kernels.launches_by_dtype),
            "stencil": stencil_kernels.launches,
            "paths": Counter(derivatives.paths),
            "counts": Counter(collectives.counts),
            "received": Counter(collectives.received),
            "metrics": {k: v for k, v in reg.items()
                        if k.startswith("collective.")}}


def _delta(before: Dict[str, Any], after: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, b in before.items():
        a = after[k]
        if isinstance(b, dict):
            out[k] = {n: a.get(n, 0) - b.get(n, 0) for n in set(a) | set(b)
                      if a.get(n, 0) != b.get(n, 0)}
        else:
            out[k] = a - b
    return out


def _add(delta: Dict[str, Any], times: int) -> None:
    """Add ``times`` replays' worth of a capture's ``delta`` (``-1``
    takes the capture's own counts back off); a count that comes to 0 is
    dropped, as if never counted."""
    from ..ops import derivatives, normal_kernels, stencil_kernels
    from ..parallel import collectives
    normal_kernels.launches += delta["normal"] * times
    stencil_kernels.launches += delta["stencil"] * times
    for name, c in (("normal_dtype", normal_kernels.launches_by_dtype),
                    ("paths", derivatives.paths),
                    ("counts", collectives.counts),
                    ("received", collectives.received)):
        for k, v in delta[name].items():
            c[k] += v * times
            if not c[k]:
                del c[k]
    _metrics.add_counters({k: v * times for k, v in delta["metrics"].items()})


# ------------------------------------------------------ capture seam
class _CudaGraph:
    """``body`` captured as one ``torch.cuda.CUDAGraph`` on a side
    stream of ``device`` (one per device, reused), in the thread-local
    error mode: other threads may allocate and copy meanwhile. A failed
    capture raises its own error. ``buffers`` are the static tensors
    the body reads and writes; a capture computes nothing, so it leaves
    them as they are."""

    def __init__(self, body: Callable[[], None], device: torch.device,
                 buffers: Sequence[torch.Tensor]):
        g = torch.cuda.CUDAGraph()
        side = _SIDE_STREAMS.get(device)
        if side is None:
            side = _SIDE_STREAMS[device] = torch.cuda.Stream(device=device)
        current = torch.cuda.current_stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            g.capture_begin(capture_error_mode="thread_local")
            try:
                body()
            except BaseException:
                try:
                    g.capture_end()
                except RuntimeError:
                    pass  # the capture was invalidated; raise its cause
                raise
            g.capture_end()
        current.wait_stream(side)
        self._graph = g

    def replay(self) -> None:
        self._graph.replay()


class _Entry:
    """One banked segment: its graph, static buffers, counter deltas,
    device bytes, capture milliseconds and the objects it keeps alive;
    ``lock`` is held by the solve using it."""

    __slots__ = ("graph", "state", "consts", "delta", "nbytes", "ms",
                 "keepalive", "lock")

    def __init__(self, graph, state, consts, delta, nbytes, ms, keepalive):
        self.graph = graph
        self.state = state
        self.consts = consts
        self.delta = delta
        self.nbytes = nbytes
        self.ms = ms
        self.keepalive = keepalive
        self.lock = threading.Lock()


def _overlaps(t: torch.Tensor, bufs: Sequence[torch.Tensor]) -> bool:
    p = t.untyped_storage().data_ptr()
    return any(p == b.untyped_storage().data_ptr() for b in bufs)


# ------------------------------------------------------ the loop
class Loop:
    """One fused loop's carry (``state``, updated by its steps) and
    read-only inputs (``consts``), run segment by segment through the
    bank when the tier is armed and the loop is eligible, else eagerly.

    ``step(state, consts)`` runs one iteration and returns the new
    carry; a segment is ``per_segment`` of them. ``solver``,
    ``scalars``, ``Op``, ``M`` and ``y`` make the key. ``record`` (a
    telemetry :class:`~..diagnostics.telemetry.Spec`) arms the loop's
    telemetry buffer when telemetry is on. Drive it with
    :func:`run_iterations` or :func:`run_while`."""

    def __init__(self, solver: str, scalars: Dict[str, Any], Op, M, y,
                 state, consts, step: Callable, per_segment: int = SEGMENT,
                 record=None):
        from ..diagnostics import telemetry
        self.solver = solver
        self.per_segment = per_segment
        self.state = state
        self.consts = consts
        self._spec = record if (record is not None
                                and telemetry.telemetry_enabled()) else None
        self._tbuf = None
        self._folded = 0
        if self._spec is not None:
            self._tbuf = self._spec.buffer(_flat(state)[0].device)

            def tstep(carry, cs):
                st, tb = carry
                with telemetry.recording(tb):
                    return step(st, cs), tb
            self._step = tstep
        else:
            self._step = step
        inner = self._step

        def segment(st, cs):
            for _ in range(per_segment):
                st = inner(st, cs)
            return st

        self._segment = segment
        self._entry: Optional[_Entry] = None
        self._in_bufs = False
        self._warm = False
        self._replays = 0
        self._armed = False
        self._looked = False
        # set by run_iterations/run_while: a full segment fits in the
        # loop (a forced capture is possible); the loop ended at a check
        self._capturable = False
        self._stopped = False
        if not _store.aot_enabled():
            return
        self._key = lambda: key(solver, scalars, Op, M, y,
                                _flat(self._carry()) + _flat(self.consts))
        self._keepalive = (Op, M)
        reason = _ineligible(_flat(self._carry()) + _flat(consts))
        if reason is not None:
            _bump("eager", solver=solver, reason=reason)
            _bump(f"eager.{reason}")
            return
        self._armed = True

    # -- the carry: the state, and the telemetry buffer when recording
    def _carry(self):
        return self.state if self._tbuf is None else (self.state,
                                                      self._tbuf)

    def _set_carry(self, carry) -> None:
        if self._tbuf is None:
            self.state = carry
        else:
            self.state, self._tbuf = carry

    def peel(self, fn: Callable) -> None:
        """``state = fn(state)`` with the loop's telemetry recording: a
        step run outside the loop (the pipelined engine's iteration
        0)."""
        if self._tbuf is None:
            self.state = fn(self.state)
            return
        from ..diagnostics import telemetry
        with telemetry.recording(self._tbuf):
            self.state = fn(self.state)

    def fold(self, upto: Optional[int] = None) -> None:
        """Hand the telemetry rows recorded since the last fold, up to
        row ``upto`` (default: the last iteration row), to the history
        (:func:`~..diagnostics.telemetry.fold`): one small copy to the
        host, made where the loop reads the device anyway."""
        if self._tbuf is None:
            return
        from ..diagnostics import telemetry
        last = self._tbuf.shape[0] - 2 if upto is None \
            else min(int(upto), self._tbuf.shape[0] - 2)
        if last <= self._folded:
            return
        block = self._tbuf[self._folded + 1:last + 1].cpu().numpy()
        self._folded = last
        telemetry.fold(self._spec, block)

    def _take(self, entry: _Entry, k: tuple) -> None:
        entry.lock.acquire()
        self._entry = entry
        _note(k)
        _bump("hits", solver=self.solver)

    # -- running
    def eager(self, n: int) -> None:
        """``n`` iterations, eagerly."""
        for _ in range(n):
            self._set_carry(self._step(self._carry(), self.consts))
        self._in_bufs = False
        self._warm = True

    def segment(self) -> None:
        """One full segment: a replay when banked, else eagerly (the
        first) or captured and replayed (the next)."""
        if self._entry is None and self._armed:
            if not self._looked:
                self._looked = True
                k = self._key()
                entry = _store.mem_get(k)
                if entry is not None:
                    self._take(entry, k)
            if self._entry is None and self._warm:
                self._capture()
        if self._entry is None:
            self._set_carry(self._segment(self._carry(), self.consts))
            self._in_bufs = False
            self._warm = True
            return
        if not self._in_bufs:
            e = self._entry
            for b, t in zip(e.state + e.consts,
                            _flat(self._carry()) + _flat(self.consts)):
                if b is not t:
                    b.copy_(t)
            self._set_carry(_rebuild(self._carry(), iter(e.state)))
            self._in_bufs = True
        self._entry.graph.replay()
        _add(self._entry.delta, 1)
        self._replays += 1

    def _capture(self) -> None:
        k = self._key()  # again: the first segment may have built caches
        entry = _store.mem_get(k)
        if entry is not None:
            self._take(entry, k)
            return
        flat_s, flat_c = _flat(self._carry()), _flat(self.consts)
        device = flat_s[0].device
        bufs_s = [t.clone() for t in flat_s]
        bufs_c = [t.clone() for t in flat_c]
        tmpl_s, tmpl_c, seg = self._carry(), self.consts, self._segment

        def body():
            out = _flat(seg(_rebuild(tmpl_s, iter(bufs_s)),
                            _rebuild(tmpl_c, iter(bufs_c))))
            if _specs(out) != _specs(bufs_s):
                raise RuntimeError(f"{self.solver}: a segment changed its "
                                   "carry's shapes or dtypes")
            srcs = [o if o is b or not _overlaps(o, bufs_s) else o.clone()
                    for o, b in zip(out, bufs_s)]
            for b, o in zip(bufs_s, srcs):
                if o is not b:
                    b.copy_(o)

        snap = _counters()
        reserved = _reserved(device)
        t0 = time.perf_counter()
        try:
            graph = _CudaGraph(body, device, bufs_s + bufs_c)
        finally:
            delta = _delta(snap, _counters())
            _add(delta, -1)
        ms = (time.perf_counter() - t0) * 1e3
        nbytes = (_reserved(device) - reserved
                  + sum(t.numel() * t.element_size()
                        for t in bufs_s + bufs_c))
        entry = _Entry(graph, bufs_s, bufs_c, delta, nbytes, ms,
                       self._keepalive)
        entry.lock.acquire()
        _store.mem_put(k, entry)
        _note(k)
        self._entry = entry
        self._set_carry(_rebuild(tmpl_s, iter(bufs_s)))
        self._in_bufs = True
        _bump("captures", solver=self.solver, ms=ms, bytes=nbytes)
        _metrics.set_gauge("aot.graph.bank_bytes", bank_bytes())

    def result(self):
        """The final carry, cloned out of the bank's buffers; records the
        solve's replays (or its eager reason) and releases the entry."""
        if self._entry is None and self._armed and self._warm \
                and getattr(_tls, "force", False) and self._capturable:
            self._capture()
        if self._armed and self._entry is None:
            reason = "stopped" if self._stopped else "short"
            _bump("eager", solver=self.solver, reason=reason)
            _bump(f"eager.{reason}")
        out = self._carry()
        if self._in_bufs:
            out = _rebuild(out, iter([t.clone() for t in _flat(out)]))
            # a later run of this loop (the next epoch of a segmented
            # solve) copies its carry back in: another solve may have
            # replayed the entry meanwhile
            self._set_carry(out)
            self._in_bufs = False
        self.fold()
        self._release()
        return self.state

    def _release(self) -> None:
        if self._entry is not None:
            if self._replays:
                _bump("replays", self._replays, solver=self.solver)
                self._replays = 0
            self._entry.lock.release()
            self._entry = None


def _reserved(device) -> int:
    return torch.cuda.memory_reserved(device) if device.type == "cuda" else 0


def _check(loop: Loop, live: Callable, it: int) -> bool:
    """The host check ``live(state)`` under a ``solver.check`` span: the
    host waits there for the device's last segment."""
    with _trace.span("solver.check", cat="solver", solver=loop.solver,
                     it=it):
        return bool(live(loop.state))


def _segment(loop: Loop, it: int, iters: int, full: bool = True) -> None:
    """``iters`` iterations from ``it`` under a ``solver.segment`` span,
    tagged with how they ran: a full segment through :meth:`Loop.segment`,
    else eagerly."""
    with _trace.span("solver.segment", cat="solver", solver=loop.solver,
                     it=it, iters=iters) as sp:
        if full:
            loop.segment()
        else:
            loop.eager(iters)
        sp.tag(graph="replayed" if full and loop._entry is not None
               else "eager")


def run_iterations(loop: Loop, live: Callable, niter: int, start: int = 0):
    """Iterations ``[start, niter)`` of the loop's step, with the
    host check ``live(state)`` before every iteration ``it > start``
    that is a multiple of :data:`SEGMENT` (the eager loops' order).
    Full aligned segments go through :meth:`Loop.segment`; the odd first
    one and the tail run eagerly, each under a ``solver.segment`` span.
    Returns :meth:`Loop.result`."""
    loop._capturable = -(-start // SEGMENT) * SEGMENT + SEGMENT <= niter
    try:
        it = start
        while it < niter:
            end = min(niter, (it // SEGMENT + 1) * SEGMENT)
            if it > start:
                if not _check(loop, live, it):
                    loop._stopped = True
                    break
                loop.fold(it)
            _segment(loop, it, end - it, full=end - it == SEGMENT)
            it = end
        return loop.result()
    finally:
        loop._release()


def run_while(loop: Loop, live: Callable):
    """Segments while ``live(state)`` holds, checked before each (the
    s-step engine's outer steps). Returns :meth:`Loop.result`."""
    loop._capturable = loop._stopped = True
    try:
        it = 0
        while _check(loop, live, it):
            _segment(loop, it, loop.per_segment)
            it += loop.per_segment
        return loop.result()
    finally:
        loop._release()
