"""Structured span tracer: Chrome trace events, one JSON object a line.

PyTorch counterpart of ``pylops_mpi_tpu/diagnostics/trace.py:71-459``.
A context-manager API with nested spans, monotonic timestamps and a
thread-safe bounded buffer. Every operator apply opens an
:func:`op_span` (``matvec``, ``rmatvec`` and ``normal_matvec``), every
fused solve a ``solver.<name>`` span, and inside it the loop opens
``solver.setup``, ``solver.segment`` (one captured or eager run of
iterations), ``solver.check`` (the host's read of the loop condition)
and ``solver.readback`` (the iteration count and histories read back);
the serving layer opens a span around every packed solve and prewarm,
and records instant events for batches, drains and recoveries; the
collectives and the graph bank record events of their own.

Gating, ``PYLOPS_MPI_TPU_TORCH_TRACE``:

- ``off`` (default): every entry point returns a shared no-op after one
  environment lookup and one read of PyTorch's profiler flag.
- ``spans`` and ``full``: spans and events are recorded (the port has no
  in-loop telemetry, so ``full`` records what ``spans`` does).

**The device trace.** While a ``torch.profiler`` session records,
:func:`span` and :func:`op_span` also hold a
``torch.profiler.record_function`` range of the span's name open for
the span's lifetime, whatever the mode says, as PyTorch's own operators
appear. The profiler puts every kernel under the ranges open at its
launch, so device time and idle gaps can be put down to the program's
spans (``profile_capture`` included). The profiler's flag is read
through ``sys.modules``: this module imports only the standard library.

**The clock.** Timestamps are wall-clock microseconds (the Unix epoch),
the clock of the profiler's Chrome trace (``ts`` plus its
``baseTimeNanoseconds``), so spans, profiler ranges and kernels line up
with no fitting. They run on ``perf_counter_ns``, placed on the wall
clock by one ``(perf_counter_ns, time_ns)`` pair read at import, so a
step of the system clock cannot reorder them. :func:`dump` states the
clock in a ``ph="M"`` event named ``clock``. PyTorch launches CUDA work
asynchronously, so a span's own duration is the host's part unless the
code inside waits for the device (the serving pool's span ends after
the host copy of x, which does); the profiler's kernels give the
device's. The JAX package tags spans opened under a ``jit`` trace
(``_jax_tracing``); the port traces nothing, so it has no counterpart.

**Solves.** A ``solver.<name>`` span opened outside any other solver
span takes the next per-process ``solve`` number, and every span opened
inside it carries that number in its ``args``, so one solve's spans
share an identifier.

Events are Chrome trace-event dicts (``ph`` ``X``/``i``/``C``), dumped
one a line by :func:`dump` (or as one JSON array with
``fmt="chrome"``). With ``PYLOPS_MPI_TPU_TORCH_TRACE_FILE`` set, the
buffer is flushed there at exit and on SIGTERM, registered at the first
span entry; spans still open at the flush are written as ``ph="B"``
events, so a killed process shows the phase it died in. The buffer
holds the newest ``PYLOPS_MPI_TPU_TORCH_TRACE_BUFFER`` events (default
65536, floored at 1024).
"""

from __future__ import annotations

import itertools
import json
import os
import sys
import threading
import time
from collections import deque
from typing import Dict, List, Optional

__all__ = ["trace_mode", "trace_enabled", "span", "op_span", "event",
           "counter", "get_events", "clear_events", "dump", "span_tree",
           "open_span_events"]

_MODES = ("off", "spans", "full")
_warned_mode = False


def trace_mode() -> str:
    """``PYLOPS_MPI_TPU_TORCH_TRACE`` resolved to ``off``/``spans``/
    ``full``; an unknown value falls back to ``off`` with a one-time
    warning. Read at every call, so a test can flip it."""
    global _warned_mode
    m = os.environ.get("PYLOPS_MPI_TPU_TORCH_TRACE", "off").strip().lower()
    if m in ("", "0", "none", "default"):
        m = "off"
    if m not in _MODES:
        if not _warned_mode:
            import warnings
            warnings.warn(
                f"PYLOPS_MPI_TPU_TORCH_TRACE={m!r} is not one of {_MODES}; "
                "tracing stays off", stacklevel=2)
            _warned_mode = True
        m = "off"
    return m


def trace_enabled() -> bool:
    return trace_mode() != "off"


def _buffer_size() -> int:
    try:
        return max(1024, int(os.environ.get(
            "PYLOPS_MPI_TPU_TORCH_TRACE_BUFFER", str(1 << 16))))
    except ValueError:
        return 1 << 16


# Completed events, the oldest dropped on overflow.
_LOCK = threading.Lock()
_BUF: deque = deque(maxlen=_buffer_size())
# the monotonic counter's reading at import and the wall clock's at the
# same moment: spans run on the first, placed on the second
_PERF0_NS = time.perf_counter_ns()
_WALL0_NS = time.time_ns()
CLOCK = "unix_wall_us"
_tls = threading.local()  # per-thread stack of open spans
_atexit_registered = False
# every open span across threads (id → span), for the ph="B" flush
_OPEN: Dict[int, "_Span"] = {}
# the next solve number (a solver.<name> span outside any other)
_SOLVES = itertools.count(1)
_PROFILER = "torch.autograd.profiler"


def _now_ns() -> int:
    return time.perf_counter_ns() - _PERF0_NS + _WALL0_NS


def _now_us() -> float:
    return _now_ns() / 1e3


def _profiler():
    """PyTorch's autograd profiler module while a ``torch.profiler``
    session records, else ``None``; its own flag, read without importing
    torch."""
    prof = sys.modules.get(_PROFILER)
    if prof is not None and getattr(prof, "_is_profiler_enabled", False):
        return prof
    return None


def _enter_range(name: str):
    """A ``record_function`` range of ``name`` entered when a profiler
    session records, else ``None``."""
    prof = _profiler()
    if prof is None:
        return None
    rf = prof.record_function(name)
    rf.__enter__()
    return rf


def _jsonable(v):
    """A JSON-safe tag value: containers recurse, numpy and torch
    scalars become numbers, anything else its ``str``."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (tuple, list)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    try:
        import numpy as np
        if isinstance(v, np.integer):
            return int(v)
        if isinstance(v, (np.floating, np.number)):
            return float(v)
    except Exception:
        pass
    return str(v)


def _ensure_flush_handlers() -> None:
    """Register the exit flush (atexit and SIGTERM) once, when
    ``PYLOPS_MPI_TPU_TORCH_TRACE_FILE`` is set. The caller holds
    ``_LOCK``."""
    global _atexit_registered
    if _atexit_registered or not os.environ.get(
            "PYLOPS_MPI_TPU_TORCH_TRACE_FILE"):
        return
    import atexit
    atexit.register(_atexit_dump)
    try:  # signal handlers install from the main thread only
        import signal
        prev = signal.getsignal(signal.SIGTERM)

        def _on_sigterm(signum, frame):
            _atexit_dump()
            if callable(prev) and prev not in (signal.SIG_IGN,
                                               signal.SIG_DFL):
                prev(signum, frame)
            else:  # die with the status "killed by SIGTERM"
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                os.kill(os.getpid(), signal.SIGTERM)

        signal.signal(signal.SIGTERM, _on_sigterm)
    except (ValueError, OSError):
        pass  # not the main thread: atexit still flushes
    _atexit_registered = True


def _record(ev: Dict) -> None:
    with _LOCK:
        _BUF.append(ev)
        _ensure_flush_handlers()


def _atexit_dump() -> None:
    path = os.environ.get("PYLOPS_MPI_TPU_TORCH_TRACE_FILE")
    if path:
        try:
            dump(path)
        except Exception:
            pass  # a failed flush must not mask the exit status


class _NoopSpan:
    """The shared do-nothing span of ``TRACE=off``."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def tag(self, **tags):
        return self


_NOOP = _NoopSpan()


class _Range(_NoopSpan):
    """The span of ``TRACE=off`` while a profiler session records: its
    ``record_function`` range alone."""

    __slots__ = ("name", "_rf")

    def __init__(self, name: str):
        self.name = name
        self._rf = None

    def __enter__(self):
        self._rf = _enter_range(self.name)
        return self

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        return False


class _Span:
    """One open span; records a ``ph="X"`` event at exit with its depth,
    its parent's name and its solve's number, from which
    :func:`span_tree` rebuilds the nesting."""

    __slots__ = ("name", "args", "t0", "_t0_ns", "_depth", "_parent",
                 "_tid", "_solve", "_rf")

    def __init__(self, name: str, args: Dict):
        self.name = name
        self.args = args
        self.t0 = 0.0
        self._t0_ns = 0
        self._depth = 0
        self._parent = None
        self._tid = 0
        self._solve = None
        self._rf = None

    def tag(self, **tags) -> "_Span":
        """Attach tags learned inside the span to its event."""
        self.args.update({k: _jsonable(v) for k, v in tags.items()})
        return self

    def __enter__(self):
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        self._depth = len(stack)
        self._parent = stack[-1].name if stack else None
        self._solve = stack[-1]._solve if stack else None
        if self._solve is None and self.name.startswith("solver."):
            self._solve = next(_SOLVES)
        stack.append(self)
        self._rf = _enter_range(self.name)
        self._t0_ns = _now_ns()
        self.t0 = self._t0_ns / 1e3
        self._tid = threading.get_ident()
        with _LOCK:
            _OPEN[id(self)] = self
            _ensure_flush_handlers()
        return self

    def _args(self) -> Dict:
        args = dict(self.args)
        args["depth"] = self._depth
        if self._parent is not None:
            args["parent"] = self._parent
        if self._solve is not None:
            args["solve"] = self._solve
        return args

    def __exit__(self, *exc):
        t1_ns = _now_ns()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        stack = getattr(_tls, "stack", ())
        if stack and stack[-1] is self:
            stack.pop()
        with _LOCK:
            _OPEN.pop(id(self), None)
        args = self._args()
        _record({"name": self.name, "ph": "X", "ts": round(self.t0, 3),
                 "dur": round((t1_ns - self._t0_ns) / 1e3, 3),
                 "pid": os.getpid(), "tid": threading.get_ident(),
                 "cat": args.pop("cat", "span"), "args": args})
        return False


def span(name: str, cat: str = "span", **tags):
    """A traced span (context manager); with tracing off, a profiler
    range while a ``torch.profiler`` session records, else the shared
    no-op. ``tags`` become the event's ``args``."""
    if trace_mode() == "off":
        return _NOOP if _profiler() is None else _Range(name)
    args = {k: _jsonable(v) for k, v in tags.items()}
    args["cat"] = cat
    return _Span(name, args)


def op_span(op, which: str):
    """The span of one operator apply (JAX ``trace.py:286-304``), opened
    by ``MPILinearOperator.matvec``/``rmatvec`` as ``<class>.<which>``.
    Tags: the operator's class, shape and dtype, and its ``overlap``,
    ``schedule``, ``grid`` and ``compute_dtype`` where it has them. The
    JAX package's ``mesh_axes`` has no counterpart: the port's operators
    hold no mesh, the process group stands in for it. With tracing off
    it is what :func:`span` gives then: a profiler range while a session
    records, else the shared no-op."""
    if trace_mode() == "off":
        return _NOOP if _profiler() is None else _Range(
            f"{type(op).__name__}.{which}")
    tags = {"op": type(op).__name__, "shape": getattr(op, "shape", None),
            "dtype": getattr(op, "dtype", None)}
    for extra in ("overlap", "schedule", "grid", "compute_dtype"):
        v = getattr(op, extra, None)
        if v is not None:
            tags[extra] = v
    return span(f"{type(op).__name__}.{which}", cat="operator", **tags)


def event(name: str, cat: str = "event", **tags) -> None:
    """An instant event (``ph="i"``)."""
    if trace_mode() == "off":
        return
    _record({"name": name, "ph": "i", "s": "t", "ts": round(_now_us(), 3),
             "pid": os.getpid(), "tid": threading.get_ident(), "cat": cat,
             "args": {k: _jsonable(v) for k, v in tags.items()}})


def counter(name: str, values: Dict[str, float],
            cat: str = "telemetry") -> None:
    """A counter sample (``ph="C"``), drawn by Perfetto as a track."""
    if trace_mode() == "off":
        return
    _record({"name": name, "ph": "C", "ts": round(_now_us(), 3),
             "pid": os.getpid(), "tid": threading.get_ident(), "cat": cat,
             "args": {k: _jsonable(v) for k, v in values.items()}})


def get_events() -> List[Dict]:
    """The buffered events, oldest first."""
    with _LOCK:
        return list(_BUF)


def clear_events() -> None:
    """Drop the buffered events and forget the open spans."""
    with _LOCK:
        _BUF.clear()
        _OPEN.clear()


def open_span_events() -> List[Dict]:
    """``ph="B"`` events for every span open now, in every thread."""
    with _LOCK:
        spans = list(_OPEN.values())
    out = []
    for s in spans:
        args = s._args()
        args["open"] = True
        out.append({"name": s.name, "ph": "B", "ts": round(s.t0, 3),
                    "pid": os.getpid(), "tid": s._tid,
                    "cat": args.pop("cat", "span"), "args": args})
    out.sort(key=lambda ev: ev["ts"])
    return out


def _clock_event() -> Dict:
    """The ``ph="M"`` event that names the timestamps' clock."""
    return {"name": "clock", "ph": "M", "pid": os.getpid(), "tid": 0,
            "args": {"clock": CLOCK, "unit": "us"}}


def dump(path: str, fmt: str = "jsonl") -> int:
    """Write the clock's ``ph="M"`` event, the buffered events and the
    open spans as ``ph="B"`` events to ``path``: one object a line
    (``jsonl``) or one JSON array (``chrome``). Returns the number of
    events written."""
    events = [_clock_event()] + get_events() + open_span_events()
    if fmt == "chrome":
        with open(path, "w") as f:
            json.dump(events, f)
    elif fmt == "jsonl":
        with open(path, "w") as f:
            for ev in events:
                f.write(json.dumps(ev) + "\n")
    else:
        raise ValueError(f"fmt={fmt!r}: expected 'jsonl' or 'chrome'")
    return len(events)


def span_tree(events: Optional[List[Dict]] = None) -> List[Dict]:
    """The span nesting rebuilt from a flat event list: the roots, each
    ``{"name", "ts", "dur", "args", "children"}``. Events of one thread
    are in end-time order (a parent ends after its children), each
    carrying its depth. Entries that are not span events, or lack a
    name or timestamp, are skipped; unclosed ``ph="B"`` spans become
    nodes with ``dur=None`` that adopt the spans recorded inside them."""
    if events is None:
        events = get_events()
    roots: List[Dict] = []
    by_tid: Dict = {}
    for ev in events:
        if not isinstance(ev, dict) or ev.get("ph") not in ("X", "B"):
            continue
        if not isinstance(ev.get("name"), str) \
                or not isinstance(ev.get("ts"), (int, float)):
            continue
        by_tid.setdefault(ev.get("tid"), []).append(ev)
    for tid_events in by_tid.values():
        stack: List = []  # (depth, node) awaiting a parent
        open_chain: List = []  # (depth, node) of ph="B" spans
        for ev in tid_events:
            args = ev.get("args") if isinstance(ev.get("args"),
                                                dict) else {}
            depth = args.get("depth", 0)
            if not isinstance(depth, int) or depth < 0:
                depth = 0
            dur = ev.get("dur")
            node = {"name": ev["name"], "ts": ev["ts"],
                    "dur": dur if isinstance(dur, (int, float)) else None,
                    "args": args, "children": []}
            if ev.get("ph") == "B":
                open_chain.append((depth, node))
                continue
            while stack and stack[-1][0] > depth:
                node["children"].append(stack.pop()[1])
            node["children"].reverse()  # recorded youngest first
            if depth == 0:
                roots.append(node)
            else:
                stack.append((depth, node))
        if open_chain:
            # one thread's open spans form one chain, outermost first;
            # a closed span still awaiting a parent sat inside the
            # deepest open span shallower than it
            open_chain.sort(key=lambda p: p[0])
            for i in range(len(open_chain) - 1):
                open_chain[i][1]["children"].append(open_chain[i + 1][1])
            for d, n in stack:
                host = None
                for bd, bn in open_chain:
                    if bd < d:
                        host = bn
                (host["children"].append(n) if host is not None
                 else roots.append(n))
            stack = []
            roots.append(open_chain[0][1])
        roots.extend(n for _, n in stack)  # parents still open
    roots.sort(key=lambda n: n["ts"])
    return roots
