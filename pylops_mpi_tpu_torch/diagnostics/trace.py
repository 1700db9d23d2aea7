"""Structured span tracer: Chrome trace events, one JSON object a line.

PyTorch counterpart of ``pylops_mpi_tpu/diagnostics/trace.py:71-459``.
A context-manager API with nested spans, monotonic timestamps and a
thread-safe bounded buffer. Every operator apply opens an
:func:`op_span`, every fused solve a ``solver.<name>`` span; the serving
layer opens a span around every packed solve and prewarm, and records
instant events for batches, drains and recoveries; the collectives and
the graph bank record events of their own.

Gating, ``PYLOPS_MPI_TPU_TORCH_TRACE``:

- ``off`` (default): every entry point returns a shared no-op after one
  environment lookup.
- ``spans`` and ``full``: spans and events are recorded (the port has no
  in-loop telemetry, so ``full`` records what ``spans`` does).

Timestamps are the host's clock (``perf_counter_ns`` from process
start). PyTorch launches CUDA work asynchronously, so a span around
device work measures the host's part unless the code inside waits for
the device (the serving pool's span ends after the host copy of x,
which does). The JAX package tags spans opened under a ``jit`` trace
(``_jax_tracing``); the port traces nothing, so it has no counterpart.

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

import json
import os
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
_EPOCH_NS = time.perf_counter_ns()
_tls = threading.local()  # per-thread stack of open spans
_atexit_registered = False
# every open span across threads (id → span), for the ph="B" flush
_OPEN: Dict[int, "_Span"] = {}


def _now_us() -> float:
    return (time.perf_counter_ns() - _EPOCH_NS) / 1e3


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


class _Span:
    """One open span; records a ``ph="X"`` event at exit with its depth
    and its parent's name, from which :func:`span_tree` rebuilds the
    nesting."""

    __slots__ = ("name", "args", "t0", "_depth", "_parent", "_tid")

    def __init__(self, name: str, args: Dict):
        self.name = name
        self.args = args
        self.t0 = 0.0
        self._depth = 0
        self._parent = None
        self._tid = 0

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
        stack.append(self)
        self.t0 = _now_us()
        self._tid = threading.get_ident()
        with _LOCK:
            _OPEN[id(self)] = self
            _ensure_flush_handlers()
        return self

    def __exit__(self, *exc):
        t1 = _now_us()
        stack = getattr(_tls, "stack", ())
        if stack and stack[-1] is self:
            stack.pop()
        with _LOCK:
            _OPEN.pop(id(self), None)
        args = dict(self.args)
        args["depth"] = self._depth
        if self._parent is not None:
            args["parent"] = self._parent
        _record({"name": self.name, "ph": "X", "ts": round(self.t0, 3),
                 "dur": round(t1 - self.t0, 3), "pid": os.getpid(),
                 "tid": threading.get_ident(),
                 "cat": args.pop("cat", "span"), "args": args})
        return False


def span(name: str, cat: str = "span", **tags):
    """A traced span (context manager); a no-op when tracing is off.
    ``tags`` become the event's ``args``."""
    if trace_mode() == "off":
        return _NOOP
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
    it returns the shared no-op after one mode lookup."""
    if trace_mode() == "off":
        return _NOOP
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
        args = dict(s.args)
        args["open"] = True
        args["depth"] = s._depth
        if s._parent is not None:
            args["parent"] = s._parent
        out.append({"name": s.name, "ph": "B", "ts": round(s.t0, 3),
                    "pid": os.getpid(), "tid": s._tid,
                    "cat": args.pop("cat", "span"), "args": args})
    out.sort(key=lambda ev: ev["ts"])
    return out


def dump(path: str, fmt: str = "jsonl") -> int:
    """Write the buffered events, and the open spans as ``ph="B"``
    events, to ``path``: one object a line (``jsonl``) or one JSON
    array (``chrome``). Returns the number of events written."""
    events = get_events() + open_span_events()
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
