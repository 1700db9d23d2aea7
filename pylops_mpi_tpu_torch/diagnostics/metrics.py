"""Process-wide metrics: counters, gauges and histograms.

PyTorch counterpart of ``pylops_mpi_tpu/diagnostics/metrics.py:70-355``.
Spans say what one process did and when; this registry says how much so
far, in a form another process can read while this one runs. The
solvers count solves and iterations, the guards their verdicts, the
serving layer its requests, batches, rejects, queue waits and fill, the
retry loop its retries.

Gating, ``PYLOPS_MPI_TPU_TORCH_METRICS``: ``off`` (default) returns from
every entry point after one environment lookup; ``on`` records (one
lock and a dict operation each). Unknown values warn once and stay off.
Every record is made on the host after the device work it counts, so
the registry adds no device synchronisation.

:func:`snapshot` returns the registry as one JSON-safe dict. With
``PYLOPS_MPI_TPU_TORCH_METRICS_FILE`` set, a daemon thread started at the
first record writes it there every ``PYLOPS_MPI_TPU_TORCH_METRICS_INTERVAL``
seconds (default 5, floored at 0.05), atomically (a pid-suffixed
temporary file and ``os.replace``), and once more at exit. The module
imports only the standard library.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

__all__ = ["metrics_mode", "metrics_enabled", "metrics_file",
           "metrics_interval", "inc", "collective_bytes", "set_gauge",
           "observe", "timer", "quantiles", "hist_quantiles", "snapshot",
           "clear_metrics", "add_counters", "write_snapshot",
           "read_snapshot",
           "SNAPSHOT_SCHEMA"]

SNAPSHOT_SCHEMA = 1

_MODES = ("off", "on")
_warned_mode = False


def metrics_mode() -> str:
    """``PYLOPS_MPI_TPU_TORCH_METRICS`` resolved to ``off``/``on``
    (``1``/``true`` count as on; unknown values warn once and stay
    off)."""
    global _warned_mode
    m = os.environ.get("PYLOPS_MPI_TPU_TORCH_METRICS",
                       "off").strip().lower()
    if m in ("", "0", "none", "default", "false"):
        m = "off"
    if m in ("1", "true"):
        m = "on"
    if m not in _MODES:
        if not _warned_mode:
            import warnings
            warnings.warn(
                f"PYLOPS_MPI_TPU_TORCH_METRICS={m!r} is not one of "
                f"{_MODES}; metrics stay off", stacklevel=2)
            _warned_mode = True
        m = "off"
    return m


def metrics_enabled() -> bool:
    return metrics_mode() == "on"


def metrics_file() -> Optional[str]:
    """``PYLOPS_MPI_TPU_TORCH_METRICS_FILE``, the periodic snapshot's
    path, or ``None``."""
    return os.environ.get("PYLOPS_MPI_TPU_TORCH_METRICS_FILE") or None


def metrics_interval() -> float:
    """``PYLOPS_MPI_TPU_TORCH_METRICS_INTERVAL`` in seconds (default
    5.0, floored at 0.05)."""
    try:
        v = float(os.environ.get("PYLOPS_MPI_TPU_TORCH_METRICS_INTERVAL",
                                 "5.0"))
    except ValueError:
        v = 5.0
    return max(0.05, v)


_LOCK = threading.Lock()
_COUNTERS: Dict[str, float] = {}
_GAUGES: Dict[str, float] = {}
# five-number summaries (count, sum, min, max, last): a snapshot stays
# the size of the registry, never of the samples
_HISTS: Dict[str, Dict[str, float]] = {}
# the newest raw samples of each histogram, kept out of the snapshot,
# for the serving report's p50/p99
_HSAMPLES: Dict[str, "deque"] = {}
_HSAMPLES_MAX = 512


def inc(name: str, value: float = 1) -> None:
    """Add ``value`` to counter ``name``."""
    if metrics_mode() == "off":
        return
    with _LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + value
    _maybe_start_writer()


def collective_bytes(name: str, nbytes: float,
                     fabric: Optional[str] = None) -> None:
    """Bytes moved by collective ``name`` (JAX ``metrics.py:141-160``):
    ``collective.{name}.bytes`` keeps every byte, and when a fabric is
    named (``parallel/topology.py``: ``"nvlink"`` within a host, ``"ib"``
    across hosts, the JAX package's ``ici``/``dcn``) the same bytes also
    land in ``.bytes_nvlink``/``.bytes_ib``; a flat world names none and
    adds no counter (the JAX names ``"ici"``/``"dcn"`` are counted under
    their own names, as the JAX registry counts them). Host↔device
    staging (``fabric="h2d"``/``"d2h"``, the spill tier's copies) lands
    only in ``.bytes_h2d``/``.bytes_d2h``: it is not payload between
    devices."""
    if metrics_mode() == "off":
        return
    if fabric in ("h2d", "d2h"):
        inc(f"collective.{name}.bytes_{fabric}", nbytes)
        return
    inc(f"collective.{name}.bytes", nbytes)
    if fabric in ("nvlink", "ib", "ici", "dcn"):
        inc(f"collective.{name}.bytes_{fabric}", nbytes)


def set_gauge(name: str, value: float) -> None:
    """Set gauge ``name`` (the last write wins)."""
    if metrics_mode() == "off":
        return
    with _LOCK:
        _GAUGES[name] = value
    _maybe_start_writer()


def observe(name: str, value: float) -> None:
    """Add one sample to histogram ``name``."""
    if metrics_mode() == "off":
        return
    value = float(value)
    with _LOCK:
        h = _HISTS.get(name)
        if h is None:
            _HISTS[name] = {"count": 1, "sum": value, "min": value,
                            "max": value, "last": value}
        else:
            h["count"] += 1
            h["sum"] += value
            h["min"] = min(h["min"], value)
            h["max"] = max(h["max"], value)
            h["last"] = value
        ring = _HSAMPLES.get(name)
        if ring is None:
            ring = _HSAMPLES[name] = deque(maxlen=_HSAMPLES_MAX)
        ring.append(value)
    _maybe_start_writer()


def quantiles(samples: Sequence[float], qs: Sequence[float] = (0.5, 0.99)
              ) -> List[float]:
    """Nearest-rank quantiles of ``samples`` (0.0 each when empty)."""
    s = sorted(samples)
    if not s:
        return [0.0 for _ in qs]
    n = len(s)
    return [s[min(n - 1, max(0, int(round(min(1.0, max(0.0, float(q)))
                                          * (n - 1)))))] for q in qs]


def hist_quantiles(name: str, qs: Sequence[float] = (0.5, 0.99)
                   ) -> Optional[Dict[str, float]]:
    """Nearest-rank quantiles of histogram ``name``'s newest 512
    samples, ``{"p50": ..., "p99": ...}`` by default; ``None`` when it
    has none (or metrics are off)."""
    with _LOCK:
        ring = _HSAMPLES.get(name)
        samples = list(ring) if ring else None
    if not samples:
        return None
    return {f"p{min(1.0, max(0.0, float(q))) * 100:g}": v
            for q, v in zip(qs, quantiles(samples, qs))}


class _Timer:
    __slots__ = ("name", "t0")

    def __init__(self, name: str):
        self.name = name
        self.t0 = 0.0

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        observe(self.name + ".wall_s", time.perf_counter() - self.t0)
        return False


class _NoopTimer:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP_TIMER = _NoopTimer()


def timer(name: str):
    """Context manager adding the block's host wall time to histogram
    ``<name>.wall_s`` (a shared no-op when metrics are off)."""
    if metrics_mode() == "off":
        return _NOOP_TIMER
    return _Timer(name)


def snapshot() -> Dict:
    """The registry: ``{"schema", "pid", "wall", "counters", "gauges",
    "histograms"}``."""
    with _LOCK:
        return {"schema": SNAPSHOT_SCHEMA, "pid": os.getpid(),
                "wall": time.time(),
                "counters": dict(_COUNTERS),
                "gauges": dict(_GAUGES),
                "histograms": {k: dict(v) for k, v in _HISTS.items()}}


def add_counters(values: Dict[str, float]) -> None:
    """Add each of ``values`` to its counter and drop a counter that
    comes to 0: how the graph bank takes back what a capture counted and
    counts what its replays do (``aot/graphs.py``)."""
    if metrics_mode() == "off" or not values:
        return
    with _LOCK:
        for k, v in values.items():
            n = _COUNTERS.get(k, 0) + v
            if n:
                _COUNTERS[k] = n
            else:
                _COUNTERS.pop(k, None)
    _maybe_start_writer()


def clear_metrics() -> None:
    """Drop every recorded value (a running writer thread goes on
    writing the empty registry)."""
    with _LOCK:
        _COUNTERS.clear()
        _GAUGES.clear()
        _HISTS.clear()
        _HSAMPLES.clear()


def write_snapshot(path: Optional[str] = None) -> Optional[str]:
    """Write :func:`snapshot` to ``path`` (default :func:`metrics_file`)
    atomically; returns the path, or ``None`` when none is set or the
    write failed (a failed write never raises)."""
    path = path or metrics_file()
    if not path:
        return None
    path = os.path.abspath(path)
    tmp = path + f".tmp{os.getpid()}"
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(snapshot(), f)
        os.replace(tmp, path)
        return path
    except OSError:
        try:
            if os.path.exists(tmp):
                os.remove(tmp)
        except OSError:
            pass
        return None


def read_snapshot(path: str) -> Optional[Dict]:
    """A snapshot file's dict, or ``None`` when it is missing,
    unparseable or not a snapshot."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict) or "counters" not in doc:
        return None
    return doc


_WRITER_LOCK = threading.Lock()
_writer_started = False


def _maybe_start_writer() -> None:
    """Start the periodic writer thread once, when a snapshot file is
    set."""
    global _writer_started
    if _writer_started or not metrics_file():
        return
    with _WRITER_LOCK:
        if _writer_started:
            return
        _writer_started = True
        import atexit
        atexit.register(write_snapshot)

        def loop():
            while True:
                time.sleep(metrics_interval())
                write_snapshot()

        threading.Thread(target=loop, daemon=True,
                         name="pylops-torch-metrics").start()
    write_snapshot()  # the first snapshot at once
