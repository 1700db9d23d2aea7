"""A serving worker's side of supervision: heartbeats and the drain.

PyTorch counterpart of the serving half of
``pylops_mpi_tpu/resilience/elastic.py`` (the heartbeat, ``:76-192``, and
the drain, ``:318-375``). The collective watchdog, in-place
reconfiguration and the carry bank are ROADMAP.md §A.7, with the
supervisor.

- **Heartbeats**: a daemon thread writes ``{"pid", "seq", "wall",
  "mono"}`` (and ``"metrics"``, the registry's snapshot, when
  ``PYLOPS_MPI_TPU_TORCH_METRICS=on``) to
  ``PYLOPS_MPI_TPU_TORCH_HEARTBEAT_FILE`` every
  ``PYLOPS_MPI_TPU_TORCH_HEARTBEAT`` seconds (default 1.0, floored at
  0.05), atomically. The thread beats while the main thread waits on
  the device, so a beat stops only when the process is wedged or dead.
- **The drain**: SIGTERM, or :func:`request_drain`, asks the serving
  loops to finish what they hold, stop claiming and return.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Optional

from ..diagnostics import metrics as _metrics
from ..diagnostics import trace as _trace

__all__ = ["heartbeat_interval", "heartbeat_file", "HeartbeatWriter",
           "start_heartbeat", "stop_heartbeat", "maybe_start_heartbeat",
           "read_heartbeat", "request_drain", "drain_requested",
           "reset_drain", "install_sigterm_drain"]


def heartbeat_interval() -> float:
    """``PYLOPS_MPI_TPU_TORCH_HEARTBEAT`` in seconds (default 1.0,
    floored at 0.05)."""
    try:
        v = float(os.environ.get("PYLOPS_MPI_TPU_TORCH_HEARTBEAT", "1.0"))
    except ValueError:
        v = 1.0
    return max(0.05, v)


def heartbeat_file() -> Optional[str]:
    """``PYLOPS_MPI_TPU_TORCH_HEARTBEAT_FILE``, or ``None`` when the
    process is not supervised."""
    return os.environ.get("PYLOPS_MPI_TPU_TORCH_HEARTBEAT_FILE") or None


class HeartbeatWriter(threading.Thread):
    """The daemon thread that writes beats to ``path`` every
    ``interval`` seconds; :meth:`stop` is idempotent and joins it."""

    def __init__(self, path: str, interval: float):
        super().__init__(name="pylops-torch-heartbeat", daemon=True)
        self.path = os.path.abspath(path)
        self.interval = float(interval)
        self.seq = 0
        # not _stop: Thread.join calls a private self._stop()
        self._halt = threading.Event()

    def beat(self) -> None:
        self.seq += 1
        doc = {"pid": os.getpid(), "seq": self.seq,
               "wall": time.time(), "mono": time.monotonic()}
        if _metrics.metrics_enabled():
            try:
                doc["metrics"] = _metrics.snapshot()
            except Exception:
                pass  # a metrics fault must not stop the beat
        tmp = self.path + f".tmp{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                f.write(json.dumps(doc))
            os.replace(tmp, self.path)
        except OSError:
            pass  # a full disk must not kill the worker through its beat

    def run(self) -> None:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self.beat()  # the first beat at once
        while not self._halt.wait(self.interval):
            self.beat()

    def stop(self) -> None:
        self._halt.set()
        if self.is_alive():
            self.join(timeout=5.0)


_HB_LOCK = threading.Lock()
_WRITER: Optional[HeartbeatWriter] = None


def start_heartbeat(path: Optional[str] = None,
                    interval: Optional[float] = None
                    ) -> Optional[HeartbeatWriter]:
    """Start the heartbeat writer (or return the running one); ``None``
    when no path is given or set."""
    global _WRITER
    path = path or heartbeat_file()
    if path is None:
        return None
    with _HB_LOCK:
        if _WRITER is not None and _WRITER.is_alive():
            return _WRITER
        _WRITER = HeartbeatWriter(
            path, heartbeat_interval() if interval is None else interval)
        _WRITER.start()
        return _WRITER


def maybe_start_heartbeat() -> Optional[HeartbeatWriter]:
    """The running writer when supervised (the heartbeat file is set),
    else ``None``."""
    if heartbeat_file() is None:
        return None
    return start_heartbeat()


def stop_heartbeat() -> None:
    global _WRITER
    with _HB_LOCK:
        if _WRITER is not None:
            _WRITER.stop()
            _WRITER = None


def read_heartbeat(path: str) -> Optional[Dict[str, Any]]:
    """A beat file's dict, or ``None`` when missing or unparseable."""
    try:
        with open(path) as f:
            return json.loads(f.read())
    except (OSError, ValueError):
        return None


# A signal handler runs on the main thread only; the serving loops poll
# this event instead.
_DRAIN = threading.Event()


def request_drain() -> None:
    """Ask this process's serving loops to drain and return
    (idempotent)."""
    if not _DRAIN.is_set():
        _DRAIN.set()
        _trace.event("resilience.drain_requested", cat="resilience",
                     pid=os.getpid())
        _metrics.inc("serve.drain_requests")


def drain_requested() -> bool:
    return _DRAIN.is_set()


def reset_drain() -> None:
    """Clear the drain flag (a served process never un-drains; tests
    do)."""
    _DRAIN.clear()


def install_sigterm_drain() -> bool:
    """Route SIGTERM to :func:`request_drain`, then to the handler that
    was there. Returns False, changing nothing, off the main thread
    (where Python refuses ``signal.signal``); a second call keeps the
    first chain."""
    import signal as _signal
    if threading.current_thread() is not threading.main_thread():
        return False
    current = _signal.getsignal(_signal.SIGTERM)
    if getattr(current, "_pylops_drain", False):
        return True

    def _handler(signum, frame):
        request_drain()
        if callable(current) and current not in (
                _signal.SIG_IGN, _signal.SIG_DFL):
            current(signum, frame)

    _handler._pylops_drain = True
    _signal.signal(_signal.SIGTERM, _handler)
    return True
