"""A worker's side of supervision: heartbeats, the watchdog, the drain
and the bring-up contract.

PyTorch counterpart of ``pylops_mpi_tpu/resilience/elastic.py`` (the
heartbeat ``:76-192``, the watchdog ``:194-312``, the drain
``:318-375`` and the worker contract ``:376-408``, ``:682-702``). The
in-place reconfiguration and the carry bank (``:410-680``) need the
resharding planner and are ROADMAP.md §A.7 item 5.

- **Heartbeats**: a daemon thread writes ``{"pid", "seq", "wall",
  "mono"}`` (and ``"metrics"``, the registry's snapshot, when
  ``PYLOPS_MPI_TPU_TORCH_METRICS=on``) to
  ``PYLOPS_MPI_TPU_TORCH_HEARTBEAT_FILE`` every
  ``PYLOPS_MPI_TPU_TORCH_HEARTBEAT`` seconds (default 1.0, floored at
  0.05), atomically. The thread beats while the main thread waits on
  the device, so a beat stops only when the process is wedged or dead.
- **The collective watchdog**: a phase that waits on peers (the
  process group's bring-up, a checkpoint written by every rank) hangs
  for ever when a peer is gone, and the stuck worker's own beat goes
  on. :func:`watched_call` runs such a phase in a thread with a deadline
  (``PYLOPS_MPI_TPU_TORCH_WATCHDOG_TIMEOUT``, else the stage's row of
  :data:`~..diagnostics.profiler.STAGE_BUDGETS`) and raises a
  :class:`WatchdogTimeout` that names the stage; the worker exits and
  the supervisor relaunches. ``PYLOPS_MPI_TPU_TORCH_WATCHDOG`` is
  ``auto`` (armed only under a supervisor, where the heartbeat file is
  set: plain library use starts no thread), ``on`` or ``off``.
- **The drain**: SIGTERM, or :func:`request_drain`, asks the serving
  loops to finish what they hold, stop claiming and return.
- **The worker contract** (set by :func:`.supervisor.launch_job`, read
  by :func:`worker_config`): ``PYLOPS_MPI_TPU_TORCH_COORDINATOR``
  (``host:port`` of this attempt's rendezvous),
  ``..._NUM_PROCESSES`` (the attempt's world, shrunk after a failure),
  ``..._PROCESS_ID`` (the rank), ``..._ATTEMPT`` (0-based),
  ``..._HEARTBEAT_FILE`` and ``..._HEARTBEAT``.
  :func:`elastic_initialize` starts the beat and, for a world of more
  than one, the process group.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from collections import namedtuple
from typing import Any, Callable, Dict, Optional

from ..diagnostics import metrics as _metrics
from ..diagnostics import trace as _trace
from ..diagnostics.profiler import STAGE_BUDGETS

__all__ = ["heartbeat_interval", "heartbeat_file", "HeartbeatWriter",
           "start_heartbeat", "stop_heartbeat", "maybe_start_heartbeat",
           "read_heartbeat", "WatchdogTimeout", "watchdog_mode",
           "watchdog_enabled", "watchdog_timeout", "watched_call",
           "request_drain", "drain_requested", "reset_drain",
           "install_sigterm_drain", "WorkerConfig", "worker_config",
           "elastic_initialize"]


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


# ------------------------------------------------------------- watchdog
class WatchdogTimeout(RuntimeError):
    """A watched phase passed its deadline: a hung or lost peer, not a
    slow computation. ``stage`` and ``timeout_s`` name it."""

    def __init__(self, stage: str, timeout_s: float):
        self.stage = stage
        self.timeout_s = float(timeout_s)
        super().__init__(
            f"watchdog: stage {stage!r} still blocked after "
            f"{timeout_s:.0f}s — a peer is likely hung or gone; exiting so "
            "the supervisor can relaunch on the surviving workers")


_WD_MODES = ("auto", "on", "off")
_warned_wd = False


def watchdog_mode() -> str:
    """``PYLOPS_MPI_TPU_TORCH_WATCHDOG`` resolved to ``auto``/``on``/
    ``off`` (default ``auto``; an unknown value warns once and counts as
    ``auto``)."""
    global _warned_wd
    m = os.environ.get("PYLOPS_MPI_TPU_TORCH_WATCHDOG",
                       "auto").strip().lower()
    if m in ("", "none", "default"):
        m = "auto"
    if m not in _WD_MODES:
        if not _warned_wd:
            import warnings
            warnings.warn(f"PYLOPS_MPI_TPU_TORCH_WATCHDOG={m!r} is not one "
                          f"of {_WD_MODES}; using 'auto'", stacklevel=2)
            _warned_wd = True
        m = "auto"
    return m


def watchdog_enabled() -> bool:
    """``on``: armed; ``off``: not; ``auto``: armed when supervised."""
    m = watchdog_mode()
    if m == "on":
        return True
    if m == "off":
        return False
    return heartbeat_file() is not None


def watchdog_timeout(stage: str, default: Optional[float] = None) -> float:
    """One watched stage's deadline: ``PYLOPS_MPI_TPU_TORCH_WATCHDOG_
    TIMEOUT`` when set, else the stage's ``tpu`` budget in
    ``STAGE_BUDGETS`` (the live budget of both packages' table), else
    ``default`` (300 s)."""
    raw = os.environ.get("PYLOPS_MPI_TPU_TORCH_WATCHDOG_TIMEOUT")
    if raw:
        try:
            return float(raw)
        except ValueError:
            pass
    row = STAGE_BUDGETS.get(stage)
    if row and row.get("tpu"):
        return float(row["tpu"])
    return 300.0 if default is None else float(default)


_wd_tls = threading.local()  # a watched phase inside another runs direct


def watched_call(fn: Callable, *args, stage: str,
                 timeout_s: Optional[float] = None, **kwargs):
    """``fn(*args, **kwargs)`` under the watchdog. Disarmed, a direct
    call (no thread, no event). Armed, the call runs in a daemon thread
    and the caller waits at most the deadline, then gets
    :class:`WatchdogTimeout` (the stuck thread is left behind: the
    worker is about to exit). A result or an exception is relayed; a
    watched phase within another runs direct under the outer
    deadline."""
    if not watchdog_enabled() or getattr(_wd_tls, "active", False):
        return fn(*args, **kwargs)
    deadline = watchdog_timeout(stage) if timeout_s is None \
        else float(timeout_s)
    out: "queue.Queue" = queue.Queue(maxsize=1)

    def runner():
        _wd_tls.active = True
        try:
            out.put((True, fn(*args, **kwargs)))
        except BaseException as e:  # noqa: BLE001 — relayed to the caller
            out.put((False, e))

    t = threading.Thread(target=runner, daemon=True,
                         name=f"pylops-torch-watchdog-{stage}")
    with _trace.span("resilience.watchdog", cat="resilience", stage=stage,
                     timeout_s=deadline):
        t.start()
        try:
            ok, payload = out.get(timeout=deadline)
        except queue.Empty:
            _trace.event("resilience.watchdog_timeout", cat="resilience",
                         stage=stage, timeout_s=deadline)
            raise WatchdogTimeout(stage, deadline) from None
    if ok:
        return payload
    raise payload


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


# ------------------------------------------------------ worker bring-up
WorkerConfig = namedtuple(
    "WorkerConfig", ["coordinator", "num_processes", "process_id",
                     "attempt", "heartbeat_path", "heartbeat_s"])
WorkerConfig.__doc__ = (
    "This worker's identity in the current attempt, from the supervisor's "
    "contract: rendezvous address, world size (shrunk after a failure), "
    "rank, 0-based attempt and the heartbeat assignment; an unsupervised "
    "process gets (None, None, None, 0, None, interval).")


def _env_int(name: str) -> Optional[int]:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return None
    try:
        return int(raw)
    except ValueError:
        return None


def worker_config() -> WorkerConfig:
    """The supervisor's contract (module docstring)."""
    return WorkerConfig(
        coordinator=os.environ.get("PYLOPS_MPI_TPU_TORCH_COORDINATOR")
        or None,
        num_processes=_env_int("PYLOPS_MPI_TPU_TORCH_NUM_PROCESSES"),
        process_id=_env_int("PYLOPS_MPI_TPU_TORCH_PROCESS_ID"),
        attempt=_env_int("PYLOPS_MPI_TPU_TORCH_ATTEMPT") or 0,
        heartbeat_path=heartbeat_file(),
        heartbeat_s=heartbeat_interval())


def elastic_initialize(backend: Optional[str] = None,
                       device=None) -> WorkerConfig:
    """A supervised worker's bring-up: start the heartbeat, then, for an
    attempt of more than one process, join the process group at the
    contract's address (``tcp://<coordinator>``) through
    :func:`~..parallel.mesh.init`, whose bring-up runs under the bounded
    retry and the watchdog. ``backend``/``device`` go to ``init``
    (default: NCCL on a card, gloo on the CPU). A world of one starts no
    group. Returns the :class:`WorkerConfig`."""
    cfg = worker_config()
    maybe_start_heartbeat()
    if cfg.num_processes is not None and cfg.num_processes > 1:
        from ..parallel.mesh import init
        init(backend=backend, init_method=f"tcp://{cfg.coordinator}",
             rank=cfg.process_id, world_size=cfg.num_processes,
             device=device)
    _trace.event("resilience.elastic_init", cat="resilience",
                 attempt=cfg.attempt, world=cfg.num_processes or 1,
                 rank=cfg.process_id or 0)
    return cfg
