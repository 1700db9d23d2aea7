"""A worker's side of supervision: heartbeats, the watchdog, the drain
and the bring-up contract.

PyTorch counterpart of ``pylops_mpi_tpu/resilience/elastic.py`` (the
heartbeat ``:76-192``, the watchdog ``:194-312``, the drain
``:318-375``, the worker contract ``:376-408``, ``:682-702``, and the
in-place reconfiguration with its carry bank ``:395-680``).

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
- **In-place reconfiguration** (``launch_job(inplace=True)``): the
  classic recovery kills the whole attempt and relaunches it shrunk,
  and the new workers read the checkpoint back. In place, a survivor
  stays alive. While ``..._RECONFIG_FILE`` is assigned, a segmented
  solve banks its carry at every epoch boundary (:func:`bank_carry`,
  every vector gathered to the host: a collective) and polls the file
  (:func:`pending_reconfig`); when the supervisor writes it a shrunk
  world, the solve raises :class:`ElasticReconfig` at the next boundary,
  or at once when a collective of the epoch raised because the peer
  died inside it (:func:`await_reconfig`). The catcher adopts the new
  identity (:func:`apply_reconfig`, whose beat tells the supervisor it
  resumed), re-forms its mesh
  (:func:`reform_mesh`: only a world of one is re-formed in place; two
  or more survivors raise and take the checkpoint relaunch, since a
  group's shutdown waits on the dead peer) and replants the banked
  carry (:func:`restore_carry`, through ``parallel/reshard.
  place_replica``), then resumes the solve from it: no checkpoint read
  on that path. ``..._INPLACE`` (:func:`inplace_mode`) and ``..._QUORUM``
  (default 0.5, :func:`quorum_fraction`) are the supervisor's defaults
  for whether to try it and for the share of the world that must
  survive.
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
           "elastic_initialize", "ElasticReconfig", "inplace_mode",
           "reconfig_file", "inplace_armed", "quorum_fraction",
           "pending_reconfig", "apply_reconfig", "await_reconfig",
           "reform_mesh", "bank_carry", "banked_carry", "clear_carry",
           "restore_carry"]


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
        self._lock = threading.Lock()  # apply_reconfig beats too

    def beat(self) -> None:
        """One beat: pid, sequence, clocks, the attempt this process
        runs (an in-place survivor's beat after :func:`apply_reconfig`
        names the new one, which the supervisor waits for) and, under
        metrics, the registry."""
        with self._lock:
            self.seq += 1
            doc = {"pid": os.getpid(), "seq": self.seq,
                   "wall": time.time(), "mono": time.monotonic(),
                   "attempt": _env_int("PYLOPS_MPI_TPU_TORCH_ATTEMPT") or 0}
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


# ----------------------------------------- in-place reconfiguration
INPLACE_ENV = "PYLOPS_MPI_TPU_TORCH_INPLACE"
QUORUM_ENV = "PYLOPS_MPI_TPU_TORCH_QUORUM"
RECONFIG_ENV = "PYLOPS_MPI_TPU_TORCH_RECONFIG_FILE"

_IP_MODES = ("auto", "on", "off")
_warned_ip = False


class ElasticReconfig(RuntimeError):
    """The supervisor moved this worker to a shrunk world while a solve
    ran; raised at the next epoch boundary with the parsed reconfig
    ``config``, for the catcher to :func:`apply_reconfig`,
    :func:`reform_mesh` and resume from :func:`restore_carry`, or fall
    back to the checkpoint when one of them refuses."""

    def __init__(self, config: Dict[str, Any]):
        self.config = dict(config)
        super().__init__(
            f"elastic reconfig: attempt {config.get('attempt')} world "
            f"{config.get('num_processes')} rank "
            f"{config.get('process_id')} (in-place shrink; resume from "
            "the banked carry or fall back to the checkpoint)")


def inplace_mode() -> str:
    """``PYLOPS_MPI_TPU_TORCH_INPLACE`` resolved to ``auto``/``on``/
    ``off`` (default ``auto``; an unknown value warns once and counts as
    ``auto``): the supervisor's switch. ``on`` takes the in-place path
    when ``launch_job`` is not told otherwise, ``off`` never takes it,
    ``auto`` follows ``launch_job(inplace=)`` (default: not)."""
    global _warned_ip
    m = os.environ.get(INPLACE_ENV, "auto").strip().lower()
    if m in ("", "none", "default"):
        m = "auto"
    if m not in _IP_MODES:
        if not _warned_ip:
            import warnings
            warnings.warn(f"{INPLACE_ENV}={m!r} is not one of "
                          f"{_IP_MODES}; using 'auto'", stacklevel=2)
            _warned_ip = True
        m = "auto"
    return m


def reconfig_file() -> Optional[str]:
    """The reconfig path the supervisor assigned this worker
    (``launch_job(inplace=True)``), or ``None``."""
    return os.environ.get(RECONFIG_ENV) or None


def inplace_armed() -> bool:
    """A segmented solve banks and polls when the supervisor assigned
    this worker a reconfig file, which it does only on its in-place
    path (plain library use never banks or polls)."""
    return reconfig_file() is not None


def quorum_fraction() -> float:
    """``PYLOPS_MPI_TPU_TORCH_QUORUM``: the share of the world that must
    survive a failure for the in-place path (default 0.5, clamped to
    (0, 1]; malformed: the default), read by ``launch_job(quorum=None)``."""
    try:
        v = float(os.environ.get(QUORUM_ENV, "0.5"))
    except ValueError:
        v = 0.5
    return min(1.0, max(1e-9, v))


def pending_reconfig() -> Optional[Dict[str, Any]]:
    """The supervisor's reconfig for this worker, parsed, when it names
    an attempt newer than this process's (applying it bumps
    ``..._ATTEMPT``, which consumes it), else ``None``; a torn write
    reads as ``None`` until the next poll."""
    path = reconfig_file()
    if path is None or not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            doc = json.loads(f.read())
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict) or "attempt" not in doc:
        return None
    cur = _env_int("PYLOPS_MPI_TPU_TORCH_ATTEMPT") or 0
    if int(doc["attempt"]) <= cur:
        return None
    return doc


def apply_reconfig(config: Dict[str, Any]) -> WorkerConfig:
    """Adopt a reconfig: rewrite the worker contract (world, rank,
    attempt, rendezvous) so :func:`worker_config` and
    :func:`pending_reconfig` see the shrunk world; returns the new
    config."""
    os.environ["PYLOPS_MPI_TPU_TORCH_NUM_PROCESSES"] = \
        str(int(config["num_processes"]))
    os.environ["PYLOPS_MPI_TPU_TORCH_PROCESS_ID"] = \
        str(int(config["process_id"]))
    os.environ["PYLOPS_MPI_TPU_TORCH_ATTEMPT"] = str(int(config["attempt"]))
    if config.get("coordinator"):
        os.environ["PYLOPS_MPI_TPU_TORCH_COORDINATOR"] = \
            str(config["coordinator"])
    _trace.event("resilience.reconfig_applied", cat="resilience",
                 attempt=int(config["attempt"]),
                 world=int(config["num_processes"]),
                 rank=int(config["process_id"]))
    with _HB_LOCK:
        writer = _WRITER
    if writer is not None:
        writer.beat()  # the supervisor's sign that this survivor resumed
    return worker_config()


def await_reconfig(exc: BaseException) -> None:
    """An armed solve's collective raised ``exc`` (a gloo peer that died
    inside a collective resets its connections, and the survivor's call
    raises): wait up to 10 heartbeat intervals (at least 2 s) for the
    supervisor's reconfig and raise :class:`ElasticReconfig` from
    ``exc``, for the catcher's in-place recovery from the last banked
    epoch. Returns when none came (the caller re-raises ``exc``) or when
    the solve is not armed."""
    if not inplace_armed():
        return
    deadline = time.monotonic() + max(2.0, 10.0 * heartbeat_interval())
    while True:
        rc = pending_reconfig()
        if rc is not None:
            _trace.event("resilience.peer_lost", cat="resilience",
                         error=type(exc).__name__,
                         attempt=int(rc["attempt"]))
            raise ElasticReconfig(rc) from exc
        if time.monotonic() >= deadline:
            return
        time.sleep(0.05)


def reform_mesh(cfg: WorkerConfig, device=None):
    """Re-form this survivor's mesh for the shrunk world without a
    restart. A world of one detaches from the old group
    (``parallel.mesh.detach``: the mesh and sub-groups forgotten, no
    ``destroy_process_group``, whose shutdown would wait on the dead
    peer) and gets the world-of-one :class:`~..parallel.mesh.Mesh` on
    ``device`` (default: the old mesh's). Two or more survivors would
    need a new group, and the old one cannot be ended while a peer is
    dead: that raises, and the worker takes the checkpoint relaunch."""
    world = cfg.num_processes or 1
    if world > 1:
        raise RuntimeError(
            "reform_mesh: re-forming a world of several ranks in place "
            "needs a new process group, and ending the old one waits on "
            "the dead peer; fall back to the checkpoint relaunch path")
    from ..parallel import mesh as _mesh
    dev = _mesh.default_mesh().device if device is None \
        else _mesh.resolve_device(device)
    _mesh.detach()
    out = _mesh.make_mesh(device=dev)
    _trace.event("resilience.mesh_reformed", cat="resilience", world=world,
                 device=str(dev))
    return out


# The bank: one host snapshot of a segmented solve's carry per tag
# ("cg"/"cgls"), refreshed at every epoch boundary while armed. Vector
# fields are gathered to the host on every rank (a collective), so any
# survivor holds the whole value and can replant it alone.
_BANK_LOCK = threading.Lock()
_BANK: Dict[str, Dict[str, Any]] = {}


def _host_tensor(t):
    return t.detach().to("cpu", copy=True)


def bank_carry(tag: str, carry: Dict[str, Any]) -> None:
    """Bank one epoch boundary's carry under ``tag``: each
    :class:`~..distributedarray.DistributedArray` as its gathered global
    value on the host with its layout (partition, axis, shard count,
    mask, dtype, device); each tensor as a host copy with its device;
    Python scalars as they are. A stacked vector refuses (``TypeError``:
    in-place banking takes flat vectors; the checkpoint path remains).
    Collective: every rank calls it."""
    import torch
    from ..distributedarray import DistributedArray
    rec: Dict[str, Any] = {}
    for name, val in carry.items():
        if isinstance(val, DistributedArray):
            rec[name] = {"kind": "dist", "partition": val.partition.name,
                         "axis": int(val.axis),
                         "n_shards": int(val.n_shards),
                         "mask": (tuple(val.mask) if val.mask is not None
                                  else None),
                         "device": str(val.device),
                         "value": _host_tensor(val._global())}
        elif hasattr(val, "distarrays"):
            raise TypeError(
                f"bank_carry: field {name!r} is a stacked vector; "
                "in-place banking supports flat DistributedArray "
                "carries only — run with the checkpoint fallback")
        elif isinstance(val, torch.Tensor):
            rec[name] = {"kind": "array", "device": str(val.device),
                         "value": _host_tensor(val)}
        else:
            rec[name] = {"kind": "raw", "value": val}
    with _BANK_LOCK:
        _BANK[tag] = {"wall": time.time(), "fields": rec}
    _trace.event("resilience.carry_banked", cat="resilience", tag=tag,
                 n_fields=len(rec))


def banked_carry(tag: str) -> Optional[Dict[str, Any]]:
    """The raw banked record of ``tag`` (or ``None``), for inspection;
    a resume uses :func:`restore_carry`."""
    with _BANK_LOCK:
        return _BANK.get(tag)


def clear_carry(tag: Optional[str] = None) -> None:
    with _BANK_LOCK:
        if tag is None:
            _BANK.clear()
        else:
            _BANK.pop(tag, None)


def restore_carry(tag: str, mesh=None, budget=None, chunks=None,
                  device=None) -> Dict[str, Any]:
    """Replant the banked carry of ``tag`` onto ``mesh`` (the re-formed
    world; default the current one): each vector through
    :func:`~..parallel.reshard.place_replica` with the balanced split of
    the new world, each tensor back on ``device`` (default: the mesh's),
    ready for a segmented solve's ``resume_state``. ``KeyError`` when
    nothing is banked; a planner refusal (budget, a mask across worlds)
    propagates, and the caller falls back to the checkpoint. No
    checkpoint is read."""
    from ..parallel import reshard as _reshard
    from ..parallel.mesh import default_mesh
    from ..parallel.partition import Partition
    with _BANK_LOCK:
        bank = _BANK.get(tag)
    if bank is None:
        raise KeyError(f"restore_carry: no banked carry for tag {tag!r}")
    mesh = default_mesh() if mesh is None else mesh
    dev = mesh.device if device is None else device
    n_new = int(mesh.size)
    state: Dict[str, Any] = {}
    for name, rec in bank["fields"].items():
        kind = rec["kind"]
        if kind == "dist":
            if rec["mask"] is not None and rec["n_shards"] != n_new:
                raise _reshard.ReshardError(
                    f"restore_carry: field {name!r} carries a mask and "
                    f"the world changed {rec['n_shards']} -> {n_new}; "
                    "masks are per-shard group colors — fall back to "
                    "the checkpoint path", 0)
            state[name] = _reshard.place_replica(
                rec["value"], mesh, Partition[rec["partition"]],
                rec["axis"],
                mask=(rec["mask"] if rec["n_shards"] == n_new else None),
                budget=(budget if budget is not None
                        else _reshard._UNSET),
                chunks=chunks, device=dev)
        elif kind == "raw":
            state[name] = rec["value"]
        else:
            state[name] = rec["value"].to(dev)
    _trace.event("resilience.inplace_recovery", cat="resilience",
                 tag=tag, n_fields=len(state), world=n_new)
    _metrics.inc("resilience.inplace_recoveries")
    return state
