"""The supervisor: launch, watch, classify, shrink, relaunch.

PyTorch counterpart of ``pylops_mpi_tpu/resilience/supervisor.py:62-540``.
:func:`launch_job` runs N worker processes and babysits them:

1. **Launch** each with the worker contract (:mod:`.elastic`):
   rendezvous address on a fresh free port, world size, rank, attempt,
   and a heartbeat file of its own; argv placeholders ``{port}``,
   ``{rank}``, ``{world}`` and ``{attempt}`` are filled in.
2. **Watch** the processes and their heartbeat files.
3. **Classify** a failure:

   ===================  =============================================
   ``exit``             the process ended with a nonzero code
   ``signal``           the process was killed by a signal (rc < 0)
   ``stale_heartbeat``  alive, but its beat file is older than
                        ``stale_factor`` × the beat interval (wedged:
                        SIGSTOPped, deadlocked in a collective)
   ``reconfig_timeout`` an in-place survivor that did not beat its new
                        attempt by the deadline (below)
   ===================  =============================================

4. **Kill and relaunch**: the first failure of an attempt kills all its
   workers (a worker that lost a peer waits in its next collective), then
   relaunches on the surviving slots (``shrink=True``, a smaller world)
   or on all of them, up to ``max_relaunches`` times and within
   ``job_timeout_s``. The workers resume from their checkpoint, which
   :mod:`..utils.checkpoint` restores on the new world.

**In place** (``inplace=True``, JAX ``supervisor.py:400-459``): each
worker also gets a reconfig file (``..._RECONFIG_FILE``). When a failure
leaves exactly one live survivor, the survivors meet ``quorum`` of the
attempt's world and a relaunch is left in the budget, the supervisor
kills only the failed worker and writes the survivor a reconfig naming
the world of one; the survivor re-forms and resumes from its banked
carry (:mod:`.elastic`) with no checkpoint read, and the result counts
one attempt more. A peer that died inside a collective makes the
survivor's call raise (gloo resets the connections), and the survivor
takes the reconfig from there. The survivor must beat its new attempt
(``apply_reconfig``) within ``reconfig_deadline_s`` (default
``grace_s``; keep it above an epoch's length), else it is a
``reconfig_timeout``. Any other case (two or more survivors, whose
group cannot be re-formed while a peer is dead; below quorum; no
budget; a timeout) takes the kill-and-relaunch ladder above, and so
does a survivor that fails to recover in place (it exits non-zero) or
misses its deadline: its slot is kept, and the relaunch reads the
checkpoint.

The supervisor's own code calls no torch and none of the workers' code:
it watches processes and files, so it stays responsive while workers
build, solve or die. Worker output goes to log files, whose tails the result keeps.
A worker whose peer died must leave without ``destroy()`` (the group's
shutdown waits on the dead peer): ``os._exit`` after its last write.
``aot_cache`` accepts only ``None``, because a captured CUDA graph
cannot leave its process.
"""

from __future__ import annotations

import json
import math
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

from ..diagnostics import metrics as _metrics
from ..diagnostics import trace as _trace
from .elastic import inplace_mode, quorum_fraction, read_heartbeat

__all__ = ["WorkerHandle", "Failure", "JobResult", "JOB_REPORT_SCHEMA",
           "free_port", "launch_job", "write_job_report"]

JOB_REPORT_SCHEMA = 1


def free_port() -> int:
    """An OS-assigned free TCP port for the attempt's rendezvous (a
    small window between close and the rank 0 store's bind; the bounded
    retry of ``parallel.init`` absorbs a loss)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@dataclass
class WorkerHandle:
    """One launched worker process of one attempt."""
    rank: int                 # rank within the CURRENT attempt's world
    slot: int                 # stable identity across attempts
    proc: subprocess.Popen
    heartbeat_path: str
    log_path: str
    launched_at: float        # monotonic; bring-up grace reference
    metrics_path: str = ""    # worker's assigned snapshot file
    reconfig_path: str = ""   # its in-place reconfig file (inplace=True)

    def alive(self) -> bool:
        return self.proc.poll() is None


@dataclass
class Failure:
    """One classified worker failure (see module docstring table)."""
    attempt: int
    rank: int
    slot: int
    kind: str                 # "exit" | "signal" | "stale_heartbeat"
    returncode: Optional[int]
    detail: str
    detected_after_s: float   # since this attempt's launch

    def as_dict(self) -> Dict:
        return {"attempt": self.attempt, "rank": self.rank,
                "slot": self.slot, "kind": self.kind,
                "returncode": self.returncode, "detail": self.detail,
                "detected_after_s": round(self.detected_after_s, 3)}


@dataclass
class JobResult:
    """What :func:`launch_job` hands back: whether the final attempt
    finished clean, how many processes that attempt ran with, every
    classified failure along the way, the tail of each final worker's
    log (keyed by rank), and — when the workers ran with
    ``PYLOPS_MPI_TPU_TORCH_METRICS=on`` — each final worker's last metrics
    snapshot (``metrics``, keyed by rank; harvested from the worker's
    snapshot file with its last heartbeat as fallback)."""
    ok: bool
    world_size: int
    attempts: int
    failures: List[Failure] = field(default_factory=list)
    outputs: Dict[int, str] = field(default_factory=dict)
    returncodes: Dict[int, int] = field(default_factory=dict)
    logdir: Optional[str] = None
    metrics: Dict[int, Dict] = field(default_factory=dict)


def _harvest_metrics(workers: Sequence[WorkerHandle]) -> Dict[int, Dict]:
    """Final per-worker metrics snapshots: the worker's snapshot file
    first (the atexit write is the freshest), its last heartbeat's
    embedded ``metrics`` payload as fallback (a SIGKILLed worker never
    ran atexit, but its beats carried the registry). Workers without
    either (metrics off) are simply absent."""
    out: Dict[int, Dict] = {}
    for w in workers:
        snap = _metrics.read_snapshot(w.metrics_path) \
            if w.metrics_path else None
        if snap is None:
            beat = read_heartbeat(w.heartbeat_path)
            if beat and isinstance(beat.get("metrics"), dict):
                snap = beat["metrics"]
        if snap is not None:
            out[w.rank] = snap
    return out


def write_job_report(result: JobResult) -> Optional[str]:
    """Persist the job post-mortem as ``job_report.json`` next to the
    worker logs: schema-versioned, with every
    failure classification and the final per-worker metrics snapshots.
    Atomic (temp + ``os.replace``); a failed write is swallowed — the
    in-memory :class:`JobResult` is already in the caller's hands."""
    if not result.logdir:
        return None
    path = os.path.join(result.logdir, "job_report.json")
    doc = {"schema": JOB_REPORT_SCHEMA, "ok": result.ok,
           "world_size": result.world_size, "attempts": result.attempts,
           "failures": [f.as_dict() for f in result.failures],
           "returncodes": {str(r): rc
                           for r, rc in result.returncodes.items()},
           "metrics": {str(r): m for r, m in result.metrics.items()},
           "logdir": result.logdir}
    tmp = path + f".tmp{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1)
        os.replace(tmp, path)
        return path
    except OSError:
        try:
            if os.path.exists(tmp):
                os.remove(tmp)
        except OSError:
            pass
        return None


def _format_argv(argv: Sequence[str], *, port: int, rank: int,
                 world: int, attempt: int) -> List[str]:
    """Expand the ``{port}``/``{rank}``/``{world}``/``{attempt}``
    placeholders. Non-placeholder args pass through untouched (a
    literal ``{`` elsewhere is the caller's problem to escape, but no
    existing worker argv carries one)."""
    subst = {"port": port, "rank": rank, "world": world,
             "attempt": attempt}
    out = []
    for a in argv:
        try:
            out.append(str(a).format(**subst))
        except (KeyError, IndexError, ValueError):
            out.append(str(a))
    return out


def _tail(path: str, max_bytes: int = 8192) -> str:
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(0, size - max_bytes))
            return f.read().decode("utf-8", errors="replace")
    except OSError:
        return ""


def _kill_all(workers: Sequence[WorkerHandle]) -> None:
    """SIGKILL the whole attempt. A worker that lost a peer is (or soon
    will be) blocked inside a collective; there is nothing graceful to
    wait for, and SIGCONT-before-KILL would only matter for SIGSTOP'd
    workers, which SIGKILL reaps regardless."""
    for w in workers:
        if w.alive():
            try:
                w.proc.kill()
            except OSError:
                pass
    for w in workers:
        try:
            w.proc.wait(timeout=10.0)
        except subprocess.TimeoutExpired:
            pass


def _classify(w: WorkerHandle, *, stale_s: float,
              now_mono: float) -> Optional[Dict]:
    """Return ``{"kind", "returncode", "detail"}`` when worker ``w`` has
    failed, else None. Heartbeat staleness is judged against the beat
    file's mtime (wall clock — mtimes are epoch-stamped), with the
    launch time (monotonic) standing in as beat zero so a worker that
    dies before its first beat is caught by the same rule."""
    rc = w.proc.poll()
    if rc is not None:
        if rc == 0:
            return None  # clean exit is success, handled by the caller
        if rc < 0:
            try:
                signame = signal.Signals(-rc).name
            except ValueError:
                signame = f"signal {-rc}"
            return {"kind": "signal", "returncode": rc,
                    "detail": f"killed by {signame}"}
        return {"kind": "exit", "returncode": rc,
                "detail": f"exited with code {rc}"}
    try:
        beat_age = time.time() - os.path.getmtime(w.heartbeat_path)
    except OSError:
        beat_age = now_mono - w.launched_at  # no beat: age since launch
    if beat_age > stale_s:
        beat = read_heartbeat(w.heartbeat_path)
        return {"kind": "stale_heartbeat", "returncode": None,
                "detail": (f"no heartbeat for {beat_age:.2f}s "
                           f"(threshold {stale_s:.2f}s; last beat "
                           f"{beat})")}
    return None


def _reconfigure(result: JobResult, failure: Failure,
                 workers: Sequence[WorkerHandle],
                 survivors: Sequence[WorkerHandle], attempt: int) -> int:
    """The in-place path: record the failure, kill only the failed
    worker, write each survivor its reconfig (the next attempt, the
    shrunk world, its new rank), atomically; returns the new world."""
    result.failures.append(failure)
    _trace.event("supervisor.failure", cat="resilience",
                 **failure.as_dict())
    _kill_all([w for w in workers if w.slot == failure.slot])
    for new_rank, w in enumerate(survivors):
        doc = {"attempt": attempt + 1, "num_processes": len(survivors),
               "process_id": new_rank, "coordinator": None,
               "lost_slot": failure.slot}
        tmp = w.reconfig_path + f".tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, w.reconfig_path)
        w.rank = new_rank
    result.attempts += 1
    result.world_size = len(survivors)
    _metrics.inc("supervisor.inplace_reconfigs")
    _trace.event("supervisor.inplace_reconfig", cat="resilience",
                 attempt=attempt + 1, world=len(survivors),
                 lost_slot=failure.slot)
    return len(survivors)


def _check_resumed(resumed: Dict[int, tuple],
                   workers: Sequence[WorkerHandle], now: float,
                   deadline_s: float, attempt: int) -> Optional[Failure]:
    """Each survivor of an in-place reconfig must beat the new attempt
    (``apply_reconfig``) by its deadline: one that did is dropped from
    ``resumed``; one past its deadline (wedged in a collective with the
    dead peer, or not polling) is a ``reconfig_timeout`` failure, which
    takes the relaunch ladder."""
    for w in workers:
        if w.slot not in resumed or not w.alive():
            continue
        want, deadline = resumed[w.slot]
        beat = read_heartbeat(w.heartbeat_path) or {}
        if int(beat.get("attempt", -1)) >= want:
            del resumed[w.slot]
            _trace.event("supervisor.inplace_resumed", cat="resilience",
                         attempt=want, slot=w.slot)
        elif now > deadline:
            return Failure(
                attempt=attempt, rank=w.rank, slot=w.slot,
                kind="reconfig_timeout", returncode=None,
                detail=(f"no beat of attempt {want} within {deadline_s}s "
                        "of its reconfig"),
                detected_after_s=now - w.launched_at)
    return None


def launch_job(argv: Sequence[str], num_workers: int, *,
               max_relaunches: int = 1,
               shrink: bool = True,
               heartbeat_interval: float = 1.0,
               stale_factor: float = 2.0,
               grace_s: Optional[float] = None,
               poll_s: float = 0.05,
               job_timeout_s: Optional[float] = None,
               env: Optional[Dict[str, str]] = None,
               logdir: Optional[str] = None,
               on_poll: Optional[Callable[[int, List[WorkerHandle]],
                                          None]] = None,
               on_relaunch: Optional[Callable[[int, Failure],
                                              None]] = None,
               python: Optional[str] = None,
               inplace: Optional[bool] = None,
               quorum: Optional[float] = None,
               reconfig_deadline_s: Optional[float] = None,
               aot_cache: Optional[str] = None) -> JobResult:
    """Launch ``num_workers`` supervised workers and see them to the end,
    relaunching after failures (module docstring).

    ``argv`` is the worker command line, its placeholders filled per
    worker and attempt; an ``argv[0]`` ending in ``.py`` runs under
    ``python`` (default ``sys.executable``). ``shrink`` drops the failed
    worker's slot for the next attempt; ``max_relaunches`` bounds the
    relaunches and ``job_timeout_s`` the whole job (a timeout is
    terminal). A worker is wedged when its beat file is older than
    ``stale_factor × heartbeat_interval``, plus ``grace_s`` (default 10
    intervals) until its first beat lands. ``on_poll(attempt, workers)``
    runs every poll; ``on_relaunch(next_attempt, failure)`` after a
    failed attempt was killed and before its relaunch (a raising hook is
    swallowed). The worker's environment is ``os.environ``, then
    ``env``, then the contract. ``inplace``/``quorum``/
    ``reconfig_deadline_s``: the in-place recovery (module docstring;
    ``None``: ``PYLOPS_MPI_TPU_TORCH_INPLACE``, where ``off`` overrides
    even ``inplace=True``, ``..._QUORUM`` and ``grace_s``);
    ``aot_cache`` must be ``None``."""
    if aot_cache is not None:
        raise ValueError(
            "aot_cache must be None: a captured CUDA graph lives in its "
            "process and cannot be banked for a relaunched worker; each "
            "attempt captures its own (PYLOPS_MPI_TPU_TORCH_AOT)")
    if num_workers < 1:
        raise ValueError(f"num_workers must be >= 1, got {num_workers}")
    argv = [str(a) for a in argv]
    python = python or sys.executable
    logdir = logdir or tempfile.mkdtemp(prefix="pylops-torch-supervisor-")
    os.makedirs(logdir, exist_ok=True)
    if grace_s is None:
        grace_s = 10.0 * heartbeat_interval
    stale_s = stale_factor * heartbeat_interval
    mode = inplace_mode()
    inplace = (mode == "on" if inplace is None else bool(inplace)) \
        and mode != "off"
    quorum = quorum_fraction() if quorum is None else float(quorum)
    if reconfig_deadline_s is None:
        reconfig_deadline_s = grace_s

    result = JobResult(ok=False, world_size=num_workers, attempts=0,
                       logdir=logdir)
    slots = list(range(num_workers))  # surviving stable identities
    t_job = time.monotonic()

    for attempt in range(max_relaunches + 1):
        world = len(slots)
        port = free_port()
        result.attempts += 1
        result.world_size = world
        _trace.event("supervisor.launch", cat="resilience",
                     attempt=attempt, world=world, port=port,
                     slots=list(slots))
        workers: List[WorkerHandle] = []
        for rank, slot in enumerate(slots):
            hb = os.path.join(logdir, f"worker{slot}.attempt{attempt}.hb")
            log = os.path.join(logdir, f"worker{slot}.attempt{attempt}.log")
            met = os.path.join(
                logdir, f"worker{slot}.attempt{attempt}.metrics.json")
            rcf = os.path.join(
                logdir, f"worker{slot}.attempt{attempt}.reconfig.json") \
                if inplace else ""
            wenv = dict(os.environ)
            if env:
                wenv.update(env)
            wenv.update({
                "PYLOPS_MPI_TPU_TORCH_COORDINATOR": f"127.0.0.1:{port}",
                "PYLOPS_MPI_TPU_TORCH_NUM_PROCESSES": str(world),
                "PYLOPS_MPI_TPU_TORCH_PROCESS_ID": str(rank),
                "PYLOPS_MPI_TPU_TORCH_ATTEMPT": str(attempt),
                "PYLOPS_MPI_TPU_TORCH_HEARTBEAT_FILE": hb,
                "PYLOPS_MPI_TPU_TORCH_HEARTBEAT": repr(heartbeat_interval),
                # the registry writes it only under METRICS=on
                "PYLOPS_MPI_TPU_TORCH_METRICS_FILE": met,
            })
            if inplace:
                wenv["PYLOPS_MPI_TPU_TORCH_RECONFIG_FILE"] = rcf
            else:
                # an outer job's assignment must not arm this one's workers
                wenv.pop("PYLOPS_MPI_TPU_TORCH_RECONFIG_FILE", None)
            # relaunched peers must not dial the rendezvous in lockstep;
            # an explicit caller value wins
            wenv.setdefault("PYLOPS_MPI_TPU_TORCH_RETRY_JITTER", "0.25")
            cmd = _format_argv(argv, port=port, rank=rank, world=world,
                               attempt=attempt)
            if cmd and cmd[0].endswith(".py"):
                cmd = [python] + cmd
            logf = open(log, "wb")
            try:
                proc = subprocess.Popen(cmd, stdout=logf,
                                        stderr=subprocess.STDOUT, env=wenv)
            finally:
                logf.close()  # the child holds its own descriptor
            workers.append(WorkerHandle(rank=rank, slot=slot, proc=proc,
                                        heartbeat_path=hb, log_path=log,
                                        launched_at=time.monotonic(),
                                        metrics_path=met,
                                        reconfig_path=rcf))

        failure: Optional[Failure] = None
        # slot -> (attempt its resumed beat must name, monotonic deadline)
        resumed: Dict[int, tuple] = {}
        # slots a reconfig kept alive in this attempt: their own failure
        # is no reason to drop them (the lost slot is gone already)
        kept: set = set()
        while True:
            now = time.monotonic()
            if job_timeout_s is not None and now - t_job > job_timeout_s:
                _kill_all(workers)
                failure = Failure(
                    attempt=attempt, rank=-1, slot=-1, kind="timeout",
                    returncode=None, detail=f"job exceeded {job_timeout_s}s",
                    detected_after_s=now - workers[0].launched_at)
                result.failures.append(failure)
                result.outputs = {w.rank: _tail(w.log_path)
                                  for w in workers}
                result.metrics = _harvest_metrics(workers)
                _trace.event("supervisor.timeout", cat="resilience",
                             attempt=attempt)
                write_job_report(result)
                return result  # a job timeout is terminal
            if on_poll is not None:
                on_poll(attempt, workers)
            for w in workers:
                # until the first beat lands, the longer grace applies
                eff_stale = stale_s if os.path.exists(w.heartbeat_path) \
                    else max(stale_s, grace_s)
                cls = _classify(w, stale_s=eff_stale, now_mono=now)
                if cls is not None:
                    failure = Failure(attempt=attempt, rank=w.rank,
                                      slot=w.slot,
                                      detected_after_s=now - w.launched_at,
                                      **cls)
                    break
            if failure is None and resumed:
                failure = _check_resumed(resumed, workers, now,
                                         reconfig_deadline_s, attempt)
                if failure is not None:
                    break
            if failure is not None:
                survivors = [w for w in workers
                             if w.slot != failure.slot and w.alive()]
                need = max(1, math.ceil(quorum * world))
                if (inplace and attempt < max_relaunches
                        and len(survivors) == 1 and len(survivors) >= need):
                    world = _reconfigure(result, failure, workers,
                                         survivors, attempt)
                    slots = [s for s in slots if s != failure.slot]
                    workers = survivors
                    for w in survivors:
                        kept.add(w.slot)
                        resumed[w.slot] = (attempt + 1,
                                           now + reconfig_deadline_s)
                    failure = None
                    continue
                break
            if all(w.proc.poll() == 0 for w in workers):
                result.ok = True
                result.outputs = {w.rank: _tail(w.log_path)
                                  for w in workers}
                result.returncodes = {w.rank: 0 for w in workers}
                result.metrics = _harvest_metrics(workers)
                _trace.event("supervisor.success", cat="resilience",
                             attempt=attempt, world=world)
                write_job_report(result)
                return result
            time.sleep(poll_s)

        # ---- the attempt failed: kill it, record, shrink, relaunch
        result.failures.append(failure)
        _trace.event("supervisor.failure", cat="resilience",
                     **failure.as_dict())
        _kill_all(workers)
        result.outputs = {w.rank: _tail(w.log_path) for w in workers}
        result.metrics = _harvest_metrics(workers)
        result.returncodes = {w.rank: (w.proc.poll()
                                       if w.proc.poll() is not None
                                       else -9)
                              for w in workers}
        if shrink and failure.slot in slots and failure.slot not in kept:
            slots = [s for s in slots if s != failure.slot]
        if not slots or attempt >= max_relaunches:
            write_job_report(result)
            return result
        if on_relaunch is not None:
            try:
                on_relaunch(attempt + 1, failure)
            except Exception:
                pass
        _metrics.inc("supervisor.relaunches")
        _trace.event("supervisor.relaunch", cat="resilience",
                     attempt=attempt + 1, world=len(slots),
                     slots=list(slots))
    write_job_report(result)
    return result
