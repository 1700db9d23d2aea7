"""The serving process: the daemon facade and the spool worker.

PyTorch counterpart of ``pylops_mpi_tpu/serving/service.py``:

- :class:`SolveDaemon`: one process's solve service, an
  :class:`~.queue.AdmissionQueue` and a :class:`~.queue.Dispatcher` over
  a :class:`~.engine.WarmPool`. :meth:`~SolveDaemon.submit` returns a
  :class:`~.queue.Ticket`, :meth:`~SolveDaemon.stats` is the
  backpressure report, :meth:`~SolveDaemon.drain` stops admission,
  finishes what was admitted and joins the dispatcher within
  ``PYLOPS_MPI_TPU_TORCH_SERVE_DRAIN_TIMEOUT`` seconds (default 30).
- :func:`worker_main`: a replica serving from a durable
  :mod:`~.spool`: heartbeats when supervised, SIGTERM routed to a
  drain, and a claim → solve → bank loop. Replicas are independent:
  each owns its card and its pool, and they coordinate only through the
  spool.

The daemon's batches depend on arrival times, so ranks of a process
group would form different batches; the daemon and the worker refuse a
world of more than one rank. Run one worker process a card, each with
no process group, on a shared spool. :func:`serve_job` runs such a fleet
under the supervisor (:func:`~..resilience.supervisor.launch_job`),
sweeping a dead attempt's claimed requests back to pending before each
relaunch. A daemon over a process group is the rest of ROADMAP.md §A.7
item 1.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional, Sequence

import numpy as np

from ..diagnostics import metrics as _metrics
from ..diagnostics import trace as _trace
from ..parallel.mesh import world_size
from .engine import WarmPool
from .queue import AdmissionQueue, Dispatcher, Ticket
from . import spool as _spool

__all__ = ["drain_timeout_s", "SolveDaemon", "worker_main", "serve_job"]


def drain_timeout_s() -> float:
    """``PYLOPS_MPI_TPU_TORCH_SERVE_DRAIN_TIMEOUT`` in seconds (default
    30.0, floored at 0)."""
    try:
        v = float(os.environ.get("PYLOPS_MPI_TPU_TORCH_SERVE_DRAIN_TIMEOUT",
                                 "30"))
    except ValueError:
        v = 30.0
    return max(0.0, v)


def _single_rank(what: str) -> None:
    if world_size() > 1:
        raise RuntimeError(
            f"{what} serves from one process: its batches depend on arrival "
            f"times, so the {world_size()} ranks of this group would pack "
            "different batches. Run one worker per card with no process "
            "group on a shared spool; a daemon over a group of ranks is "
            "the rest of ROADMAP.md §A.7 item 1")


class SolveDaemon:
    """One process's solve service (see the module docstring).
    ``start(prewarm=True)`` prewarms the pool on the dispatcher's thread
    before it returns."""

    def __init__(self, pool: WarmPool, *,
                 window_s: Optional[float] = None,
                 queue_bound: Optional[int] = None,
                 rehearse: bool = False):
        _single_rank("SolveDaemon")
        self.pool = pool
        self.queue = AdmissionQueue(bound=queue_bound)
        self.dispatcher = Dispatcher(pool, self.queue, window_s=window_s,
                                     rehearse=rehearse)
        self._started = False

    def start(self, prewarm: bool = False) -> "SolveDaemon":
        """Start the dispatcher (once), with ``prewarm`` run first on its
        thread; a prewarm that raised is raised here."""
        if not self._started:
            self.dispatcher.prewarm = bool(prewarm)
            self.dispatcher.start()
            self.dispatcher.ready.wait()
            if self.dispatcher.prewarm_error is not None:
                raise self.dispatcher.prewarm_error
            self._started = True
            _trace.event("serve.daemon_start", cat="serving",
                         families=list(self.pool.families()),
                         buckets=list(self.pool.buckets))
        return self

    def submit(self, family: str, y: np.ndarray,
               deadline_ts: Optional[float] = None,
               request_id: Optional[str] = None) -> Ticket:
        """Admit one single-RHS request (a host array); raises
        :class:`~.queue.QueueFull` past the bound."""
        if not self._started:
            raise RuntimeError("SolveDaemon.start() before submit()")
        return self.queue.submit(family, y, deadline_ts=deadline_ts,
                                 request_id=request_id)

    def stats(self) -> Dict:
        return self.dispatcher.stats()

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Refuse new admissions, wait (up to ``timeout``, default the
        drain knob) for the queue to empty and the batch in flight to
        resolve, then stop the dispatcher. True when fully drained."""
        timeout = drain_timeout_s() if timeout is None else timeout
        self.queue.start_drain()
        end = time.monotonic() + timeout
        drained = self.queue.drain_empty(timeout=timeout)
        while drained and not self.dispatcher.idle():
            if time.monotonic() >= end:
                drained = False
                break
            time.sleep(0.01)
        self.dispatcher.stop()
        self._started = False
        _trace.event("serve.daemon_drain", cat="serving", drained=drained,
                     **self.stats())
        return drained


def worker_main(spool_dir: str, pool: WarmPool, *,
                poll_s: float = 0.02,
                window_s: Optional[float] = None,
                prewarm: bool = True,
                idle_exit_s: Optional[float] = None) -> int:
    """Serve from a spool until a drain: claim up to ``k_max`` pending
    requests a round, solve them through this process's
    :class:`SolveDaemon` (windows and deadlines apply), bank each result
    and release its claim; a request whose batch failed goes to
    ``failed/``. Returns, with the number of requests solved, once a
    drain is requested (SIGTERM through
    :func:`~..resilience.elastic.install_sigterm_drain`, or the spool's
    DRAIN marker) and nothing is pending; with ``idle_exit_s`` also
    after that long without work."""
    from ..resilience import elastic
    _single_rank("worker_main")
    _spool.init_spool(spool_dir)
    elastic.maybe_start_heartbeat()
    elastic.install_sigterm_drain()
    daemon = SolveDaemon(pool, window_s=window_s).start(prewarm=prewarm)
    solved = 0
    idle_since = time.monotonic()
    _metrics.set_gauge("serve.worker.up", 1)
    while True:
        draining = (elastic.drain_requested()
                    or _spool.drain_requested(spool_dir))
        claims = _spool.claim(spool_dir, daemon.pool.k_max)
        if not claims:
            if draining:
                break
            if idle_exit_s is not None and \
                    time.monotonic() - idle_since > idle_exit_s:
                break
            time.sleep(poll_s)
            continue
        idle_since = time.monotonic()
        tickets = [(c, daemon.submit(c.family, c.y,
                                     deadline_ts=c.deadline_ts,
                                     request_id=c.request_id))
                   for c in claims]
        for c, t in tickets:
            try:
                res = t.wait(timeout=drain_timeout_s() + 60.0)
            except Exception as e:  # the batch's failure, not a crash
                _spool.fail(spool_dir, c, repr(e))
                continue
            _spool.complete(spool_dir, c, res["x"], iiter=res["iiter"],
                            status=res["status"])
            solved += 1
            _metrics.inc("serve.worker.solved")
    daemon.drain()
    _metrics.set_gauge("serve.worker.up", 0)
    _trace.event("serve.worker_exit", cat="serving", solved=solved)
    return solved


def serve_job(argv: Sequence[str], num_workers: int, spool_dir: str, *,
              max_relaunches: int = 2, **launch_kwargs):
    """A supervised serve-forever fleet (JAX ``service.py:180-208``).

    ``argv`` is the worker command line (the placeholders of
    :func:`~..resilience.supervisor.launch_job`); each worker calls
    :func:`worker_main` on ``spool_dir``. Before each relaunch the
    supervisor's ``on_relaunch`` hook moves the dead attempt's claimed
    requests back to pending (``spool.recover_claimed``), and a last
    sweep runs when the job ends, so a terminal failure still gives its
    orphans back. Returns the :class:`~..resilience.supervisor.JobResult`
    (relaunches on the ``supervisor.relaunches`` counter)."""
    from ..resilience.supervisor import launch_job
    _spool.init_spool(spool_dir)

    def _recover(next_attempt: int, failure) -> None:
        requeued, quarantined = _spool.recover_claimed(spool_dir)
        _trace.event("serve.relaunch_recover", cat="serving",
                     attempt=next_attempt, requeued=requeued,
                     quarantined=quarantined,
                     failure_kind=getattr(failure, "kind", None))

    result = launch_job(argv, num_workers, max_relaunches=max_relaunches,
                        on_relaunch=_recover, **launch_kwargs)
    _spool.recover_claimed(spool_dir)
    return result
