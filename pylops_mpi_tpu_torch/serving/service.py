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

Under a process group the daemon runs on every rank (JAX
``service.py:54-118`` serves from the controller, whose batch every
device then solves). Rank 0 owns the admission queue and the dispatcher:
for each batch it packs, its pool first broadcasts a header (the
family's index, the fill ``k``, the bucket and a stop flag) and then the
``(n, bucket)`` right-hand sides, and every rank then calls
:meth:`~.engine.WarmPool.solve` on that batch, the SPMD contract of
every entry point of the port. The other ranks run
:meth:`SolveDaemon.follow` until rank 0's :meth:`~SolveDaemon.drain`
sends the stop flag. Rank 0 resolves the tickets. :func:`worker_main`
over a group claims from the spool and banks on rank 0 only; the other
ranks follow. A rank that dies is the watchdog's business
(:mod:`~..resilience.elastic`).

Without a group, or across cards that share no group, run one worker
per card on a shared spool. :func:`serve_job` runs such a fleet under
the supervisor (:func:`~..resilience.supervisor.launch_job`), sweeping a
dead attempt's claimed requests back to pending before each relaunch.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..diagnostics import metrics as _metrics
from ..diagnostics import trace as _trace
from ..ops._precision import as_torch_dtype
from ..parallel import collectives
from ..parallel.mesh import initialized, rank, world_size
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


# header of one batch sent from rank 0: family index, fill, bucket, stop
_HEADER = 4


def _grouped() -> bool:
    return initialized() and world_size() > 1


def _wire_device():
    """Where the broadcasts travel: the current card under NCCL, the host
    under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _send_header(fam: int, k: int, bucket: int, stop: int):
    h = torch.tensor([fam, k, bucket, stop], dtype=torch.int64,
                     device=_wire_device())
    collectives.broadcast(h, 0)


class SolveDaemon:
    """One process's solve service (see the module docstring).
    ``start(prewarm=True)`` prewarms the pool on the dispatcher's thread
    before it returns."""

    def __init__(self, pool: WarmPool, *,
                 window_s: Optional[float] = None,
                 queue_bound: Optional[int] = None,
                 rehearse: bool = False):
        self.pool = pool
        self.queue = AdmissionQueue(bound=queue_bound)
        self.dispatcher = Dispatcher(pool, self.queue, window_s=window_s,
                                     rehearse=rehearse)
        self._started = False
        self.followed = 0

    def _announce(self, name: str, k: int, Y: np.ndarray) -> None:
        """Rank 0, inside the pool's solve: send the batch to the other
        ranks (header, then the padded right-hand sides)."""
        _send_header(self.pool.families().index(name), k, Y.shape[1], 0)
        collectives.broadcast(torch.as_tensor(Y).to(_wire_device()), 0)

    def follow(self) -> int:
        """A rank other than 0: solve every batch rank 0 sends, until its
        drain sends the stop flag. Returns the batches solved."""
        if not _grouped() or rank() == 0:
            raise RuntimeError("follow() runs on ranks other than 0 of a "
                               "process group; rank 0 starts the daemon")
        names = self.pool.families()
        while True:
            h = torch.zeros(_HEADER, dtype=torch.int64, device=_wire_device())
            fam, k, bucket, stop = (int(v) for v in
                                    collectives.broadcast(h, 0).cpu())
            if stop:
                break
            spec = self.pool.family(names[fam])
            Y = torch.zeros((spec.nrows, bucket),
                            dtype=as_torch_dtype(spec.dtype),
                            device=_wire_device())
            Y = collectives.broadcast(Y, 0).cpu().numpy()
            try:
                self.pool.solve(names[fam], Y[:, :k])
            except Exception as e:  # rank 0 fails the batch's tickets
                _trace.event("serve.follow_error", cat="serving",
                             family=names[fam], error=repr(e))
            self.followed += 1
        _trace.event("serve.follow_stop", cat="serving",
                     batches=self.followed)
        return self.followed

    def start(self, prewarm: bool = False) -> "SolveDaemon":
        """Start the dispatcher (once), with ``prewarm`` run first on its
        thread; a prewarm that raised is raised here. Under a group only
        rank 0 starts; the other ranks :meth:`follow`."""
        if _grouped() and rank() != 0:
            raise RuntimeError(
                f"rank {rank()} follows rank 0's daemon: call follow()")
        if not self._started:
            if _grouped():
                self.pool._announce = self._announce
            self.dispatcher.prewarm = bool(prewarm)
            self.dispatcher.start()
            self.dispatcher.ready.wait()
            if self.dispatcher.prewarm_error is not None:
                if _grouped():
                    self._stop_followers()
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

    def _stop_followers(self) -> None:
        """Rank 0: wait out the dispatcher and the batch it runs (their
        collectives must end before the stop flag's broadcast), then,
        holding the pool's lock, send the other ranks the stop flag and
        give the pool back to direct calls, which every rank makes."""
        if self.dispatcher.is_alive():
            self.dispatcher.join()
        with self.pool._lock:
            _send_header(0, 0, 0, 1)
            self.pool._announce = None

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Refuse new admissions, wait (up to ``timeout``, default the
        drain knob) for the queue to empty and the batch in flight to
        resolve, then stop the dispatcher; under a group, wait for the
        dispatcher's last batch and send the other ranks the stop flag.
        True when fully drained."""
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
        if self._started and _grouped():
            self._stop_followers()
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
    after that long without work. Under a process group rank 0 does all
    of this and the other ranks follow its batches (returning 0)."""
    from ..resilience import elastic
    elastic.maybe_start_heartbeat()
    if _grouped() and rank() != 0:
        SolveDaemon(pool, window_s=window_s).follow()
        return 0
    _spool.init_spool(spool_dir)
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
