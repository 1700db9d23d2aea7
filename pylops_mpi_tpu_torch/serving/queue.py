"""Admission queue and continuous batcher for single-RHS requests.

PyTorch counterpart of ``pylops_mpi_tpu/serving/queue.py``. Block CGLS
at K=16 solves many more requests a second than sixteen sequential
solves, but only when requests arrive together; interactive traffic
arrives one right-hand side at a time. The :class:`AdmissionQueue` holds
arriving requests; the :class:`Dispatcher` drains them into packed
``(N, K)`` block solves on the :class:`~.engine.WarmPool`.

A batch of one family dispatches when the first of these holds:

1. **Full**: ``k_max`` (the largest bucket) requests of the family wait.
2. **Window expired**: the oldest waiting request has waited
   ``PYLOPS_MPI_TPU_TORCH_SERVE_WINDOW_MS`` (default 10 ms).
3. **Deadline near**: a waiting request's ``deadline_ts`` is within the
   dispatcher's solve-time estimate; the batch leaves undersized
   (``serve.deadline_forced``).

Every batch runs under a
:class:`~..diagnostics.profiler.DeadlineRunner` with the
``serve_batch`` budget and the batch's earliest deadline: a batch whose
deadline has passed is skipped and its tickets fail at once; a batch
whose solve raises fails its tickets with the error
(``serve.batch_errors``). A ticket never resolves silently wrong.

Backpressure: :meth:`AdmissionQueue.submit` raises :class:`QueueFull`
once the queue holds ``PYLOPS_MPI_TPU_TORCH_SERVE_QUEUE`` requests
(default 1024) or drains (``serve.rejects``, ``serve.queue.depth``).
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..diagnostics import metrics as _metrics
from ..diagnostics import trace as _trace
from ..diagnostics.profiler import DeadlineRunner, stage_budget
from .engine import WarmPool, bucket_for

__all__ = ["queue_bound", "batch_window_s", "QueueFull", "Ticket",
           "SolveRequest", "AdmissionQueue", "pack", "Dispatcher"]


def queue_bound() -> int:
    """``PYLOPS_MPI_TPU_TORCH_SERVE_QUEUE`` admission-queue depth bound
    (default 1024, floored at 1)."""
    try:
        v = int(os.environ.get("PYLOPS_MPI_TPU_TORCH_SERVE_QUEUE", "1024"))
    except ValueError:
        v = 1024
    return max(1, v)


def batch_window_s() -> float:
    """``PYLOPS_MPI_TPU_TORCH_SERVE_WINDOW_MS`` batch-formation window in
    SECONDS (default 0.010; floored at 0 — zero means dispatch
    whatever is waiting, the lowest-latency setting)."""
    try:
        v = float(os.environ.get("PYLOPS_MPI_TPU_TORCH_SERVE_WINDOW_MS", "10"))
    except ValueError:
        v = 10.0
    return max(0.0, v) / 1000.0


class QueueFull(RuntimeError):
    """Admission rejected: queue at its bound (or draining). The
    caller's backpressure signal — retry with backoff, shed load, or
    scale out."""


class Ticket:
    """The caller's handle for one submitted request: block on
    :meth:`wait` for the :class:`RequestResult`, or poll
    :meth:`done`."""

    def __init__(self, request_id: str):
        self.request_id = request_id
        self._event = threading.Event()
        self._result: Optional[Dict] = None
        self._error: Optional[BaseException] = None

    def _resolve(self, result: Dict) -> None:
        self._result = result
        self._event.set()

    def _fail(self, exc: BaseException) -> None:
        self._error = exc
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> Dict:
        """Block until resolved; returns ``{"x", "iiter", "status",
        "wait_s", "queue_s", "batch_k", "bucket"}`` or raises the batch's
        error (or TimeoutError). ``wait_s`` runs from admission to the
        batch's end (the JAX package's measure), ``queue_s`` from
        admission to the batch's dispatch."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.request_id} not resolved in {timeout}s")
        if self._error is not None:
            raise self._error
        return self._result


class SolveRequest:
    """One queued single-RHS request (internal; callers hold the
    :class:`Ticket`)."""

    __slots__ = ("request_id", "family", "y", "deadline_ts", "t_mono",
                 "ticket")

    def __init__(self, request_id: str, family: str, y: np.ndarray,
                 deadline_ts: Optional[float]):
        self.request_id = request_id
        self.family = family
        self.y = y
        self.deadline_ts = deadline_ts    # wall clock (time.time)
        self.t_mono = time.monotonic()    # queue-wait reference
        self.ticket = Ticket(request_id)


def pack(requests: List[SolveRequest],
         buckets: Optional[Tuple[int, ...]] = None
         ) -> Tuple[np.ndarray, int]:
    """Stack a same-family batch into an ``(N, k)`` RHS matrix and pick
    its bucket: the smallest configured width holding all ``k``
    columns (the engine pads the difference with zero columns, which
    the per-column freeze makes exact)."""
    if not requests:
        raise ValueError("cannot pack an empty batch")
    fams = {r.family for r in requests}
    if len(fams) > 1:
        raise ValueError(f"one family per batch, got {sorted(fams)}")
    Y = np.stack([np.asarray(r.y).ravel() for r in requests], axis=1)
    return Y, bucket_for(Y.shape[1], buckets)


class AdmissionQueue:
    """Bounded FIFO of :class:`SolveRequest`\\ s with condition-variable
    handoff to the dispatcher."""

    def __init__(self, bound: Optional[int] = None):
        self.bound = queue_bound() if bound is None else max(1, int(bound))
        self._dq: deque = deque()
        self._cond = threading.Condition()
        self._draining = False
        self._ids = itertools.count()
        self.submitted = 0
        self.rejected = 0

    def depth(self) -> int:
        with self._cond:
            return len(self._dq)

    def submit(self, family: str, y: np.ndarray,
               deadline_ts: Optional[float] = None,
               request_id: Optional[str] = None) -> Ticket:
        """Admit one request or raise :class:`QueueFull` (bound hit, or
        queue draining). Returns the caller's :class:`Ticket`."""
        with self._cond:
            if self._draining:
                self.rejected += 1
                _metrics.inc("serve.rejects")
                raise QueueFull("queue is draining; not admitting")
            if len(self._dq) >= self.bound:
                self.rejected += 1
                _metrics.inc("serve.rejects")
                raise QueueFull(
                    f"admission queue at bound {self.bound} "
                    "(PYLOPS_MPI_TPU_TORCH_SERVE_QUEUE); shed or retry")
            rid = request_id if request_id is not None \
                else f"r{next(self._ids)}"
            req = SolveRequest(rid, family, y, deadline_ts)
            self._dq.append(req)
            self.submitted += 1
            _metrics.inc("serve.requests")
            _metrics.set_gauge("serve.queue.depth", len(self._dq))
            self._cond.notify_all()
            return req.ticket

    def start_drain(self) -> None:
        """Stop admitting; already-queued requests still dispatch."""
        with self._cond:
            self._draining = True
            self._cond.notify_all()

    def collect(self, k_max: int, window_s: float,
                margin_s: float = 0.0, poll_s: float = 0.05
                ) -> Tuple[List[SolveRequest], bool]:
        """Dispatcher side: block until a batch should go, then pop it.

        Returns ``(batch, forced)`` — ``batch`` empty when the poll
        tick elapsed with nothing to do; ``forced`` True when a near
        deadline pushed out an undersized batch. The batch is the
        oldest waiting request's family, FIFO order, at most ``k_max``
        columns; other families stay queued for the next round."""
        with self._cond:
            if not self._dq:
                self._cond.wait(timeout=poll_s)
                if not self._dq:
                    return [], False
            forced = False
            while True:
                first = self._dq[0]
                fam = first.family
                count = sum(1 for r in self._dq if r.family == fam)
                if count >= k_max:
                    break
                age = time.monotonic() - first.t_mono
                if age >= window_s:
                    break
                now = time.time()
                ddls = [r.deadline_ts for r in self._dq
                        if r.family == fam and r.deadline_ts is not None]
                if ddls and min(ddls) - now <= margin_s:
                    forced = True
                    break
                # wake at whichever edge comes first: poll tick, window
                # expiry, or the margin point of the nearest deadline —
                # a fixed poll could overshoot a near deadline past zero
                wait_t = min(poll_s, window_s - age)
                if ddls:
                    wait_t = min(wait_t, min(ddls) - now - margin_s)
                self._cond.wait(timeout=max(0.001, wait_t))
                if not self._dq:
                    return [], False
            taken: List[SolveRequest] = []
            rest: deque = deque()
            for r in self._dq:
                if r.family == fam and len(taken) < k_max:
                    taken.append(r)
                else:
                    rest.append(r)
            self._dq = rest
            _metrics.set_gauge("serve.queue.depth", len(self._dq))
            return taken, forced

    def drain_empty(self, timeout: Optional[float] = None) -> bool:
        """Wait until the queue is empty (dispatched, not necessarily
        resolved). True when empty within ``timeout``."""
        end = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self._dq:
                rem = None if end is None else end - time.monotonic()
                if rem is not None and rem <= 0:
                    return False
                self._cond.wait(timeout=0.05 if rem is None
                                else min(0.05, rem))
        return True


class Dispatcher(threading.Thread):
    """The continuous-batching loop: collect → pack → padded block solve
    → resolve tickets (a daemon thread).

    With :attr:`prewarm` set before :meth:`start` the thread first runs
    :meth:`~.engine.WarmPool.prewarm`, so that the per-thread state of
    the first solves (the cuBLAS handle and workspace) belongs to the
    thread that serves; :attr:`ready` is set when it is done, and a
    prewarm that raised leaves its error in :attr:`prewarm_error` and
    ends the thread.

    It keeps its own bounded statistics (wait and fill samples,
    counters) whatever the metrics knob says, for :meth:`stats`, and
    mirrors them into the metrics registry when that is on.
    """

    def __init__(self, pool: WarmPool, queue: AdmissionQueue, *,
                 window_s: Optional[float] = None,
                 rehearse: bool = False,
                 on_batch: Optional[Callable[[Dict], None]] = None):
        super().__init__(name="pylops-torch-serve-dispatch", daemon=True)
        self.prewarm = False
        self.ready = threading.Event()
        self.prewarm_error: Optional[BaseException] = None
        self.prewarm_report: Optional[Dict] = None
        self.pool = pool
        self.queue = queue
        self.window_s = batch_window_s() if window_s is None \
            else max(0.0, float(window_s))
        self.rehearse = bool(rehearse)
        self.on_batch = on_batch
        self._halt = threading.Event()
        self._inflight = threading.Event()
        self._ewma_wall = 0.0     # solve-time estimate for margins
        self.batches = 0
        self.solves = 0
        self.forced = 0
        self.failed = 0
        self.wait_samples: deque = deque(maxlen=4096)
        self.fill_samples: deque = deque(maxlen=4096)
        self._t_solving = 0.0
        self._t_started = time.monotonic()

    def _margin_s(self) -> float:
        # dispatch early enough that the estimated solve still lands
        # inside the deadline; 1.5× EWMA + 10 ms floor absorbs jitter
        return 1.5 * self._ewma_wall + 0.010

    def run(self) -> None:
        if self.prewarm:
            try:
                self.prewarm_report = self.pool.prewarm()
            except BaseException as e:  # start() re-raises it
                self.prewarm_error = e
        self.ready.set()
        if self.prewarm_error is not None:
            return
        while not self._halt.is_set():
            batch, forced = self.queue.collect(
                self.pool.k_max, self.window_s,
                margin_s=self._margin_s())
            if not batch:
                continue
            self._inflight.set()
            try:
                self._dispatch(batch, forced)
            finally:
                self._inflight.clear()

    def _dispatch(self, batch: List[SolveRequest], forced: bool) -> None:
        t_out = time.monotonic()
        Y, bucket = pack(batch, self.pool.buckets)
        k = len(batch)
        deadlines = [r.deadline_ts for r in batch
                     if r.deadline_ts is not None]
        runner = DeadlineRunner(
            deadline_ts=min(deadlines) if deadlines else None,
            min_stage_s=0)
        budget = stage_budget("serve_batch", rehearse=self.rehearse)
        fam = batch[0].family

        def _solve(_eff_timeout):
            return self.pool.solve(fam, Y), None

        rec = runner.run("serve_batch", _solve, budget)
        now_mono = time.monotonic()
        waits = [now_mono - r.t_mono for r in batch]
        self.batches += 1
        self.solves += k
        self.wait_samples.extend(waits)
        self.fill_samples.append(k / bucket)
        if forced:
            self.forced += 1
            _metrics.inc("serve.deadline_forced")
        _metrics.inc("serve.batches")
        _metrics.inc("serve.solves", k)
        for w in waits:
            _metrics.observe("serve.queue.wait_s", w)
        outcome = rec.result
        if rec.get("skipped") or outcome is None:
            self.failed += k
            _metrics.inc("serve.deadline_missed" if rec.get("skipped")
                         else "serve.batch_errors")
            reason = rec.get("reason") or rec.get("error") \
                or "batch solve failed"
            for r in batch:
                r.ticket._fail(RuntimeError(
                    f"request {r.request_id}: {reason}"))
            return
        self._t_solving += outcome.wall_s
        self._ewma_wall = outcome.wall_s if self._ewma_wall == 0 \
            else 0.7 * self._ewma_wall + 0.3 * outcome.wall_s
        rate = k / outcome.wall_s if outcome.wall_s > 0 else 0.0
        _metrics.set_gauge("serve.solves_per_sec", rate)
        for j, r in enumerate(batch):
            r.ticket._resolve({
                "x": outcome.x[:, j],
                "iiter": outcome.iiter,
                "status": outcome.statuses[j],
                "wait_s": waits[j],
                "queue_s": t_out - r.t_mono,
                "batch_k": k,
                "bucket": bucket,
            })
        _trace.event("serve.batch", cat="serving", family=fam, fill=k,
                     bucket=bucket, forced=forced,
                     wall_s=round(outcome.wall_s, 4))
        if self.on_batch is not None:
            try:
                self.on_batch({"family": fam, "fill": k,
                               "bucket": bucket, "forced": forced,
                               "wall_s": outcome.wall_s})
            except Exception:
                pass

    # ------------------------------------------------------------ stats
    def stats(self) -> Dict:
        """The backpressure/autoscaling report: queue depth, admission
        counters, batch fill, solves/sec (solve-wall basis), and
        p50/p99 time-in-queue over the recent window."""
        waits = list(self.wait_samples)
        fills = list(self.fill_samples)
        p50, p99 = _metrics.quantiles(waits, (0.50, 0.99))
        return {
            "queue_depth": self.queue.depth(),
            "queue_bound": self.queue.bound,
            "submitted": self.queue.submitted,
            "rejected": self.queue.rejected,
            "batches": self.batches,
            "solves": self.solves,
            "forced": self.forced,
            "failed": self.failed,
            "fill_mean": (sum(fills) / len(fills)) if fills else 0.0,
            "solves_per_sec": (self.solves / self._t_solving
                               if self._t_solving > 0 else 0.0),
            "wait_p50_s": p50,
            "wait_p99_s": p99,
        }

    def idle(self) -> bool:
        return not self._inflight.is_set() and self.queue.depth() == 0

    def stop(self, timeout: float = 5.0) -> None:
        self._halt.set()
        if self.is_alive():
            self.join(timeout=timeout)
