"""The solve service: continuous batching over the block solvers.

PyTorch counterpart of ``pylops_mpi_tpu/serving``, which turns one-shot
solvers into a long-lived service for single-RHS traffic:

- :mod:`.engine`: :class:`WarmPool`, the registered operator families
  and their packed, zero-padded block solves per K bucket, prewarmed
  before traffic;
- :mod:`.queue`: :class:`AdmissionQueue` (bounded, rejecting) and
  :class:`Dispatcher` (full bucket, window expiry or a near deadline
  dispatches; every batch under a ``DeadlineRunner``);
- :mod:`.spool`: the durable filesystem queue between processes;
- :mod:`.service`: :class:`SolveDaemon` and :func:`worker_main`.
"""

from . import engine, queue, service, spool
from .engine import (FamilySpec, WarmPool, BlockOutcome, k_buckets,
                     bucket_for)
from .queue import (AdmissionQueue, Dispatcher, QueueFull, Ticket, pack,
                    queue_bound, batch_window_s)
from .service import SolveDaemon, worker_main, serve_job, drain_timeout_s

__all__ = ["engine", "queue", "service", "spool",
           "FamilySpec", "WarmPool", "BlockOutcome", "k_buckets",
           "bucket_for",
           "AdmissionQueue", "Dispatcher", "QueueFull", "Ticket",
           "pack", "queue_bound", "batch_window_s",
           "SolveDaemon", "worker_main", "serve_job", "drain_timeout_s"]
