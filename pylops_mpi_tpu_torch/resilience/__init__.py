"""Solver status words, bounded retry, heartbeats and the drain.

PyTorch counterpart of part of ``pylops_mpi_tpu/resilience``:
:mod:`.status` (the guards' status word and gate), :mod:`.retry` and the
serving half of :mod:`.elastic`. The supervisor (``launch_job``,
``serve_job``), the fault injection of ``faults.py``, the
precision-escalating ``resilient_solve`` and the collective watchdog are
ROADMAP.md §A.7.
"""

from . import elastic, retry, status
from .elastic import (HeartbeatWriter, start_heartbeat, stop_heartbeat,
                      maybe_start_heartbeat, read_heartbeat, request_drain,
                      drain_requested, reset_drain, install_sigterm_drain)
from .retry import retry_call
from .status import (RUNNING, CONVERGED, MAXITER, BREAKDOWN, STAGNATION,
                     status_name, guards_mode, guards_enabled, last_status)

__all__ = ["elastic", "retry", "status",
           "HeartbeatWriter", "start_heartbeat", "stop_heartbeat",
           "maybe_start_heartbeat", "read_heartbeat", "request_drain",
           "drain_requested", "reset_drain", "install_sigterm_drain",
           "retry_call",
           "RUNNING", "CONVERGED", "MAXITER", "BREAKDOWN", "STAGNATION",
           "status_name", "guards_mode", "guards_enabled", "last_status"]
