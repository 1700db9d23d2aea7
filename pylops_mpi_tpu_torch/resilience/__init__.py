"""The resilience tier: status words, faults, restarts, supervision.

PyTorch counterpart of ``pylops_mpi_tpu/resilience``. In one process,
over the fused solvers:

- :mod:`.status`: the guards' status word (``converged``/``maxiter``/
  ``breakdown``/``stagnation``) and the ``PYLOPS_MPI_TPU_TORCH_GUARDS``
  gate.
- :mod:`.faults`: the injected NaN and stall, plan-cache corruption and
  flaky callables that prove each recovery path.
- :mod:`.driver`: :func:`resilient_solve` (restarts one precision rung
  wider from the last finite iterate, bf16 → f32 → f64) and
  :func:`refined_solve` (narrow inner solves, wide corrections).
- :mod:`.retry`: bounded retry with backoff.

Across processes:

- :mod:`.elastic`: the worker's side: heartbeat, the collective
  watchdog (:func:`watched_call`), the drain and the bring-up contract
  (:func:`worker_config`, :func:`elastic_initialize`).
- :mod:`.supervisor`: :func:`launch_job`: launch N workers, classify a
  failure (exit, signal, stale heartbeat), kill the attempt and relaunch
  on the shrunk world, which resumes from a checkpoint
  (:mod:`..utils.checkpoint` restores it on the new world); or, with
  ``inplace=True`` and one survivor, keep the survivor alive and hand it
  the shrunk world, which it re-forms and resumes from its banked carry
  (:class:`ElasticReconfig`, :func:`apply_reconfig`,
  :func:`reform_mesh`, :func:`bank_carry`/:func:`restore_carry`).

Segmented solves with checkpoints are :mod:`..solvers.segmented`.
"""

from . import elastic, faults, retry, status, supervisor
from .elastic import (HeartbeatWriter, start_heartbeat, stop_heartbeat,
                      maybe_start_heartbeat, read_heartbeat, request_drain,
                      drain_requested, reset_drain, install_sigterm_drain,
                      WatchdogTimeout, watched_call, watchdog_mode,
                      watchdog_enabled, worker_config, elastic_initialize,
                      WorkerConfig, ElasticReconfig, inplace_mode,
                      inplace_armed, pending_reconfig, apply_reconfig,
                      reform_mesh, bank_carry, restore_carry)
from .retry import retry_call
from .status import (RUNNING, CONVERGED, MAXITER, BREAKDOWN, STAGNATION,
                     status_name, guards_mode, guards_enabled, last_status)
from .driver import (resilient_solve, refined_solve, ResilientResult,
                     RefinedResult)
from .supervisor import launch_job, JobResult, Failure, WorkerHandle

__all__ = ["elastic", "faults", "retry", "status", "supervisor",
           "RUNNING", "CONVERGED", "MAXITER", "BREAKDOWN", "STAGNATION",
           "status_name", "guards_mode", "guards_enabled", "last_status",
           "retry_call", "resilient_solve", "refined_solve",
           "ResilientResult", "RefinedResult",
           "WatchdogTimeout", "watched_call", "watchdog_mode",
           "watchdog_enabled", "HeartbeatWriter", "start_heartbeat",
           "stop_heartbeat", "maybe_start_heartbeat", "read_heartbeat",
           "worker_config", "elastic_initialize", "WorkerConfig",
           "request_drain", "drain_requested", "reset_drain",
           "install_sigterm_drain", "ElasticReconfig", "inplace_mode",
           "inplace_armed", "pending_reconfig", "apply_reconfig",
           "reform_mesh", "bank_carry", "restore_carry",
           "launch_job", "JobResult", "Failure", "WorkerHandle"]
