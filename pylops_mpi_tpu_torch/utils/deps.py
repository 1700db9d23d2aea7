"""Environment configuration.

PyTorch counterpart of ``pylops_mpi_tpu/utils/deps.py``, holding only
the knobs this port reads, under the prefix ``PYLOPS_MPI_TPU_TORCH_``.
Parsing, floors and the one-time warning on an unknown value are the
JAX package's (``utils/deps.py:402-418``, ``:431-449``, ``:482-491``).

:func:`apply_environment` pins true-f32 products: PyTorch may run f32
matrix products and convolutions in TF32 (about three decimal digits)
when ``allow_tf32`` is set, which would break numeric parity with the
JAX package, whose import pins ``jax_default_matmul_precision=highest``.
Narrow storage stays available explicitly through ``compute_dtype``.
"""

from __future__ import annotations

import os
import warnings

import torch

__all__ = ["KNOBS", "SERVICE_KNOBS", "RESILIENCE_KNOBS", "spill_mode",
           "apply_environment",
           "precond_default", "mg_levels_default", "ca_mode", "ca_s_default",
           "refine_enabled", "reduce_stall_steps", "batch_default"]

# (name, values, default, consumer module, one-line purpose)
KNOBS = [
    ("PYLOPS_MPI_TPU_TORCH_PRECISION", "f32|bf16|c64", "f32",
     "ops/_precision.py",
     "storage-precision policy for operators built with "
     "compute_dtype=None"),
    ("PYLOPS_MPI_TPU_TORCH_PRECOND", "none|jacobi|block_jacobi|mg", "none",
     "ops/precond.py",
     "preconditioner make_precond builds when called without kind="),
    ("PYLOPS_MPI_TPU_TORCH_MG_LEVELS", "int >= 1", "3", "ops/precond.py",
     "V-cycle depth when VCyclePrecond is built without levels="),
    ("PYLOPS_MPI_TPU_TORCH_CA", "off|pipelined|sstep|auto", "off",
     "solvers/ca.py",
     "communication-avoiding engine of the fused cg/cgls and block "
     "solvers (auto: the cost model's latency term, never sstep)"),
    ("PYLOPS_MPI_TPU_TORCH_CA_S", "int >= 2", "4", "solvers/ca.py",
     "s-step depth of the CA Gram mode"),
    ("PYLOPS_MPI_TPU_TORCH_REDUCE_STALL", "int >= 0", "0",
     "parallel/collectives.py",
     "serial device ops chained onto every CA reduction (a latency "
     "stand-in; 0 off)"),
    ("PYLOPS_MPI_TPU_TORCH_BATCH", "int >= 1", "1", "tuning/plan.py",
     "block width of the solves a plan serves (extra['batch'] of the "
     "plan contexts)"),
]

# the solve service's knobs and those of the layers under it, with the
# JAX package's defaults (same tuple layout as KNOBS)
SERVICE_KNOBS = [
    ("PYLOPS_MPI_TPU_TORCH_GUARDS", "off|on", "off", "resilience/status.py",
     "guard carry (status word) in cg/cgls/block_cg/block_cgls when "
     "guards=None"),
    ("PYLOPS_MPI_TPU_TORCH_GUARD_STALL", "int >= 2", "50",
     "resilience/status.py",
     "iterations without a new best residual before STAGNATION"),
    ("PYLOPS_MPI_TPU_TORCH_TRACE", "off|spans|full", "off",
     "diagnostics/trace.py", "span tracer"),
    ("PYLOPS_MPI_TPU_TORCH_TRACE_FILE", "path", "", "diagnostics/trace.py",
     "flush the trace buffer there at exit and on SIGTERM"),
    ("PYLOPS_MPI_TPU_TORCH_TRACE_BUFFER", "int >= 1024", "65536",
     "diagnostics/trace.py", "events the trace buffer keeps"),
    ("PYLOPS_MPI_TPU_TORCH_METRICS", "off|on", "off",
     "diagnostics/metrics.py", "counters, gauges and histograms"),
    ("PYLOPS_MPI_TPU_TORCH_METRICS_FILE", "path", "",
     "diagnostics/metrics.py", "periodic metrics snapshot file"),
    ("PYLOPS_MPI_TPU_TORCH_METRICS_INTERVAL", "float >= 0.05", "5.0",
     "diagnostics/metrics.py", "seconds between snapshot writes"),
    ("PYLOPS_MPI_TPU_TORCH_HEARTBEAT", "float >= 0.05", "1.0",
     "resilience/elastic.py", "seconds between heartbeats"),
    ("PYLOPS_MPI_TPU_TORCH_HEARTBEAT_FILE", "path", "",
     "resilience/elastic.py", "heartbeat file (set when supervised)"),
    ("PYLOPS_MPI_TPU_TORCH_RETRIES", "int >= 0", "3", "resilience/retry.py",
     "extra attempts of retry_call and of a spooled request"),
    ("PYLOPS_MPI_TPU_TORCH_RETRY_BACKOFF", "float >= 0", "0.5",
     "resilience/retry.py", "first retry sleep in seconds (doubling)"),
    ("PYLOPS_MPI_TPU_TORCH_RETRY_JITTER", "float in [0, 1]", "0",
     "resilience/retry.py", "fraction by which a retry sleep may shrink"),
    ("PYLOPS_MPI_TPU_TORCH_SERVE_K_BUCKETS", "comma-separated ints",
     "1,2,4,8,16", "serving/engine.py", "block widths of packed solves"),
    ("PYLOPS_MPI_TPU_TORCH_SERVE_QUEUE", "int >= 1", "1024",
     "serving/queue.py", "admission queue bound"),
    ("PYLOPS_MPI_TPU_TORCH_SERVE_WINDOW_MS", "float >= 0", "10",
     "serving/queue.py", "batch-formation window in milliseconds"),
    ("PYLOPS_MPI_TPU_TORCH_SERVE_DRAIN_TIMEOUT", "float >= 0", "30",
     "serving/service.py", "graceful drain bound in seconds"),
    ("PYLOPS_MPI_TPU_TORCH_TUNE_CACHE", "path", "", "tuning/cache.py",
     "plan-cache file (memory only when unset)"),
    ("PYLOPS_MPI_TPU_TORCH_AOT", "off|on|auto", "off", "aot/store.py",
     "run the fused solver loops as captured CUDA graphs (auto is off: "
     "no disk bank)"),
    ("PYLOPS_MPI_TPU_TORCH_TUNE", "off|on|auto", "off", "tuning/plan.py",
     "plan seam of the operator constructors (on: replay or cost model; "
     "auto: measure a miss where a factory is given)"),
    ("PYLOPS_MPI_TPU_TORCH_TUNE_BUDGET", "int seconds", "",
     "tuning/search.py", "wall budget of one search (default: the "
     "'tune' stage budget)"),
    ("PYLOPS_MPI_TPU_TORCH_TUNE_TOPK", "int >= 1", "4", "tuning/search.py",
     "seed-ranked candidates timed (the default always among them)"),
    ("PYLOPS_MPI_TPU_TORCH_TUNE_MARGIN", "float >= 0", "0.02",
     "tuning/search.py", "fraction a candidate must beat the default by"),
    ("PYLOPS_MPI_TPU_TORCH_TELEMETRY", "auto|on|off", "auto",
     "diagnostics/telemetry.py",
     "per-iteration solver scalars (auto: on under TRACE=full)"),
]


# the resilience tier's knobs (same tuple layout as KNOBS)
RESILIENCE_KNOBS = [
    ("PYLOPS_MPI_TPU_TORCH_RESTARTS", "int >= 0", "2",
     "resilience/driver.py",
     "precision-escalation restarts of resilient_solve"),
    ("PYLOPS_MPI_TPU_TORCH_REFINE", "0|1", "0", "resilience/driver.py",
     "route resilient_solve with a factory through refined_solve"),
    ("PYLOPS_MPI_TPU_TORCH_SEGMENT", "int >= 0", "0",
     "solvers/segmented.py",
     "iterations an epoch of a segmented solve (0: one epoch)"),
    ("PYLOPS_MPI_TPU_TORCH_WATCHDOG", "auto|on|off", "auto",
     "resilience/elastic.py",
     "collective watchdog (auto: on when supervised)"),
    ("PYLOPS_MPI_TPU_TORCH_WATCHDOG_TIMEOUT", "float seconds", "",
     "resilience/elastic.py",
     "every watched stage's deadline (default: the stage budget)"),
    ("PYLOPS_MPI_TPU_TORCH_CKPT_BACKEND", "native|shards", "native",
     "utils/checkpoint.py",
     "checkpoint backend (shards: one file a rank, no gather)"),
    # the bounded-memory resharding tier and in-place recovery
    ("PYLOPS_MPI_TPU_TORCH_RESHARD_BUDGET", "bytes, k/m/g suffix", "",
     "parallel/reshard.py",
     "peak scratch of a move (unset: unbounded, one chunk)"),
    ("PYLOPS_MPI_TPU_TORCH_SPILL", "auto|on|off", "auto",
     "parallel/spill.py",
     "host staging of moves the budget refuses (on: every move)"),
    ("PYLOPS_MPI_TPU_TORCH_FABRIC", "DxI", "", "parallel/topology.py",
     "declare D hosts of I ranks (default: the ranks' host names)"),
    ("PYLOPS_MPI_TPU_TORCH_INPLACE", "auto|on|off", "auto",
     "resilience/elastic.py (resilience/supervisor.py)",
     "launch_job's in-place recovery (on: by default, off: never, "
     "auto: as its inplace= says)"),
    ("PYLOPS_MPI_TPU_TORCH_QUORUM", "float in (0, 1]", "0.5",
     "resilience/elastic.py (resilience/supervisor.py)",
     "share of the world that must survive for the in-place path "
     "(launch_job's quorum=None)"),
    ("PYLOPS_MPI_TPU_TORCH_RECONFIG_FILE", "path", "",
     "resilience/elastic.py", "set by launch_job(inplace=True)"),
    ("PYLOPS_MPI_TPU_TORCH_FAULT_KILL_RESHARD", "int >= 1", "",
     "resilience/faults.py", "SIGKILL at the Nth reshard step"),
    ("PYLOPS_MPI_TPU_TORCH_FAULT_KILL_SPILL", "int >= 1", "",
     "resilience/faults.py", "SIGKILL at the Nth host-staged chunk"),
]


def refine_enabled() -> bool:
    """``PYLOPS_MPI_TPU_TORCH_REFINE=1``: ``resilient_solve`` with an
    operator factory runs :func:`~..resilience.driver.refined_solve`
    (narrow inner solves, wide corrections)."""
    return os.environ.get("PYLOPS_MPI_TPU_TORCH_REFINE", "0") == "1"


def apply_environment() -> None:
    """Pin full-f32 matrix products and convolutions (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _int_knob(name: str, default: int, floor: int) -> int:
    """An integer knob floored at ``floor``; a malformed value takes the
    default rather than breaking the caller."""
    try:
        v = int(os.environ.get(name, str(default)))
    except ValueError:
        v = default
    return max(floor, v)


def precond_default() -> str:
    """``PYLOPS_MPI_TPU_TORCH_PRECOND``: the preconditioner kind
    :func:`~..ops.precond.make_precond` builds without an explicit
    ``kind``."""
    return os.environ.get("PYLOPS_MPI_TPU_TORCH_PRECOND", "none").strip() \
        .lower() or "none"


def mg_levels_default() -> int:
    """``PYLOPS_MPI_TPU_TORCH_MG_LEVELS``: V-cycle depth (floored at 1)."""
    return _int_knob("PYLOPS_MPI_TPU_TORCH_MG_LEVELS", 3, 1)


_warned_ca = False


def ca_mode() -> str:
    """``PYLOPS_MPI_TPU_TORCH_CA`` resolved to ``off``/``pipelined``/
    ``sstep``/``auto``; an unknown value falls back to ``off`` with a
    one-time warning (a typo must not silently swap solver engines)."""
    global _warned_ca
    m = os.environ.get("PYLOPS_MPI_TPU_TORCH_CA", "off").strip().lower()
    if m in ("", "none", "default", "0", "classic"):
        m = "off"
    if m not in ("off", "pipelined", "sstep", "auto"):
        if not _warned_ca:
            warnings.warn(
                f"PYLOPS_MPI_TPU_TORCH_CA={m!r} is not one of "
                "['off', 'pipelined', 'sstep', 'auto']; using 'off'",
                stacklevel=2)
            _warned_ca = True
        m = "off"
    return m


def ca_s_default() -> int:
    """``PYLOPS_MPI_TPU_TORCH_CA_S``: s-step depth (floored at 2)."""
    return _int_knob("PYLOPS_MPI_TPU_TORCH_CA_S", 4, 2)


def reduce_stall_steps() -> int:
    """``PYLOPS_MPI_TPU_TORCH_REDUCE_STALL``: the serial device ops
    chained onto every reduction of the CA engines (0, unset or
    malformed: off; JAX ``utils/deps.py:493-503``)."""
    try:
        v = int(os.environ.get("PYLOPS_MPI_TPU_TORCH_REDUCE_STALL", "0"))
    except ValueError:
        v = 0
    return max(0, v)


def batch_default() -> int:
    """``PYLOPS_MPI_TPU_TORCH_BATCH``: the block width of the solves a
    plan serves, forwarded as ``extra["batch"]`` so that a plan measured
    at one width never replays at another (floored at 1; JAX
    ``utils/deps.py:655-665``)."""
    return _int_knob("PYLOPS_MPI_TPU_TORCH_BATCH", 1, 1)


_warned_spill = False


def spill_mode() -> str:
    """``PYLOPS_MPI_TPU_TORCH_SPILL`` resolved to ``auto``/``on``/``off``
    (JAX ``utils/deps.py:563``; an unknown value warns once and counts
    as ``auto``). ``off`` keeps the planner's refusal of a move whose
    budget cannot hold one row; ``auto`` (the default) stages through
    host RAM only the moves the device planner would refuse, so every
    move that succeeds keeps its device plan; ``on`` stages every
    move."""
    global _warned_spill
    m = os.environ.get("PYLOPS_MPI_TPU_TORCH_SPILL", "auto").strip().lower()
    if m in ("", "none", "default"):
        m = "auto"
    if m not in ("auto", "on", "off"):
        if not _warned_spill:
            import warnings
            warnings.warn(f"PYLOPS_MPI_TPU_TORCH_SPILL={m!r} is not one of "
                          "['auto', 'on', 'off']; using 'auto'", stacklevel=2)
            _warned_spill = True
        m = "auto"
    return m
