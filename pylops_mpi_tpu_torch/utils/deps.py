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

__all__ = ["KNOBS", "SERVICE_KNOBS", "RESILIENCE_KNOBS", "apply_environment",
           "precond_default", "mg_levels_default", "ca_mode", "ca_s_default",
           "refine_enabled"]

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
     "solvers (auto waits for the cost model and raises)"),
    ("PYLOPS_MPI_TPU_TORCH_CA_S", "int >= 2", "4", "solvers/ca.py",
     "s-step depth of the CA Gram mode"),
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
