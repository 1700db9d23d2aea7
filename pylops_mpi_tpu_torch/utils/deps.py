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

__all__ = ["KNOBS", "apply_environment", "precond_default",
           "mg_levels_default", "ca_mode", "ca_s_default"]

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
