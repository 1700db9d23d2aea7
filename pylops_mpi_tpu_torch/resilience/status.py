"""Solver status words and the guard gate.

PyTorch counterpart of ``pylops_mpi_tpu/resilience/status.py:57-180``.
With guards on, the fused CG/CGLS loops and the block solvers carry a
status word computed from the recurrence scalars they already hold, on
the device, with no extra host synchronisation:

- ``CONVERGED`` / ``MAXITER``: the two normal exits, resolved after the
  loop.
- ``BREAKDOWN``: a NaN/Inf step, momentum or norm scalar. The poisoned
  update is rejected, so ``x`` is the last finite iterate, and the loop
  (or, in a block solve, that column) stops.
- ``STAGNATION``: the best residual has not improved for
  ``PYLOPS_MPI_TPU_TORCH_GUARD_STALL`` iterations in a row (default 50,
  floored at 2); a solve parked at the machine-precision floor is done,
  not stagnant, and does not count.

``PYLOPS_MPI_TPU_TORCH_GUARDS`` (``off`` by default, ``on``) is the
default of every ``guards=None``; ``guards=True``/``False`` beat it. The
public ``cg``/``cgls``/``block_cg``/``block_cgls`` keep their return
values either way and publish the verdict here (:func:`last_status`);
``cg_guarded``/``cgls_guarded`` return it.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional

from ..diagnostics import metrics as _metrics
from ..diagnostics import trace as _trace

__all__ = ["RUNNING", "CONVERGED", "MAXITER", "BREAKDOWN", "STAGNATION",
           "STATUS_NAMES", "status_name", "guards_mode", "guards_enabled",
           "stall_window", "record", "record_columns", "last_status",
           "clear_statuses"]

RUNNING = 0
CONVERGED = 1
MAXITER = 2
BREAKDOWN = 3
STAGNATION = 4

STATUS_NAMES = {RUNNING: "running", CONVERGED: "converged",
                MAXITER: "maxiter", BREAKDOWN: "breakdown",
                STAGNATION: "stagnation"}

_warned_mode = False


def status_name(code) -> str:
    """The name of a status code (``status<code>`` for an unknown
    one)."""
    return STATUS_NAMES.get(int(code), f"status{int(code)}")


def guards_mode() -> str:
    """``PYLOPS_MPI_TPU_TORCH_GUARDS`` resolved to ``off``/``on``
    (``1``/``true`` count as on; unknown values warn once and stay
    off)."""
    global _warned_mode
    m = os.environ.get("PYLOPS_MPI_TPU_TORCH_GUARDS", "off").strip().lower()
    if m in ("", "0", "none", "default"):
        m = "off"
    if m in ("1", "true"):
        m = "on"
    if m not in ("off", "on"):
        if not _warned_mode:
            import warnings
            warnings.warn(
                f"PYLOPS_MPI_TPU_TORCH_GUARDS={m!r} is not one of "
                "['off', 'on']; guards stay off", stacklevel=2)
            _warned_mode = True
        m = "off"
    return m


def guards_enabled(user=None) -> bool:
    """A call's ``guards=`` (``True``/``False``) or, for ``None``, the
    knob."""
    if isinstance(user, bool):
        return user
    if user is not None:
        raise ValueError(f"guards={user!r}: expected True, False or None")
    return guards_mode() == "on"


def stall_window() -> int:
    """``PYLOPS_MPI_TPU_TORCH_GUARD_STALL`` (default 50, floored at 2)."""
    try:
        v = int(os.environ.get("PYLOPS_MPI_TPU_TORCH_GUARD_STALL", "50"))
    except ValueError:
        v = 50
    return max(2, v)


_LOCK = threading.Lock()
_LAST: Dict[str, Dict] = {}


def record(solver: str, code: int, iiter: int) -> None:
    """Publish a guarded solve's verdict under ``solver``."""
    info = {"status": int(code), "status_name": status_name(code),
            "iiter": int(iiter)}
    with _LOCK:
        _LAST[solver] = info
    _metrics.inc(f"guards.{solver}.{status_name(code)}")
    _trace.event("solver.status", cat="resilience", solver=solver, **info)


def record_columns(solver: str, codes, iiter: int) -> None:
    """Publish a guarded block solve's verdicts, one a column: ``status``
    is the worst column's, ``columns``/``column_names`` all of them."""
    codes = [int(c) for c in codes]
    worst = max(codes) if codes else CONVERGED
    info = {"status": worst, "status_name": status_name(worst),
            "iiter": int(iiter), "columns": codes,
            "column_names": [status_name(c) for c in codes]}
    with _LOCK:
        _LAST[solver] = info
    for c in codes:
        _metrics.inc(f"guards.{solver}.{status_name(c)}")
    _trace.event("solver.status", cat="resilience", solver=solver, **info)


def last_status(solver: str) -> Optional[Dict]:
    """The newest guarded verdict of ``solver`` (``"cg"``, ``"cgls"``,
    ``"block_cg"``, ``"block_cgls"``), or ``None``."""
    with _LOCK:
        info = _LAST.get(solver)
        return dict(info) if info else None


def clear_statuses() -> None:
    with _LOCK:
        _LAST.clear()
