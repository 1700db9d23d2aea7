"""Bounded retry with exponential backoff.

PyTorch counterpart of ``pylops_mpi_tpu/resilience/retry.py``. The spool
bounds a request's attempts with :func:`default_retries`; :func:`retry_call`
retries a transient host-side failure (a process group's bring-up, a
file that another process holds).

``PYLOPS_MPI_TPU_TORCH_RETRIES`` extra attempts (default 3, floored at
0), sleeps doubling from ``PYLOPS_MPI_TPU_TORCH_RETRY_BACKOFF`` seconds
(default 0.5, each capped at 30 s), each shrunk by a uniform fraction up
to ``PYLOPS_MPI_TPU_TORCH_RETRY_JITTER`` (default 0, clamped to [0, 1]).
Every retry is a ``resilience.retry`` trace event; the last failure, or
one that ``retry_if`` refuses, propagates unchanged.
"""

from __future__ import annotations

import os
import random
import time
from typing import Callable, Optional, Tuple, Type

from ..diagnostics import metrics as _metrics
from ..diagnostics import trace as _trace

__all__ = ["retry_call", "default_retries", "default_backoff_s",
           "default_jitter"]

_MAX_SLEEP_S = 30.0


def default_retries() -> int:
    """``PYLOPS_MPI_TPU_TORCH_RETRIES`` (default 3, floored at 0)."""
    try:
        v = int(os.environ.get("PYLOPS_MPI_TPU_TORCH_RETRIES", "3"))
    except ValueError:
        v = 3
    return max(0, v)


def default_backoff_s() -> float:
    """``PYLOPS_MPI_TPU_TORCH_RETRY_BACKOFF``: the first sleep in seconds
    (default 0.5, floored at 0)."""
    try:
        v = float(os.environ.get("PYLOPS_MPI_TPU_TORCH_RETRY_BACKOFF",
                                 "0.5"))
    except ValueError:
        v = 0.5
    return max(0.0, v)


def default_jitter() -> float:
    """``PYLOPS_MPI_TPU_TORCH_RETRY_JITTER`` in [0, 1] (default 0)."""
    try:
        v = float(os.environ.get("PYLOPS_MPI_TPU_TORCH_RETRY_JITTER", "0"))
    except ValueError:
        v = 0.0
    return min(1.0, max(0.0, v))


def retry_call(fn: Callable, *args,
               retries: Optional[int] = None,
               backoff_s: Optional[float] = None,
               exceptions: Tuple[Type[BaseException], ...] = (Exception,),
               retry_if: Optional[Callable[[BaseException], bool]] = None,
               jitter: Optional[float] = None,
               describe: str = "call",
               sleep: Callable[[float], None] = time.sleep,
               rng: Optional[random.Random] = None,
               **kwargs):
    """``fn(*args, **kwargs)``, retried up to ``retries`` more times on
    an exception of ``exceptions`` that ``retry_if`` (when given)
    accepts. ``sleep`` and ``rng`` can be injected by tests."""
    retries = default_retries() if retries is None else max(0, retries)
    backoff = default_backoff_s() if backoff_s is None \
        else max(0.0, backoff_s)
    jitter = default_jitter() if jitter is None \
        else min(1.0, max(0.0, jitter))
    attempt = 0
    while True:
        try:
            return fn(*args, **kwargs)
        except exceptions as e:
            if retry_if is not None and not retry_if(e):
                raise
            attempt += 1
            if attempt > retries:
                raise
            wait = min(backoff * (2 ** (attempt - 1)), _MAX_SLEEP_S)
            if jitter > 0.0 and wait > 0.0:
                wait *= 1.0 - jitter * (rng or random).random()
            _metrics.inc("resilience.retries")
            _trace.event("resilience.retry", cat="resilience",
                         what=describe, attempt=attempt, retries=retries,
                         backoff_s=round(wait, 3), error=repr(e)[:200])
            if wait > 0:
                sleep(wait)
