"""Fault injection: the controlled way to break things.

PyTorch counterpart of ``pylops_mpi_tpu/resilience/faults.py:55-266``.
Every recovery path of the resilience tier is only as real as the fault
that exercises it:

- **In-loop NaN** (:func:`arm` with kind ``"nan"``): a guarded loop
  multiplies one operator apply by ``where(iiter == k, NaN, 1)``, a
  device op on the loop's device iteration counter, so the NaN lands at
  iteration ``k`` with no host synchronisation and a captured CUDA
  graph replays it. The sites are the JAX package's: CG's first apply,
  classic CGLS's end-of-body ``Op c``, both outputs of
  ``normal_matvec`` under ``normal=True``, the pipelined engines' apply
  and the sparse solvers' ``Op x``.
- **In-loop stall** (kind ``"stall"``): the step scalar is zeroed from
  iteration ``k`` on; the recurrence freezes short of convergence,
  which the stagnation detector must catch.
- **Plan-cache corruption** (:func:`corrupt_plan_cache`): a truncated,
  garbled or wrong-schema tuning cache, which ``tuning/cache`` must
  treat as a logged miss.
- **Flaky callables** (:func:`flaky`): raise for the first N calls, the
  probe of :mod:`.retry`.
- **A worker killed mid-move** (:func:`maybe_kill_reshard`,
  :func:`maybe_kill_spill`): the resharding executor calls the first
  before every plan step and the spill executor both before every
  staged chunk; with ``PYLOPS_MPI_TPU_TORCH_FAULT_KILL_RESHARD=N`` (or
  ``..._FAULT_KILL_SPILL=N``) the process SIGKILLs itself at the Nth
  step, with no tidy-up, which the in-place recovery must survive by
  falling back to the checkpoint relaunch.

A fault is armed per process and, by default, once: the first guarded
solve consumes it (:func:`consume`), so a restart after the injected
breakdown runs clean. The fault spec joins the key of a captured loop
(:func:`fault_signature`), so a poisoned graph is never replayed for a
clean solve. Unguarded loops never inject.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

__all__ = ["arm", "disarm", "armed", "consume", "fault_signature",
           "fault_sites", "inject_nan", "inject_stall", "host_stall",
           "corrupt_plan_cache", "flaky", "maybe_kill_reshard",
           "reset_reshard_steps", "reshard_steps", "maybe_kill_spill",
           "reset_spill_steps", "spill_steps"]

_LOCK = threading.Lock()
_ARMED: Optional[Dict] = None
_KINDS = ("nan", "stall")

KILL_RESHARD_ENV = "PYLOPS_MPI_TPU_TORCH_FAULT_KILL_RESHARD"
KILL_SPILL_ENV = "PYLOPS_MPI_TPU_TORCH_FAULT_KILL_SPILL"
_STEPS = {"reshard": 0, "spill": 0}


def reset_reshard_steps() -> None:
    with _LOCK:
        _STEPS["reshard"] = 0


def reshard_steps() -> int:
    """Reshard plan steps run in this process since the last reset."""
    with _LOCK:
        return _STEPS["reshard"]


def reset_spill_steps() -> None:
    with _LOCK:
        _STEPS["spill"] = 0


def spill_steps() -> int:
    """Host-staged chunks run in this process since the last reset."""
    with _LOCK:
        return _STEPS["spill"]


def _step_and_maybe_kill(kind: str, env: str) -> None:
    with _LOCK:
        _STEPS[kind] += 1
        count = _STEPS[kind]
    import os
    raw = os.environ.get(env, "").strip()
    if raw and count >= int(raw):
        import signal
        os.kill(os.getpid(), signal.SIGKILL)


def maybe_kill_reshard() -> None:
    """Count one reshard step; SIGKILL this process at the step
    ``PYLOPS_MPI_TPU_TORCH_FAULT_KILL_RESHARD`` names (1-based). A
    SIGKILL, not an exception: the fault is a dead worker, and nothing
    (atexit, ``finally``, a checkpoint flush) may tidy up."""
    _step_and_maybe_kill("reshard", KILL_RESHARD_ENV)


def maybe_kill_spill() -> None:
    """Count one host-staged chunk; SIGKILL this process at the chunk
    ``PYLOPS_MPI_TPU_TORCH_FAULT_KILL_SPILL`` names (1-based)."""
    _step_and_maybe_kill("spill", KILL_SPILL_ENV)


def arm(kind: str, iteration: int, once: bool = True) -> None:
    """Arm an in-loop fault at ``iteration`` (0-based): ``"nan"``
    poisons that iteration's operator apply, ``"stall"`` zeroes the
    step from it on. ``once`` disarms it at the next guarded solve."""
    if kind not in _KINDS:
        raise ValueError(f"unknown fault kind {kind!r}; "
                         f"expected one of {_KINDS}")
    if iteration < 0:
        raise ValueError(f"iteration must be >= 0, got {iteration}")
    global _ARMED
    with _LOCK:
        _ARMED = {"kind": kind, "iteration": int(iteration),
                  "once": bool(once)}


def disarm() -> None:
    global _ARMED
    with _LOCK:
        _ARMED = None


def armed() -> Optional[Dict]:
    """The armed fault spec (a copy), or ``None``."""
    with _LOCK:
        return dict(_ARMED) if _ARMED else None


def consume() -> Optional[Dict]:
    """Read the armed spec and disarm a one-shot fault: a guarded solve
    calls this once, before its loop is built."""
    global _ARMED
    with _LOCK:
        spec = dict(_ARMED) if _ARMED else None
        if spec and spec.get("once"):
            _ARMED = None
    return spec


def fault_signature(spec: Optional[Dict] = None):
    """The hashable fault state a captured loop's key holds."""
    if spec is None:
        spec = armed()
    if not spec:
        return ("faults", None)
    return ("faults", spec["kind"], spec["iteration"])


def fault_sites(spec: Optional[Dict]):
    """``(nan_at, stall_at)``: the iteration of each kind of injection
    a guarded loop makes, ``None`` for none."""
    if not spec:
        return None, None
    if spec.get("kind") == "nan":
        return spec["iteration"], None
    if spec.get("kind") == "stall":
        return None, spec["iteration"]
    return None, None


def _poison(t, iiter, at: int):
    import torch
    sdt = t.dtype.to_real() if t.dtype.is_complex else t.dtype
    nan = torch.full((), float("nan"), dtype=sdt, device=t.device)
    return t * torch.where(iiter == at, nan, torch.ones_like(nan))


def inject_nan(v, iiter, at: int):
    """``v * where(iiter == at, NaN, 1)`` over a tensor or a (stacked)
    distributed vector; the factor is real, so a complex vector keeps
    its dtype."""
    from ..distributedarray import DistributedArray
    from ..stacked import StackedDistributedArray
    if isinstance(v, StackedDistributedArray):
        return StackedDistributedArray([inject_nan(d, iiter, at)
                                        for d in v.distarrays])
    if isinstance(v, DistributedArray):
        return DistributedArray._wrap(_poison(v.array, iiter, at), v)
    return _poison(v, iiter, at)


def inject_stall(a, iiter, at: int):
    """The step scalar ``a``, zero from iteration ``at`` on."""
    import torch
    return torch.where(iiter >= at, torch.zeros_like(a), a)


def host_stall(seconds: float) -> None:
    """Block this process for ``seconds`` (a straggling rank)."""
    import time
    time.sleep(max(0.0, float(seconds)))


def corrupt_plan_cache(path: str, mode: str = "truncate") -> None:
    """Damage a tuning-cache file as a killed writer or a bad disk
    would: ``truncate`` cuts it mid-object, ``garbage`` replaces it with
    bytes that are not JSON, ``schema`` writes a wrong schema version."""
    import json
    import os
    if mode == "truncate":
        with open(path, "r+") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.truncate(max(1, size // 2))
    elif mode == "garbage":
        with open(path, "w") as f:
            f.write("\x00\xff not json at all {{{")
    elif mode == "schema":
        with open(path, "w") as f:
            json.dump({"schema": -1, "plans": {}}, f)
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")


def flaky(fn: Callable, failures: int,
          exc: Callable[[], BaseException] = None) -> Callable:
    """``fn`` wrapped to raise ``exc()`` (default ``TimeoutError``) for
    its first ``failures`` calls; ``.calls`` counts the calls."""
    if exc is None:
        exc = lambda: TimeoutError("injected timeout")  # noqa: E731
    state = {"calls": 0}

    def wrapper(*args, **kwargs):
        state["calls"] += 1
        wrapper.calls = state["calls"]
        if state["calls"] <= failures:
            raise exc()
        return fn(*args, **kwargs)

    wrapper.calls = 0
    return wrapper
