"""Stage budgets, the deadline-aware stage runner and profiler capture.

PyTorch counterpart of ``pylops_mpi_tpu/diagnostics/profiler.py:60-293``:

1. :data:`STAGE_BUDGETS` and :func:`stage_budget`, the one table of
   per-stage wall budgets in seconds (a ``tpu`` column, the live budget,
   and a ``rehearse`` column, the rehearsal budget), kept as the JAX
   package has it so both packages resolve every stage alike. The
   environment overrides keep the JAX package's names
   (``PROBE_<STAGE>_TIMEOUT``, ``BENCH_SELFCHECK_TIMEOUT``,
   ``BENCH_COMPONENT_TIMEOUT``): they carry no package prefix. The
   serving dispatcher runs every packed batch under ``serve_batch``.
2. :class:`DeadlineRunner`, which caps each stage at ``min(budget,
   window left)``, skips a stage the window can no longer fit, records
   every outcome and never lets a stage's exception escape (the
   dispatcher turns a failed record into failed tickets).
3. :func:`profile_capture`, a ``torch.profiler`` capture of a region
   written as a Chrome trace into the ``logdir`` its caller names; it
   holds the program's spans (:mod:`.trace`) as ``record_function``
   ranges. The JAX package's ``PYLOPS_MPI_TPU_PROFILE_DIR`` arms the
   regions its solvers open; the port's solvers open none, so it has no
   such knob.

The module imports only the standard library at load.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, List, Optional

__all__ = ["STAGE_BUDGETS", "stage_budget", "DeadlineRunner",
           "StageRecord", "profile_capture", "dump_report"]


# Per-stage wall budgets in seconds: "tpu" is the live budget, "rehearse"
# the rehearsal one (the JAX package's table, key for key).
STAGE_BUDGETS: Dict[str, Dict[str, Optional[int]]] = {
    "selfcheck":      {"tpu": 900,  "rehearse": 600},
    "tune":           {"tpu": 600,  "rehearse": 240},
    "flagship_small": {"tpu": 900,  "rehearse": 600},
    "fft_planar":     {"tpu": 700,  "rehearse": 600},
    "flagship_full":  {"tpu": 3000, "rehearse": 2400},
    "flagship_mid":   {"tpu": 1200, "rehearse": 1200},
    "overlap":        {"tpu": 600,  "rehearse": 600},
    "hier":           {"tpu": 300,  "rehearse": 300},
    "bisect":         {"tpu": 1200, "rehearse": 900},
    "breakdown":      {"tpu": 900,  "rehearse": 700},
    "diag":           {"tpu": 900,  "rehearse": 700},
    "bench_selfcheck": {"tpu": 600, "rehearse": 600},
    "component":       {"tpu": 150, "rehearse": 150},
    "multihost_init":  {"tpu": 300, "rehearse": 120},
    "checkpoint_io":   {"tpu": 600, "rehearse": 300},
    "multihost_chaos": {"tpu": 900, "rehearse": 600},
    # the serving dispatcher's budget for one packed batch, and the
    # serve-forever smoke's
    "serve_batch":     {"tpu": 120, "rehearse": 60},
    "serve_smoke":     {"tpu": 900, "rehearse": 600},
}

_ENV_NAMES = {
    "bench_selfcheck": "BENCH_SELFCHECK_TIMEOUT",
    "component": "BENCH_COMPONENT_TIMEOUT",
}


def _env_name(stage: str) -> str:
    if stage in _ENV_NAMES:
        return _ENV_NAMES[stage]
    return "PROBE_" + stage.replace("flagship_", "").upper() + "_TIMEOUT"


def stage_budget(stage: str, rehearse: bool = False,
                 env: Optional[Dict] = None) -> int:
    """Wall budget of ``stage`` in seconds: its environment override when
    set and an integer, else the table's column. An unknown stage
    raises."""
    if stage not in STAGE_BUDGETS:
        raise KeyError(f"unknown harvest stage {stage!r}; known: "
                       f"{sorted(STAGE_BUDGETS)}")
    env = os.environ if env is None else env
    raw = env.get(_env_name(stage))
    if raw is not None:
        try:
            return int(raw)
        except ValueError:
            pass  # a malformed override takes the table's value
    return STAGE_BUDGETS[stage]["rehearse" if rehearse else "tpu"]


class StageRecord(dict):
    """One stage's outcome, a plain dict: ``stage``, ``budget_s``,
    ``effective_timeout_s``, ``seconds``, ``ok``, ``skipped``,
    ``banked_partial``, ``hit_budget``, ``error``; :attr:`result` is
    what the stage returned."""

    @property
    def result(self):
        return self.get("result")


class DeadlineRunner:
    """Run stages against a window that ends at ``deadline_ts`` (wall
    clock; ``None`` for no end).

    ``fn`` given to :meth:`run` receives the effective timeout in
    seconds and returns ``(result, err)``. A stage is skipped when less
    than ``min(budget, min_stage_s)`` seconds are left; an exception
    from ``fn`` becomes the record's ``error``. Every record is kept in
    :attr:`records` and sent to ``log`` and, as an event, to the trace.
    """

    def __init__(self, deadline_ts: Optional[float] = None,
                 min_stage_s: int = 30,
                 log: Optional[Callable[[Dict], None]] = None):
        self.deadline_ts = deadline_ts
        self.min_stage_s = int(min_stage_s)
        self._log = log
        self.records: List[StageRecord] = []

    def remaining(self) -> Optional[float]:
        """Seconds left in the window (``None`` without a deadline)."""
        if self.deadline_ts is None:
            return None
        return self.deadline_ts - time.time()

    def _emit(self, rec: StageRecord) -> None:
        self.records.append(rec)
        payload = {k: v for k, v in rec.items() if k != "result"}
        if self._log is not None:
            try:
                self._log(dict(payload))
            except Exception:
                pass
        from . import trace
        trace.event(f"harvest.{rec['stage']}", cat="harvest", **payload)

    def run(self, stage: str, fn: Callable, budget_s: int) -> StageRecord:
        rem = self.remaining()
        if rem is not None and rem < min(budget_s, self.min_stage_s):
            rec = StageRecord(stage=stage, budget_s=budget_s,
                              skipped=True, ok=False,
                              reason="window exhausted "
                                     f"({rem:.0f}s remaining)",
                              result=None)
            self._emit(rec)
            return rec
        eff = int(budget_s) if rem is None \
            else max(1, min(int(budget_s), int(rem)))
        t0 = time.time()
        try:
            result, err = fn(eff)
        except Exception as e:  # a stage that raises fails its record
            result, err = None, f"stage raised: {e!r}"
        seconds = round(time.time() - t0, 1)
        banked_partial = bool(
            isinstance(result, dict)
            and (result.get("salvaged_after_timeout")
                 or result.get("partial")))
        rec = StageRecord(
            stage=stage, budget_s=int(budget_s),
            effective_timeout_s=eff, seconds=seconds,
            ok=result is not None and not err,
            skipped=False,
            hit_budget=seconds >= eff - 1,
            banked_partial=banked_partial,
            result=result)
        if err:
            rec["error"] = str(err)[:300]
        self._emit(rec)
        return rec

    def report(self) -> Dict:
        """The records without their results, the skipped stages, the
        partial results and the seconds left."""
        return {
            "stages": [{k: v for k, v in r.items() if k != "result"}
                       for r in self.records],
            "skipped": [r["stage"] for r in self.records
                        if r.get("skipped")],
            "banked_partials": [r["stage"] for r in self.records
                                if r.get("banked_partial")],
            "remaining_s": (None if self.deadline_ts is None
                            else round(self.remaining(), 1)),
        }


def dump_report(runner: DeadlineRunner, path: str) -> None:
    """Write :meth:`DeadlineRunner.report` to ``path`` as JSON."""
    with open(path, "w") as f:
        json.dump(runner.report(), f, indent=1)


class _NoopCapture:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _Capture:
    """A ``torch.profiler`` capture of the host and, where CUDA is
    available, the device, with the region labelled ``name``, exported
    as ``<path>/trace.json`` (Chrome trace). A profiler that cannot
    start leaves the region unprofiled."""

    def __init__(self, name: str, path: str):
        self.name = name
        self.path = path
        self._prof = None
        self._label = None

    def __enter__(self):
        try:
            import torch
            from torch.profiler import (ProfilerActivity, profile,
                                        record_function)
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            os.makedirs(self.path, exist_ok=True)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
            self._label = record_function(self.name)
            self._label.__enter__()
        except Exception:
            self._prof = None
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            try:
                if self._label is not None:
                    self._label.__exit__(None, None, None)
                self._prof.__exit__(None, None, None)
                self._prof.export_chrome_trace(
                    os.path.join(self.path, "trace.json"))
            except Exception:
                pass
        return False


def profile_capture(name: str, logdir: Optional[str] = None):
    """Context manager capturing a ``torch.profiler`` trace of the region
    ``name`` into ``logdir/trace.json``; a no-op when ``logdir`` is
    ``None``."""
    if not logdir:
        return _NoopCapture()
    return _Capture(name, logdir)
