"""Measured plan search: cost-model seeded, budget bounded.

PyTorch counterpart of ``pylops_mpi_tpu/tuning/search.py``: rank the
declared candidates with the seed (:func:`~.space.rank`), then time the
default and the top-k with :func:`~..utils.benchmark.time_callable`
(each timed call ends in a device sync) inside a
:class:`~..diagnostics.profiler.DeadlineRunner` window
(``STAGE_BUDGETS["tune"]``). Every candidate records one
``tuning.trial`` trace event: a replayed plan shows none.

Order must not decide a race. Every candidate is warmed first (the
call that builds a kernel or captures a graph, and the card's clocks
coming up), then timed in :data:`ROUNDS` rounds whose order alternates
(the default first, then last); a candidate's ``best_s`` is its best
over the rounds. Selection keeps the default unless the best candidate
beats it by ``PYLOPS_MPI_TPU_TORCH_TUNE_MARGIN`` (default 2%): host
noise must not move a plan.

A trial that raises (a kernel that does not build or launch) makes the
search raise :class:`TrialError` after its ``tuning.trial`` event: no
plan is picked from the candidates that did run, so no plan can bank
the plain path in place of a broken kernel. Only a trial skipped for
the budget leaves the others to decide.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..diagnostics import trace as _trace
from ..diagnostics.profiler import DeadlineRunner, stage_budget
from . import space as _space

__all__ = ["measure_candidates", "tune_budget_s", "tune_topk",
           "tune_margin", "TrialError", "ROUNDS"]

# timed rounds after the warm-up pass, in alternating order
ROUNDS = 2


class TrialError(RuntimeError):
    """A candidate failed to build or run during a measured search."""


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ[name])
    except (KeyError, ValueError):
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ[name])
    except (KeyError, ValueError):
        return default


def tune_budget_s(platform: Optional[str] = None) -> int:
    """Wall budget for one search, seconds:
    ``PYLOPS_MPI_TPU_TORCH_TUNE_BUDGET`` when set, else
    ``STAGE_BUDGETS["tune"]`` (the live column on the card, the
    rehearsal column on the CPU)."""
    b = _env_int("PYLOPS_MPI_TPU_TORCH_TUNE_BUDGET", 0)
    if b > 0:
        return b
    return stage_budget("tune", rehearse=(platform != "cuda"))


def tune_topk() -> int:
    """How many seed-ranked candidates get timed (default 4; the
    default configuration is always included regardless)."""
    return max(1, _env_int("PYLOPS_MPI_TPU_TORCH_TUNE_TOPK", 4))


def tune_margin() -> float:
    """Fractional win required to move off the default (default 2%)."""
    return max(0.0, _env_float("PYLOPS_MPI_TPU_TORCH_TUNE_MARGIN", 0.02))


def _trial_list(space: _space.TuningSpace, ctx: Dict) -> List[Dict]:
    """Measurement set: the default configuration first (the race
    baseline that must always be in the set), then the seed ranking,
    deduplicated, capped at top-k."""
    ranked = _space.rank(space, ctx)
    dflt = _space.default_params(space, ctx)
    ordered = [dflt] + [p for p in ranked if p != dflt]
    return ordered[:max(2, tune_topk())] if len(ordered) > 1 else ordered


def measure_candidates(space: _space.TuningSpace, ctx: Dict,
                       factory: Callable[[Dict], Callable],
                       budget_s: Optional[int] = None,
                       repeats: int = 3,
                       runner: Optional[DeadlineRunner] = None) \
        -> Tuple[Optional[Dict], List[Dict]]:
    """Time the top candidates and pick the winner.

    ``factory(params)`` builds one candidate configuration (an
    operator constructed with explicit kwargs, which never re-enter the
    tuner) and returns a zero-argument apply that returns its output. A
    candidate's operator lives only for one stage: it is built anew for
    the warm-up and for each timed round
    (``utils/benchmark.time_callable``, ``repeats`` timed calls after
    one untimed), so two candidates never hold device memory at once.
    Stages run through a :class:`DeadlineRunner` (budget from
    :func:`tune_budget_s` unless given): once the budget is exhausted
    the remaining stages are SKIPPED (recorded), and whatever was
    measured decides.

    Returns ``(winner_params, trials)``; ``winner_params`` is ``None``
    when nothing could be measured (caller falls back to the seed).
    The default configuration wins ties and near-ties
    (:func:`tune_margin`). Raises :class:`TrialError` when a stage
    raised (module docstring).
    """
    from ..utils.benchmark import time_callable
    cands = _trial_list(space, ctx)
    dflt = _space.default_params(space, ctx)
    if budget_s is None:
        budget_s = tune_budget_s(ctx.get("platform"))
    if runner is None:
        runner = DeadlineRunner(deadline_ts=time.time() + budget_s,
                                min_stage_s=1)

    def stage(name, params, repeats_):
        def _one(eff_timeout):
            apply_fn = factory(params)
            stats = time_callable(apply_fn, repeats=repeats_, warmup=1)
            del apply_fn  # the candidate's operator goes before the next
            return stats, None
        return runner.run(f"tune.{space.op}.{name}", _one, budget_s)

    warm = [stage(f"{i}.warm", p, 1) for i, p in enumerate(cands)]
    failed = {i: rec for i, rec in enumerate(warm)
              if not rec.get("ok") and not rec.get("skipped")}
    live = [i for i, rec in enumerate(warm) if rec.get("ok")]
    timed: Dict[int, List] = {i: [] for i in live}
    seconds = {i: rec.get("seconds") or 0.0 for i, rec in enumerate(warm)}
    for r in range(ROUNDS if not failed else 0):
        for i in (live if r % 2 == 0 else live[::-1]):
            rec = stage(f"{i}.r{r}", cands[i], repeats)
            seconds[i] += rec.get("seconds") or 0.0
            if rec.get("ok"):
                timed[i].append(rec.result)
            elif not rec.get("skipped"):
                failed[i] = rec
                break
        if failed:
            break

    trials: List[Dict] = []
    measured: List[Tuple[float, Dict]] = []
    for i, params in enumerate(cands):
        runs = timed.get(i) or []
        ok = bool(runs) and i not in failed
        trial = {"op": space.op, "params": params,
                 "skipped": i not in failed and not runs, "ok": ok,
                 "seconds": round(seconds[i], 1)}
        if i in failed:
            trial["error"] = failed[i].get("error")
        if ok:
            times = [t for st in runs for t in st["times_s"]]
            trial["best_s"] = min(st["best_s"] for st in runs)
            trial["mean_s"] = sum(times) / len(times)
            # the warm-up's first call: a kernel build or a graph capture
            trial["compile_s"] = warm[i].result.get("compile_s")
            trial["rounds"] = len(runs)
            measured.append((float(trial["best_s"]), params))
        trials.append(trial)
        # the replay-proof event: a warm cache produces ZERO of these
        _trace.event("tuning.trial", cat="tuning", op=space.op,
                     params=params, skipped=trial["skipped"],
                     ok=trial["ok"], best_s=trial.get("best_s"),
                     compile_s=trial.get("compile_s"),
                     error=trial.get("error"))
    if failed:
        i = min(failed)
        raise TrialError(f"tuning {space.op}: candidate {cands[i]} "
                         f"failed: {failed[i].get('error')}")
    if not measured:
        return None, trials
    best_t, best_p = min(measured, key=lambda t: t[0])
    t_default = next((t for t, p in measured if p == dflt), None)
    if (best_p != dflt and t_default is not None
            and best_t > t_default * (1.0 - tune_margin())):
        # within noise of the default: keep the default (hysteresis)
        best_t, best_p = t_default, dflt
    _trace.event("tuning.winner", cat="tuning", op=space.op,
                 params=best_p, best_s=best_t,
                 default_s=t_default,
                 n_measured=len(measured))
    return dict(best_p), trials
