"""The program's own spans in a device trace: for each ``record_function``
range the program opens (every ``user_annotation`` range not named
``portbench.*``), its calls, the device time launched inside it, the part
launched where it was the innermost of them, and the idle gaps that began
while it was the innermost on the solves' thread.

The window (:mod:`.runner`) reads its trace into :func:`.trace.summarize`
and lets the profiler go before any metric is read, so the readers of
program spans take a trace of their own: once a traced run has its result,
:func:`summary` builds the cell's problem again from the run's seed, warms
it up and traces ``trace_iters`` iterations of the same solves as the
window does. Where the program opens no range under the profiler (a
program without spans), it traces nothing and reads nothing.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import tempfile
from bisect import bisect_right
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from portbench.harness import bounds
from portbench.harness import trace as tr

# the readers of one run share its trace of the program's spans
_SUMMARIES: Dict[int, dict] = {}


def modelling_apply(npoints: int, itemsize: int = 4) -> bounds.Bound:
    """One forward (or adjoint) apply of the post-stack modelling
    operator ``0.5·W·D`` on ``npoints`` samples: the model read once and
    the data written once, or the reverse."""
    return bounds.Bound(float(2 * npoints * itemsize))


def gradient_apply(npoints: int, itemsize: int = 4) -> bounds.Bound:
    """One forward (or adjoint) apply of a two-dimensional gradient on
    ``npoints`` samples: the model read once and its two components
    written once, or the reverse."""
    return bounds.Bound(float(3 * npoints * itemsize))


def _stacks(spans: List[Tuple[float, float, str]]):
    """The program spans open at each moment on one thread: sorted start
    times and, from each on, the names open (outermost first). A span
    that outlasts its parent in the trace's rounding is cut to it."""
    times: List[float] = []
    stacks: List[Tuple[str, ...]] = []
    open_: List[Tuple[float, str]] = []

    def close(until: float) -> None:
        while open_ and open_[-1][0] <= until:
            end = open_.pop()[0]
            times.append(end)
            stacks.append(tuple(n for _, n in open_))
    for a, b, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        close(a)
        if open_:
            b = min(b, open_[-1][0])
        open_.append((b, name))
        times.append(a)
        stacks.append(tuple(n for _, n in open_))
    close(float("inf"))
    return times, stacks


def _open_at(index, tid, t: float) -> Tuple[str, ...]:
    times, stacks = index.get(tid, ((), ()))
    i = bisect_right(times, t) - 1
    return stacks[i] if i >= 0 else ()


def program_spans(events: List[dict]) -> dict:
    """From Chrome-trace ``events`` (times in seconds): ``span_s`` and
    ``busy_s`` of the solves' span, as :func:`.trace.summarize` gives
    them, and ``spans``: for each program span that starts in the solves'
    span, ``calls``, ``device_s`` (device operations launched inside it),
    ``self_device_s`` (those launched where it was the innermost program
    span) and ``idle_s`` (each idle gap whole, under the innermost program
    span open on the solves' thread when the gap began: the host was there
    when the device ran dry). Empty where no solve range was traced."""
    launch_at: Dict[int, Tuple[float, object]] = {}
    device, solves, program = [], [], []
    solve_tid = None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, ts = e.get("cat", ""), float(e.get("ts", 0.0)) * 1e-6
        end = ts + float(e.get("dur", 0.0)) * 1e-6
        name = e.get("name", "")
        corr = (e.get("args") or {}).get("correlation")
        if cat in tr.DEVICE_CATS:
            device.append((ts, end, corr))
        elif cat in ("cuda_runtime", "cuda_driver") and corr is not None:
            launch_at[corr] = (ts, e.get("tid"))
        elif cat == "user_annotation" and name == tr.SOLVE_RANGE:
            solves.append((ts, end))
            if solve_tid is None:
                solve_tid = e.get("tid")
        elif cat == "user_annotation" and \
                not name.startswith(tr.RANGE_PREFIX):
            program.append((ts, end, name, e.get("tid")))
    if not solves:
        return {}
    lo, hi = min(a for a, _ in solves), max(b for _, b in solves)
    busy = tr._merge(tr._clip([(a, b) for a, b, _ in device if lo <= a < hi],
                              lo, hi))
    gaps = []
    prev = lo
    for a, b in busy + [(hi, hi)]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    by_tid: Dict[object, list] = defaultdict(list)
    out: Dict[str, dict] = {}
    for a, b, name, tid in program:
        if lo <= a <= hi:
            by_tid[tid].append((a, b, name))
            st = out.setdefault(name, {"calls": 0, "device_s": 0.0,
                                       "self_device_s": 0.0, "idle_s": 0.0})
            st["calls"] += 1
    index = {tid: _stacks(spans) for tid, spans in by_tid.items()}
    for a, b, corr in device:
        at = launch_at.get(corr)
        if at is None:
            continue
        stack = _open_at(index, at[1], at[0])
        if not stack:
            continue
        for name in set(stack):
            out[name]["device_s"] += b - a
        out[stack[-1]]["self_device_s"] += b - a
    for a, b in gaps:
        stack = _open_at(index, solve_tid, a)
        if stack:
            out[stack[-1]]["idle_s"] += b - a
    return {"span_s": hi - lo, "busy_s": sum(b - a for a, b in busy),
            "spans": out}


def opens_ranges(torch) -> bool:
    """Whether the program's spans enter the profiler's trace."""
    from torch.profiler import ProfilerActivity, profile
    from pylops_mpi_tpu_torch.diagnostics import trace as ptrace
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with ptrace.span("portbench_probe"):
            pass
    return any(e.name == "portbench_probe" for e in prof.events())


def trace_solves(cell, seed: int, device, torch, pmtt) -> dict:
    """:func:`program_spans` of the cell's solves, with their
    ``traced_iters``: the problem built from ``seed``, one warm-up solve,
    then the window's traced solves (its ``trace_after`` and
    ``trace_iters``) with no measured time."""
    from portbench.harness import runner, spec
    problem = spec.problem_module(cell.config).build(
        cell.config, cell.traffic, seed, device, pmtt)
    kw = dict(niter=int(cell.traffic["niter"]), damp=problem.damp, tol=0.0)
    if cell.traffic["normal"]:
        kw["normal"] = True
    pmtt.cgls(problem.op, problem.rhs[0], **kw)
    runner._sync(device, torch)
    win = runner.window(device, torch, pmtt, problem, cell.traffic, seed,
                        0.0, True)
    prof, iters = win.pop("prof"), win["traced_iters"]
    path = Path(tempfile.gettempdir()) / "portbench" / "program_spans.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    try:
        prof.export_chrome_trace(str(path))
        del prof, win, problem
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        if path.exists():
            os.remove(path)
    found = program_spans(events)
    if found:
        found["traced_iters"] = iters
    return found


def _seed() -> int:
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--seed", type=int, default=0)
    return p.parse_known_args(sys.argv[1:])[0].seed


def summary(ctx) -> Optional[dict]:
    """The run's :func:`program_spans`, traced once a run (see the module's
    docstring); ``None`` where the run traced nothing, the program opens no
    range or the trace holds no device work (a run without a card)."""
    if not ctx.trace:
        return None
    key = id(ctx.record)
    if key not in _SUMMARIES:
        import torch
        import pylops_mpi_tpu_torch as pmtt
        found: dict = {}
        if opens_ranges(torch):
            cuda = ctx.trace["busy_s"] > 0.0 and torch.cuda.is_available()
            device = (torch.device("cuda", torch.cuda.current_device())
                      if cuda else torch.device("cpu"))
            found = trace_solves(ctx.cell, _seed(), device, torch, pmtt)
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
        _SUMMARIES[key] = found
    found = _SUMMARIES[key]
    if not found or found["busy_s"] <= 0.0:
        return None
    return found


def span(ctx, *names: str) -> Optional[dict]:
    """The program's spans ``names`` summed: ``calls``, ``device_s``,
    ``self_device_s`` and ``idle_s``; ``None`` where none was traced."""
    s = summary(ctx)
    if not s:
        return None
    found = [s["spans"][n] for n in names if n in s["spans"]]
    if not found or not sum(st["calls"] for st in found):
        return None
    return {k: sum(st[k] for st in found) for k in found[0]}


def roofline_pct(ctx, names, bound: bounds.Bound) -> Optional[float]:
    """The bound time of every call of the program spans ``names`` over the
    device time launched inside them, in %; ``None`` where they ran no
    device work."""
    st = span(ctx, *names)
    if not st or st["device_s"] <= 0.0:
        return None
    return 100.0 * st["calls"] * bound.seconds() / st["device_s"]
