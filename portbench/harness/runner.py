"""One run of one cell on one card: set-up, the measured window, the traced
solves, the check against the plain reference, and the result line."""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import random
import sys
import tempfile
import time
from pathlib import Path
from typing import List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "pylops_mpi_tpu")


def process_age_s() -> float:
    """Seconds since this process started (``/proc``, 10 ms ticks)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one the benchmark may not
    load, compared whole."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # for the tests on a machine without a card: run on the CPU with the
    # configuration's and traffic's sizes overridden
    p.add_argument("--test-cpu", default=None, help=argparse.SUPPRESS)
    # calibration of the limits: these seeds (comma-separated) one after
    # another in one process, each with a short window and its control
    p.add_argument("--calibrate", default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def _sync(device, torch) -> None:
    """Wait for the device's work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _install_ranges(problem, torch) -> None:
    """Open each of the problem's ``record_function`` ranges around its
    method (traced runs only)."""
    from torch.profiler import record_function
    for rg in problem.ranges:
        orig = getattr(rg.owner, rg.method)

        def wrapped(*a, _orig=orig, _name=rg.name, **k):
            with record_function(_name):
                return _orig(*a, **k)
        setattr(rg.owner, rg.method, wrapped)


def window(device, torch, pmtt, problem, traffic: dict, seed: int,
           seconds: float, trace: bool) -> dict:
    """The measured window: solves back to back from ``x0 = 0`` with
    ``tol = 0``, each timed from its call until its ``x`` is on the device,
    until ``seconds`` have passed (the solve under way then completes and
    counts). With ``trace``, the solves from ``trace_after`` on are
    profiled until they cover ``trace_iters`` iterations. Keeps a seeded
    sample of the answers (reservoir of ``check_max``)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    niter = int(traffic["niter"])
    kwargs = dict(niter=niter, damp=problem.damp, tol=0.0)
    if traffic["normal"]:
        kwargs["normal"] = True
    rng = random.Random(seed)
    n_rhs = len(problem.rhs)
    order: List[int] = []
    keep_max = int(traffic["check_max"])
    kept: List[tuple] = []
    times: List[float] = []
    iters: List[int] = []
    prof = None
    traced_iters = 0
    trace_first = int(traffic["trace_after"])
    trace_done = not trace
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if device.type == "cuda" else [])
    if trace:
        _install_ranges(problem, torch)
    stop = False
    i = 0
    t_start = time.perf_counter()
    while not (stop and trace_done):
        if not order:
            order = rng.sample(range(n_rhs), n_rhs)
        j = order.pop()
        profiling = trace and not trace_done and i >= trace_first
        if trace and prof is None and i >= trace_first - 1:
            # the profiler starts a solve early, so that its start delays
            # no profiled solve
            prof = profile(activities=acts)
            prof.__enter__()
            _sync(device, torch)
        t0 = time.perf_counter()
        with (record_function("portbench.solve") if profiling
              else contextlib.nullcontext()):
            x, _, iiter, _, _, cost = pmtt.cgls(problem.op, problem.rhs[j],
                                                **kwargs)
            stop = time.perf_counter() - t_start >= seconds
            _sync(device, torch)
        t1 = time.perf_counter()
        times.append(t1 - t0)
        iters.append(int(iiter))
        if profiling:
            traced_iters += int(iiter)
            if traced_iters >= int(traffic["trace_iters"]):
                prof.__exit__(None, None, None)
                trace_done = True
        # reservoir sample of the answers
        if len(kept) < keep_max:
            kept.append((i, j, x, cost))
        else:
            k = rng.randrange(i + 1)
            if k < keep_max:
                kept[k] = (i, j, x, cost)
        i += 1
    t_end = time.perf_counter()
    return dict(t_start=t_start, t_end=t_end, times=times, iters=iters,
                kept=kept, prof=prof, traced_iters=traced_iters)


def _trace_summary(prof) -> Optional[dict]:
    from portbench.harness import trace as tr
    if prof is None:
        return None
    path = Path(tempfile.gettempdir()) / "portbench" / "trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    return tr.read_chrome_trace(str(path))


def measure(device, cell, seed: int, seconds: float, trace: bool, torch,
            pmtt) -> dict:
    """Set-up, warm-up and the window; the run's record."""
    from portbench.harness import faults, spec
    from pylops_mpi_tpu_torch.aot import store as aot_store
    from pylops_mpi_tpu_torch.solvers import ca
    from pylops_mpi_tpu_torch.utils import deps
    mod = spec.problem_module(cell.config)
    problem = mod.build(cell.config, cell.traffic, seed, device, pmtt)
    fault = faults.armed()
    if fault:
        faults.plant(fault, pmtt, problem)
    resolved = dict(problem.resolved, ca=ca.resolve_mode(problem.op, "cgls"),
                    overlap=deps.overlap_mode(),
                    overlap_on=deps.overlap_enabled(device=device),
                    aot=aot_store.aot_mode())
    # warm-up: one whole solve of the window's shapes
    kw = dict(niter=int(cell.traffic["niter"]), damp=problem.damp, tol=0.0)
    if cell.traffic["normal"]:
        kw["normal"] = True
    pmtt.cgls(problem.op, problem.rhs[0], **kw)
    _sync(device, torch)
    gc.collect()
    setup_s = process_age_s()
    win = window(device, torch, pmtt, problem, cell.traffic, seed, seconds,
                 trace)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    summary = _trace_summary(win.pop("prof"))
    kept = win.pop("kept")
    record = dict(
        win, setup_s=setup_s, resolved=resolved, peak=peak, trace=summary,
        bounds={rg.name: rg.bound.seconds() for rg in problem.ranges},
        kept_ids=[(k[0], k[1]) for k in kept],
        kept_costs=[k[3].double().cpu() for k in kept],
        kept_rows=torch.stack([problem.model_rows(k[2]) for k in kept])
        .float().cpu() if kept else None,
        data_rows=problem.data_rows.float().cpu())
    del problem, kept, win
    return record


def judge(cell, seed: int, record: dict, device, precision: str = "f64",
          control: bool = False) -> dict:
    """The checks of a run against the plain reference: each number
    compared and its limit. With ``control``, the reference's own answer at
    the control's precision (``tf32``) stands in the program's place."""
    import torch
    from portbench.harness import compare, spec
    ref = spec.reference_module(cell.config)
    Y = record["data_rows"]
    niter = int(cell.traffic["niter"])
    damp = float(cell.config["damp"])
    Xr, Cr = ref.solve(cell.config, seed, Y, niter, damp, device, precision)
    if control:
        Xc, Cc = ref.solve(cell.config, seed, Y, niter, damp, device, "tf32")
        answers = [(j, Xc[j].cpu(), Cc[j].cpu()) for j in range(Y.shape[0])]
        iters = [niter]
    else:
        answers = [(j, record["kept_rows"][n], record["kept_costs"][n])
                   for n, (_, j) in enumerate(record["kept_ids"])]
        iters = record["iters"]
    return compare.checks(answers, Xr.cpu(), Cr.cpu(), iters, niter,
                          cell.limits)


def main(argv=None) -> int:
    args = parse_args(argv)
    from portbench.harness import spec
    cell = spec.cell(args.workload)
    test = json.loads(args.test_cpu) if args.test_cpu else None
    if test:
        cell.config.update(test.get("config", {}))
        cell.traffic.update(test.get("traffic", {}))
        cell.limits.update(test.get("limits", {}))
    import torch
    if test is None:
        if not torch.cuda.is_available():
            print("portbench: no CUDA device", file=sys.stderr)
            return 3
        if torch.cuda.device_count() < cell.chips:
            print(f"portbench: {cell.name} needs {cell.chips} cards, "
                  f"{torch.cuda.device_count()} seen", file=sys.stderr)
            return 3
    if cell.chips != 1:
        print(f"portbench: {cell.name} asks for {cell.chips} cards; this "
              "harness runs one", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    device = torch.device("cuda", 0) if test is None else torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    import pylops_mpi_tpu_torch as pmtt
    if args.calibrate:
        return _calibrate(device, cell, args, torch, pmtt)
    record = measure(device, cell, args.seed, args.seconds, bool(args.trace),
                     torch, pmtt)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = judge(cell, args.seed, record, device)
    # after the window and the reference alike: nothing of the JAX side
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded {found} (the JAX side must not load)",
              file=sys.stderr)
        return 1
    times = record["times"]
    print(json.dumps({"resolved": record["resolved"], "solves": len(times),
                      "solve_ms": {f"p{q}": _quantile(times, q / 100) * 1e3
                                   for q in (0, 50, 95, 100)}}), flush=True)
    line = result_line(cell, record, checks, bool(args.trace), torch,
                       device)
    for name, c in checks["numbers"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def _quantile(values: List[float], q: float) -> float:
    """The ``q`` quantile with linear interpolation between order
    statistics (numpy's default)."""
    v = sorted(values)
    if not v:
        return float("nan")
    pos = q * (len(v) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def result_line(cell, record: dict, checks: dict, trace: bool, torch,
                device) -> dict:
    """The last line: ``correct``, ``attempted``, ``failed``, the cell's
    metrics (end to end, or per layer with ``trace``), ``device``, the
    ``breakdown`` of a traced run, and the numbers compared last."""
    from portbench.harness import spec
    from portbench.harness.context import Context
    ctx = Context(cell=cell, record=record, quantile=_quantile)
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = spec.metric_reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    cuda = device.type == "cuda"
    info = {"platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
            "count": 1, "memory_peak_bytes": record["peak"]}
    line = {"correct": checks["correct"], "attempted": len(record["times"]),
            "failed": checks["failed"], "metrics": metrics, "device": info}
    s = record["trace"]
    if trace and s:
        info["busy_s"] = s["busy_s"]
        info["window_s"] = s["span_s"]
        line["breakdown"] = {"device_ops": [list(p) for p in s["device_ops"]],
                             "idle_gaps": [list(p) for p in s["idle_gaps"]]}
    line["checks"] = checks["numbers"]
    return line


def _calibrate(device, cell, args, torch, pmtt) -> int:
    """For each seed of ``--calibrate``: a short window and its checks, then
    the control's checks; one JSON line each."""
    for seed in [int(s) for s in args.calibrate.split(",")]:
        record = measure(device, cell, seed, args.seconds, False, torch,
                         pmtt)
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        prog = judge(cell, seed, record, device)
        ctrl = judge(cell, seed, record, device, control=True)
        print(json.dumps({"seed": seed, "solves": len(record["times"]),
                          "program": prog["numbers"],
                          "control": ctrl["numbers"]}), flush=True)
        del record
    return 0
