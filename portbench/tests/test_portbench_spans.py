"""The program's spans in the trace (:mod:`portbench.harness.spans`): the
summary by hand on a synthetic trace (innermost attribution, inclusive and
self device time, idle under the span the host was in when the device ran
dry), the window's own summary unchanged on the same trace, the new
readers on empty and full traces, and a traced CPU run of each cell."""

import json

import pytest

from helpers import ROOT, TINY, run_cell
from portbench.harness import runner, spans, spec
from portbench.harness import trace as tr
from portbench.harness.context import Context

CELLS = {w["name"]: w["config"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]}
NEW = ("check_idle_pct", "vector_ms_per_iter", "setup_ms_per_solve",
       "modelling_apply_roofline", "gradient_apply_roofline")
US = 1e-6


def ev(cat, name, ts, dur, corr=None, tid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def events():
    """One solve over [0, 100] µs: a set-up apply, two segments (the
    fused product in the first), a host check that drains the queue and
    the read-back; a solve before the traced span that must not count."""
    ua, rt = "user_annotation", "cuda_runtime"
    return [
        ev(ua, "portbench.solve", 0, 100),
        ev(ua, "solver.cgls", 1, 98),
        ev(ua, "solver.setup", 2, 8),
        ev(ua, "MPIBlockDiag.matvec", 3, 2),
        ev(rt, "cudaLaunchKernel", 3.5, 0.5, corr=1),
        ev(ua, "solver.segment", 10, 30),
        ev(ua, "portbench.normal_apply", 10.8, 9.4),
        ev(ua, "MPIBlockDiag.normal_matvec", 11, 9),
        ev(rt, "cudaLaunchKernel", 12, 0.5, corr=2),
        ev(rt, "cudaLaunchKernel", 25, 0.5, corr=3),
        ev(ua, "solver.check", 40, 20),
        ev(rt, "cudaStreamSynchronize", 41, 18),
        ev(ua, "solver.segment", 60, 20),
        ev(rt, "cudaLaunchKernel", 61, 0.5, corr=4),
        ev(ua, "solver.readback", 80, 15),
        ev(rt, "cudaMemcpyAsync", 81, 1, corr=5),
        # the solve before the traced ones
        ev(ua, "solver.cgls", -50, 40),
        ev(rt, "cudaLaunchKernel", -40, 0.5, corr=9),
        ev("kernel", "gemv", 6, 6, corr=1, tid=7),
        ev("kernel", "normal_kernel", 13, 17, corr=2, tid=7),
        ev("kernel", "axpy", 31, 14, corr=3, tid=7),
        ev("kernel", "axpy", 62, 8, corr=4, tid=7),
        ev("gpu_memcpy", "Memcpy DtoH", 82, 1, corr=5, tid=7),
        ev("kernel", "gemv", -39, 9, corr=9, tid=7),
    ]


def test_program_spans_by_hand():
    found = spans.program_spans(events())
    assert found["span_s"] == pytest.approx(100 * US)
    assert found["busy_s"] == pytest.approx(46 * US)
    s = found["spans"]
    want = {  # calls, device, self device, idle (µs)
        "solver.cgls": (1, 46, 0, 0),
        "solver.setup": (1, 6, 0, 0),
        "MPIBlockDiag.matvec": (1, 6, 6, 0),
        "solver.segment": (2, 39, 22, 13),  # [30, 31] and [70, 82]
        "MPIBlockDiag.normal_matvec": (1, 17, 17, 1),  # [12, 13]
        "solver.check": (1, 0, 0, 17),  # ran dry at 45, refilled at 62
        "solver.readback": (1, 1, 1, 17),  # [83, 100]
    }
    assert set(s) == set(want)
    for name, (calls, dev, self_dev, idle) in want.items():
        st = s[name]
        assert st["calls"] == calls, name
        assert st["device_s"] == pytest.approx(dev * US), name
        assert st["self_device_s"] == pytest.approx(self_dev * US), name
        assert st["idle_s"] == pytest.approx(idle * US), name
    # [0, 6] began before the solve's first span: under no program span
    assert sum(st["idle_s"] for st in s.values()) == pytest.approx(48 * US)


def test_program_spans_without_a_solve_is_empty():
    assert spans.program_spans([e for e in events()
                                if e["name"] != tr.SOLVE_RANGE]) == {}


def test_keys_that_were_there_are_unchanged():
    """The window's own summary of the same trace: its keys and values,
    with the program's ranges among the host operations that name a
    gap."""
    s = tr.summarize(events())
    assert set(s) == {"span_s", "busy_s", "kernels", "device_ops",
                      "idle_gaps", "ranges"}
    assert s["span_s"] == pytest.approx(100 * US)
    assert s["busy_s"] == pytest.approx(46 * US)
    assert s["kernels"] == 4
    assert [n for n, _ in s["device_ops"]] == ["axpy", "normal_kernel",
                                               "gemv", "Memcpy DtoH"]
    assert [v for _, v in s["device_ops"]] == pytest.approx(
        [22 * US, 17 * US, 6 * US, 1 * US])
    assert s["ranges"] == {"portbench.normal_apply": {
        "calls": 1, "device_s": pytest.approx(17 * US)}}
    idle = dict(s["idle_gaps"])
    assert idle == pytest.approx({
        "cuda_runtime:cudaStreamSynchronize": 17 * US,
        "user_annotation:solver.readback": 17 * US,
        "user_annotation:solver.segment": 13 * US,
        "user_annotation:MPIBlockDiag.matvec": 6 * US,
        "cuda_runtime:cudaLaunchKernel": 1 * US})


def _ctx(trace_events, program=None, traced_iters=16, npoints=1000):
    """A traced run's context whose program spans were traced as
    ``program`` (events), or not at all where it is ``None``."""
    import torch
    cell = spec.cell("poststack-gradient")
    summary = tr.summarize(trace_events) if trace_events is not None \
        else None
    record = {"trace": summary, "traced_iters": traced_iters, "bounds": {},
              "data_rows": torch.zeros(1, npoints)}
    found = spans.program_spans(program) if program is not None else {}
    if found:
        found["traced_iters"] = traced_iters
    spans._SUMMARIES[id(record)] = found
    return Context(cell=cell, record=record, quantile=runner._quantile)


@pytest.mark.parametrize("name", NEW)
def test_new_readers_none_on_an_empty_trace(name):
    reader = spec.metric_reader(name)
    assert reader.read(_ctx([])) is None
    assert reader.read(_ctx(None)) is None
    # a trace without the program's spans (the program before they were
    # opened) reads nothing either
    bare = [e for e in events() if e["name"].startswith("portbench.")
            or e["cat"] != "user_annotation"]
    assert reader.read(_ctx(bare, program=bare)) is None


@pytest.mark.parametrize("name", NEW)
def test_new_readers_trace_nothing_where_the_program_opens_no_range(
        name, monkeypatch):
    """A program whose spans stay out of the profiler (the one before
    them) is not traced again: its readers read nothing."""
    def no_trace(*a, **k):
        raise AssertionError("traced a program that opens no range")
    monkeypatch.setattr(spans, "opens_ranges", lambda torch: False)
    monkeypatch.setattr(spans, "trace_solves", no_trace)
    ctx = _ctx(events())
    spans._SUMMARIES.pop(id(ctx.record))
    assert spec.metric_reader(name).read(ctx) is None


def test_new_readers_on_the_trace():
    npoints = 1000
    ctx = _ctx(events(), program=events(), traced_iters=16, npoints=npoints)
    read = {n: spec.metric_reader(n).read(ctx) for n in NEW}
    assert read["check_idle_pct"] == pytest.approx(34.0)  # 17 + 17 of 100
    assert read["vector_ms_per_iter"] == pytest.approx(22e-3 / 16)
    assert read["setup_ms_per_solve"] == pytest.approx(6e-3)
    assert read["modelling_apply_roofline"] == pytest.approx(
        100 * spans.modelling_apply(npoints).seconds() / (6 * US))
    assert read["gradient_apply_roofline"] is None  # not traced


def test_bounds_of_the_applies():
    assert spans.modelling_apply(10).nbytes == 80.0
    assert spans.gradient_apply(10).nbytes == 120.0
    assert spans.gradient_apply(10, itemsize=8).nbytes == 240.0


def test_traced_cpu_solves_hold_the_program_spans():
    """The program's spans of the main path's solves, traced on the CPU:
    each span there, the fused product once an iteration; with no device
    work in it, the readers read nothing."""
    import torch
    import pylops_mpi_tpu_torch as pmtt
    assert spans.opens_ranges(torch)
    cell = spec.cell("blockdiag-normal")
    cell.config.update(TINY[cell.config_name])
    found = spans.trace_solves(cell, 2 ** 31 + 5, torch.device("cpu"),
                               torch, pmtt)
    s = found["spans"]
    for name in ("solver.cgls", "solver.setup", "solver.segment",
                 "solver.check", "solver.readback",
                 "MPIBlockDiag.normal_matvec"):
        assert s[name]["calls"] >= 1, name
    n_solves = s["solver.cgls"]["calls"]
    assert s["MPIBlockDiag.normal_matvec"]["calls"] == \
        n_solves * int(cell.traffic["niter"])
    assert found["traced_iters"] == n_solves * int(cell.traffic["niter"])
    assert found["traced_iters"] >= int(cell.traffic["trace_iters"])
    assert found["busy_s"] == 0.0
    record = {"trace": {"busy_s": 0.0}, "data_rows": torch.zeros(1, 8)}
    spans._SUMMARIES[id(record)] = found
    ctx = Context(cell=cell, record=record, quantile=runner._quantile)
    assert all(spec.metric_reader(n).read(ctx) is None for n in NEW)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_traced_cpu_run_reads_every_metric(cell):
    """A traced run of each cell on the CPU runs every per-layer reader,
    the new ones included (their own traced solves too), without error,
    and comes out correct."""
    rc, line, err = run_cell(cell, CELLS[cell], trace=1, seed=2 ** 31 + 9)
    assert rc == 0, err
    assert line["correct"], line
    assert set(line["metrics"]) <= {m["name"] for m in
                                    spec.cell(cell).per_layer}
