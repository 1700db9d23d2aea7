"""The port's trace, metrics, stage-budget, retry and heartbeat/drain
layers held against the JAX package: the same calls made through both
give the same span trees, events, counters, gauges, histogram summaries
and quantiles, the same snapshot round trip, the same budget for every
stage with and without its override, the same deadline-runner records,
and the same retry schedule. Every sleep is injected or bounded (the
heartbeat test polls for a file at 5 ms steps).
"""

import json
import os
import signal
import threading
import time

import pytest

from pylops_mpi_tpu.diagnostics import metrics as jmetrics
from pylops_mpi_tpu.diagnostics import profiler as jprofiler
from pylops_mpi_tpu.diagnostics import trace as jtrace
from pylops_mpi_tpu.resilience import retry as jretry
from pylops_mpi_tpu_torch.diagnostics import metrics as tmetrics
from pylops_mpi_tpu_torch.diagnostics import profiler as tprofiler
from pylops_mpi_tpu_torch.diagnostics import trace as ttrace
from pylops_mpi_tpu_torch.resilience import elastic, retry as tretry

PAIRS = ((jtrace, jmetrics, "PYLOPS_MPI_TPU_"),
         (ttrace, tmetrics, "PYLOPS_MPI_TPU_TORCH_"))


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for pre in ("PYLOPS_MPI_TPU_", "PYLOPS_MPI_TPU_TORCH_"):
        for k in ("TRACE", "TRACE_FILE", "METRICS", "METRICS_FILE",
                  "RETRIES", "RETRY_BACKOFF", "RETRY_JITTER", "HEARTBEAT",
                  "HEARTBEAT_FILE"):
            monkeypatch.delenv(pre + k, raising=False)
    for tr, me, _ in PAIRS:
        tr.clear_events()
        me.clear_metrics()
    elastic.reset_drain()
    yield
    for tr, me, _ in PAIRS:
        tr.clear_events()
        me.clear_metrics()
    elastic.reset_drain()


def _strip(node):
    """A span-tree node without its timings."""
    return (node["name"], node["dur"] is None,
            {k: v for k, v in node["args"].items()},
            [_strip(c) for c in node["children"]])


def _workload(tr):
    with tr.span("solve", cat="solver", shape=(4, 3), n=2):
        with tr.span("apply", cat="operator") as s:
            s.tag(chunks=3)
            tr.event("note", cat="event", why="fallback")
        with tr.span("apply", cat="operator"):
            tr.counter("resid", {"k": 0.5})
    tr.event("after", size=7)


def test_spans_events_counters_match_jax(monkeypatch):
    trees, kinds = [], []
    for tr, _, pre in PAIRS:
        monkeypatch.setenv(pre + "TRACE", "spans")
        _workload(tr)
        evs = tr.get_events()
        kinds.append([(e["name"], e["ph"], e["cat"],
                       {k: v for k, v in e["args"].items()}) for e in evs])
        trees.append([_strip(n) for n in tr.span_tree(evs)])
    assert kinds[1] == kinds[0]
    assert trees[1] == trees[0]
    root = trees[1][0]
    assert root[0] == "solve" and [c[0] for c in root[3]] == ["apply",
                                                              "apply"]
    assert root[3][0][2]["chunks"] == 3 and root[3][0][2]["parent"] == \
        "solve"


def test_trace_off_records_nothing_and_open_spans_dump(monkeypatch,
                                                      tmp_path):
    _workload(ttrace)
    assert ttrace.get_events() == []
    assert ttrace.span("x") is ttrace.span("y")  # the shared no-op
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_TRACE", "spans")
    monkeypatch.setenv("PYLOPS_MPI_TPU_TRACE", "spans")
    outs = []
    for tr, path in ((jtrace, tmp_path / "j.jsonl"),
                     (ttrace, tmp_path / "t.jsonl")):
        with tr.span("outer"):
            with tr.span("inner"):
                pass
            n = tr.dump(str(path))
        lines = [json.loads(line) for line in open(path)]
        # the port's dump opens with the event that names its clock
        assert n == len(lines) == 2 + (tr is ttrace)
        outs.append([_strip(t) for t in tr.span_tree(lines)])
        with pytest.raises(ValueError, match="fmt"):
            tr.dump(str(path), fmt="xml")
    assert outs[0] == outs[1]
    assert outs[1][0][0] == "outer" and outs[1][0][1]  # still open: dur None
    # garbage lines degrade, never raise
    assert ttrace.span_tree([1, {"ph": "X"}, {"ph": "X", "name": "a",
                                              "ts": 1.0, "args": "?"}])[0][
        "name"] == "a"
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_TRACE", "sideways")
    monkeypatch.setattr(ttrace, "_warned_mode", False)
    with pytest.warns(UserWarning, match="PYLOPS_MPI_TPU_TORCH_TRACE"):
        assert ttrace.trace_mode() == "off"


def _metric_workload(me):
    me.inc("serve.requests")
    me.inc("serve.requests", 2)
    me.set_gauge("serve.queue.depth", 5)
    for v in range(1, 101):
        me.observe("serve.queue.wait_s", float(v))
    me.collective_bytes("all_reduce", 64)
    me.collective_bytes("all_reduce", 32, fabric="ici")
    me.collective_bytes("spill", 16, fabric="h2d")
    with me.timer("stage"):
        pass


def test_metrics_match_jax_and_roundtrip(monkeypatch, tmp_path):
    snaps = []
    for _, me, pre in PAIRS:
        _metric_workload(me)  # off: nothing
        assert me.snapshot()["counters"] == {}
        assert me.hist_quantiles("serve.queue.wait_s") is None
        monkeypatch.setenv(pre + "METRICS", "on")
        _metric_workload(me)
        snaps.append(me.snapshot())
        q = me.hist_quantiles("serve.queue.wait_s")
        assert q["p50"] in (50.0, 51.0) and q["p99"] == 99.0
        q = me.hist_quantiles("serve.queue.wait_s", qs=(0.0, 1.0))
        assert q == {"p0": 1.0, "p100": 100.0}
    j, t = snaps
    assert t["counters"] == j["counters"]
    assert t["gauges"] == j["gauges"]
    hj = {k: v for k, v in j["histograms"].items() if k != "stage.wall_s"}
    ht = {k: v for k, v in t["histograms"].items() if k != "stage.wall_s"}
    assert ht == hj and t["histograms"]["stage.wall_s"]["count"] == 1
    assert t["schema"] == j["schema"] == tmetrics.SNAPSHOT_SCHEMA
    path = tmetrics.write_snapshot(str(tmp_path / "m" / "snap.json"))
    back = tmetrics.read_snapshot(path)
    assert back["counters"] == t["counters"]
    assert jmetrics.read_snapshot(path)["counters"] == t["counters"]
    assert tmetrics.read_snapshot(str(tmp_path / "missing.json")) is None
    (tmp_path / "bad.json").write_text("[1, 2]")
    assert tmetrics.read_snapshot(str(tmp_path / "bad.json")) is None
    assert tmetrics.write_snapshot() is None  # no file configured


def test_stage_budgets_match_jax_for_every_stage_and_override():
    assert tprofiler.STAGE_BUDGETS == jprofiler.STAGE_BUDGETS
    for stage in jprofiler.STAGE_BUDGETS:
        name = jprofiler._env_name(stage)
        assert tprofiler._env_name(stage) == name
        for env in ({}, {name: "17"}, {name: "junk"}):
            for rehearse in (False, True):
                assert tprofiler.stage_budget(stage, rehearse, env) == \
                    jprofiler.stage_budget(stage, rehearse, env)
    for mod in (tprofiler, jprofiler):
        with pytest.raises(KeyError, match="unknown harvest stage"):
            mod.stage_budget("nope")


def test_deadline_runner_records_match_jax():
    def good(eff):
        return {"v": eff}, None

    def boom(eff):
        raise RuntimeError("bad stage")

    recs = []
    for mod in (jprofiler, tprofiler):
        logged = []
        r = mod.DeadlineRunner(deadline_ts=time.time() + 1000,
                               min_stage_s=0, log=logged.append)
        a = r.run("serve_batch", good, 120)
        b = r.run("serve_batch", boom, 120)
        past = mod.DeadlineRunner(deadline_ts=time.time() - 5, min_stage_s=0)
        c = past.run("serve_batch", good, 120)
        none = mod.DeadlineRunner(min_stage_s=0).run("tune", good, 60)
        keys = ("stage", "budget_s", "effective_timeout_s", "ok", "skipped",
                "banked_partial")
        recs.append(([{k: x.get(k) for k in keys} for x in (a, b, none)],
                     b["error"], c["skipped"], c["reason"][:16], a.result,
                     len(logged), r.report()["skipped"]))
    assert recs[1] == recs[0]
    assert recs[1][1] == "stage raised: RuntimeError('bad stage')"


def test_retry_schedule_matches_jax():
    import random
    schedules = []
    for mod in (jretry, tretry):
        slept, calls = [], []

        def flaky():
            calls.append(1)
            if len(calls) < 4:
                raise OSError("refused")
            return "up"

        assert mod.retry_call(flaky, retries=5, backoff_s=0.5, jitter=0.25,
                              sleep=slept.append,
                              rng=random.Random(3)) == "up"
        with pytest.raises(OSError):
            mod.retry_call(lambda: (_ for _ in ()).throw(OSError("x")),
                           retries=1, backoff_s=0.0, sleep=slept.append)
        with pytest.raises(ValueError):
            mod.retry_call(lambda: (_ for _ in ()).throw(ValueError("no")),
                           retry_if=lambda e: False, sleep=slept.append)
        schedules.append(slept)
    assert schedules[1] == schedules[0]


def test_retry_knobs(monkeypatch):
    for raw, want in [("5", 5), ("-1", 0), ("junk", 3)]:
        monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_RETRIES", raw)
        assert tretry.default_retries() == want
    for raw, want in [("0.1", 0.1), ("-2", 0.0), ("junk", 0.5)]:
        monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_RETRY_BACKOFF", raw)
        assert tretry.default_backoff_s() == want
    for raw, want in [("0.3", 0.3), ("7", 1.0), ("junk", 0.0)]:
        monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_RETRY_JITTER", raw)
        assert tretry.default_jitter() == want


def test_heartbeat_writes_beats_with_metrics(monkeypatch, tmp_path):
    path = tmp_path / "hb" / "beat.json"
    assert elastic.maybe_start_heartbeat() is None  # unsupervised
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_METRICS", "on")
    tmetrics.inc("serve.requests")
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_HEARTBEAT_FILE", str(path))
    w = elastic.maybe_start_heartbeat()
    try:
        assert elastic.start_heartbeat() is w
        end = time.monotonic() + 5.0
        while not path.exists() and time.monotonic() < end:
            time.sleep(0.005)
        beat = elastic.read_heartbeat(str(path))
    finally:
        elastic.stop_heartbeat()
    assert not w.is_alive()
    assert beat["pid"] == os.getpid() and beat["seq"] >= 1
    assert beat["metrics"]["counters"]["serve.requests"] == 1
    assert elastic.read_heartbeat(str(tmp_path / "none.json")) is None
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_HEARTBEAT", "0.001")
    assert elastic.heartbeat_interval() == 0.05


def test_drain_flag_and_sigterm_chain():
    assert not elastic.drain_requested()
    elastic.request_drain()
    assert elastic.drain_requested()
    elastic.reset_drain()
    seen = []
    prev = signal.getsignal(signal.SIGTERM)
    try:
        signal.signal(signal.SIGTERM, lambda s, f: seen.append(s))
        assert elastic.install_sigterm_drain()
        assert elastic.install_sigterm_drain()  # a second call keeps it
        os.kill(os.getpid(), signal.SIGTERM)
        end = time.monotonic() + 5.0
        while not seen and time.monotonic() < end:
            time.sleep(0.005)
        assert elastic.drain_requested()
        assert seen == [signal.SIGTERM]  # the previous handler ran too
    finally:
        signal.signal(signal.SIGTERM, prev)
    out = []
    t = threading.Thread(target=lambda: out.append(
        elastic.install_sigterm_drain()))
    t.start()
    t.join(timeout=10)
    assert out == [False]


def test_profile_capture(tmp_path):
    with tprofiler.profile_capture("region"):
        pass  # no directory: a no-op
    assert not any(tmp_path.iterdir())
    import torch
    with tprofiler.profile_capture("region", str(tmp_path / "out")):
        torch.ones(4).sum()
    trace = json.loads((tmp_path / "out" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "region" in names


# ------------------------------------------ operator, solver, collectives
LOOP_SPANS = {"solver.setup", "solver.segment", "solver.check",
              "solver.readback"}

def _solver_workload(pkg, conv, tr):
    """``cgls`` (5 iterations), ``ista`` (5) and one ``matvec`` on one
    4-block ``MPIBlockDiag``: the operator and solver spans of both
    packages, as ``(name, cat, tag keys)`` per name and the ``op`` tags."""
    import numpy as np
    rng = np.random.default_rng(0)
    blocks = [rng.standard_normal((6, 5)) + 2 * np.eye(6, 5)
              for _ in range(4)]
    y = rng.standard_normal(24)
    op, yy, x0 = conv(blocks, y, np.zeros(20))
    pkg.cgls(op, yy, niter=5, tol=0.0)
    pkg.ista(op, yy, x0, niter=5, tol=0.0)
    op.matvec(x0)
    seen = {}
    for e in tr.get_events():
        keys = set(e["args"]) - {"mesh_axes", "jax_tracing"}
        seen.setdefault(e["name"], (e["cat"], frozenset(keys),
                                    e["args"].get("op")))
    return seen


def test_operator_and_solver_spans_match_jax(monkeypatch):
    import numpy as np
    import pylops_mpi_tpu as pmt
    import pylops_mpi_tpu_torch as pmtt
    from pylops_mpi_tpu.ops.local import MatrixMult as JM

    def jconv(blocks, y, x0):
        return (pmt.MPIBlockDiag([JM(b) for b in blocks]),
                pmt.DistributedArray.to_dist(y),
                pmt.DistributedArray.to_dist(x0))

    def tconv(blocks, y, x0):
        return (pmtt.convert.blockdiag_from_numpy(blocks, device="cpu"),
                pmtt.DistributedArray.to_dist(y, device="cpu"),
                pmtt.DistributedArray.to_dist(x0, device="cpu"))

    # tracing off: the port records nothing, op_span is the shared no-op
    _solver_workload(pmtt, tconv, ttrace)
    assert ttrace.get_events() == []
    assert ttrace.op_span(object(), "matvec") is ttrace.span("x")
    out = []
    for pkg, conv, (tr, _, pre) in ((pmt, jconv, PAIRS[0]),
                                    (pmtt, tconv, PAIRS[1])):
        monkeypatch.setenv(pre + "TRACE", "spans")
        out.append(_solver_workload(pkg, conv, tr))
    j, t = out
    # names and tags, not counts: the JAX package opens op_span once at
    # trace time under jit, the port at every apply. The port's loops
    # add spans of their own, and every span under a solve carries its
    # number, which the JAX package has no counterpart of
    assert set(t) - LOOP_SPANS == set(j) == {
        "MPIBlockDiag.matvec", "MPIBlockDiag.rmatvec",
        "_AdjointLinearOperator.matvec", "_ProductLinearOperator.matvec",
        "solver.cgls", "solver.ista"}
    assert set(t) & LOOP_SPANS == LOOP_SPANS
    assert "solve" in t["solver.cgls"][1]
    assert {n: (c, keys - {"solve"}, o) for n, (c, keys, o) in t.items()
            if n not in LOOP_SPANS} == j


class _NoTransfer:
    """A stand-in for posted point-to-point transfers that moves nothing."""

    def __init__(self, sends, recvs, group=None):
        pass

    def wait(self):
        pass


def test_collectives_count_into_the_registry(monkeypatch, tmp_path):
    import torch
    import torch.distributed as dist
    import pylops_mpi_tpu_torch as pmtt
    from pylops_mpi_tpu_torch.parallel import collectives as co
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_METRICS", "on")
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_TRACE", "spans")
    co.reset_counts()
    pmtt.parallel.init(backend="gloo", world_size=1, rank=0, device="cpu",
                       store=dist.FileStore(str(tmp_path / "store"), 1))
    try:
        x = pmtt.DistributedArray.to_dist(torch.arange(6.0), device="cpu")
        x.dot(x)
        x.norm()
        co.all_gather(torch.ones(3), [3])
        # a Cartesian exchange along an axis of two ranks, its transfer
        # stubbed: the event of JAX ``collectives.py:338``
        monkeypatch.setattr(co, "world_size", lambda: 2)
        monkeypatch.setattr(co, "_Posted", _NoTransfer)
        co.cart_halo_extend(torch.ones(4, 3), (2, 1), 0, 1, 1)
    finally:
        pmtt.parallel.destroy()
    counters = tmetrics.snapshot()["counters"]
    for name, n in co.counts.items():
        assert counters[f"collective.{name}.calls"] == n
        assert counters[f"collective.{name}.bytes"] == co.received[name]
    assert co.counts["all_reduce"] == 2 and co.counts["all_gather"] == 1
    ev = [e for e in ttrace.get_events()
          if e["name"] == "collective.cart_halo_extend"]
    assert len(ev) == 1 and ev[0]["cat"] == "collective"
    assert set(ev[0]["args"]) == {"shape", "dtype", "axis", "grid", "ax",
                                  "hm", "hp", "seq"}
    assert ev[0]["args"]["grid"] == [2, 1] and co.counts[
        "cart_halo_extend"] == 1


# ---------------------------------------------- the spans in the device trace
def _normal_system(n_blocks=4, m=6):
    import numpy as np
    import pylops_mpi_tpu_torch as pmtt
    rng = np.random.default_rng(5)
    blocks = [rng.standard_normal((m, m)) + 3 * np.eye(m)
              for _ in range(n_blocks)]
    op = pmtt.convert.blockdiag_from_numpy(blocks, device="cpu")
    y = pmtt.DistributedArray.to_dist(rng.standard_normal(n_blocks * m),
                                      device="cpu")
    return op, y


def _profiled(fn, path):
    """``fn()`` under a CPU ``torch.profiler`` session; its result and
    the exported Chrome trace."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    prof.export_chrome_trace(str(path))
    return out, json.loads(path.read_text())


def _ranges(doc):
    return [e for e in doc["traceEvents"]
            if e.get("cat") == "user_annotation" and e.get("ph") == "X"]


def _inside(inner, outer):
    return (outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def test_profiler_holds_the_solve_spans_with_tracing_off(tmp_path):
    """With the mode unset, a profiled ``cgls(normal=True)`` holds the
    loop's ranges and the fused product's, nested as the loop opens
    them."""
    import pylops_mpi_tpu_torch as pmtt
    assert ttrace.trace_mode() == "off"
    op, y = _normal_system()
    _, doc = _profiled(lambda: pmtt.cgls(op, y, niter=20, tol=0.0,
                                         normal=True), tmp_path / "t.json")
    by = {}
    for e in _ranges(doc):
        by.setdefault(e["name"], []).append(e)
    assert {"solver.cgls", "solver.setup", "solver.segment", "solver.check",
            "solver.readback", "MPIBlockDiag.normal_matvec"} <= set(by)
    (root,) = by["solver.cgls"]
    assert len(by["MPIBlockDiag.normal_matvec"]) == 20
    # 20 iterations: segments at 0 and 8, an eager tail at 16, a check
    # before each but the first
    assert len(by["solver.segment"]) == 3 and len(by["solver.check"]) == 2
    for name in ("solver.setup", "solver.segment", "solver.check",
                 "solver.readback"):
        assert all(_inside(e, root) for e in by[name]), name
    assert all(any(_inside(e, seg) for seg in by["solver.segment"])
               for e in by["MPIBlockDiag.normal_matvec"])
    (setup,) = by["solver.setup"]
    assert all(_inside(e, setup) for e in by["MPIBlockDiag.matvec"]
               + by["MPIBlockDiag.rmatvec"])
    # no loop span overlaps another
    loop = sorted(by["solver.setup"] + by["solver.segment"]
                  + by["solver.check"] + by["solver.readback"],
                  key=lambda e: e["ts"])
    assert all(a["ts"] + a["dur"] <= b["ts"] for a, b in zip(loop, loop[1:]))
    assert ttrace.get_events() == []  # the buffer stays gated by the mode


def test_no_profiler_no_range(monkeypatch):
    """Tracing off and no profiler: both entry points give the shared
    no-op and no ``record_function`` is entered; under a profiler the
    same solve enters one a span."""
    import torch.autograd.profiler as ap
    import pylops_mpi_tpu_torch as pmtt
    entered = []
    real = ap.record_function

    class Counting(real):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(ap, "record_function", Counting)
    assert ttrace.span("x") is ttrace._NOOP
    assert ttrace.op_span(object(), "matvec") is ttrace._NOOP
    op, y = _normal_system()
    pmtt.cgls(op, y, niter=10, tol=0.0, normal=True)
    assert entered == []
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        assert ttrace.span("x") is not ttrace._NOOP
        pmtt.cgls(op, y, niter=10, tol=0.0, normal=True)
    assert entered.count("MPIBlockDiag.normal_matvec") == 10
    assert entered.count("solver.cgls") == 1


def test_jsonl_spans_on_the_profiler_clock(monkeypatch, tmp_path):
    """A span's JSONL start and its profiler range's start, the trace's
    base added, agree within 1 ms; the dump names the clock."""
    import pylops_mpi_tpu_torch as pmtt
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_TRACE", "spans")
    op, y = _normal_system()
    _, doc = _profiled(lambda: pmtt.cgls(op, y, niter=20, tol=0.0,
                                         normal=True), tmp_path / "t.json")
    base_us = doc["baseTimeNanoseconds"] / 1e3
    prof = {}
    for e in _ranges(doc):
        prof.setdefault(e["name"], []).append(float(e["ts"]) + base_us)
    spans = {}
    for e in ttrace.get_events():
        spans.setdefault(e["name"], []).append(e["ts"])
    for name in ("solver.cgls", "solver.setup", "solver.segment",
                 "solver.check", "solver.readback",
                 "MPIBlockDiag.normal_matvec"):
        assert len(spans[name]) == len(prof[name]), name
        for a, b in zip(sorted(spans[name]), sorted(prof[name])):
            assert abs(a - b) < 1e3, (name, a, b)
    n = ttrace.dump(str(tmp_path / "t.jsonl"))
    first = json.loads(open(tmp_path / "t.jsonl").readline())
    assert n == len(ttrace.get_events()) + 1
    assert first["ph"] == "M" and first["args"]["clock"] == ttrace.CLOCK
    assert abs(spans["solver.cgls"][0] - time.time_ns() / 1e3) < 60e6


@pytest.mark.parametrize("normal", [True, False])
def test_solves_bitwise_with_profiler_and_tracing(monkeypatch, tmp_path,
                                                  normal):
    """``x``, ``iiter`` and the cost history are bitwise the same with the
    profiler on or off and the mode ``off`` or ``spans``."""
    import torch
    import pylops_mpi_tpu_torch as pmtt
    op, y = _normal_system()
    outs = []
    for mode in ("off", "spans"):
        monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_TRACE", mode)
        for prof in (False, True):
            def solve():
                return pmtt.cgls(op, y, niter=19, tol=0.0, damp=1e-3,
                                 normal=normal)
            out = (_profiled(solve, tmp_path / "t.json")[0] if prof
                   else solve())
            outs.append((out[0].array.clone(), out[2], out[5].clone()))
    x0, it0, c0 = outs[0]
    assert it0 == 19
    for x, it, c in outs[1:]:
        assert torch.equal(x, x0) and it == it0 and torch.equal(c, c0)


def test_spans_of_one_solve_share_its_number(monkeypatch):
    """Every JSONL span under a ``solver.<name>`` root carries the root's
    per-process ``solve`` number; two solves have two numbers, and a span
    outside any solve has none."""
    import pylops_mpi_tpu_torch as pmtt
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_TRACE", "spans")
    op, y = _normal_system()
    pmtt.cgls(op, y, niter=10, tol=0.0, normal=True)
    pmtt.cgls(op, y, niter=10, tol=0.0)
    op.matvec(y)
    roots = [n for n in ttrace.span_tree() if n["name"] == "solver.cgls"]
    assert len(roots) == 2

    def numbers(node):
        out = [node["args"].get("solve")]
        for c in node["children"]:
            out += numbers(c)
        return out
    ids = [set(numbers(r)) for r in roots]
    assert all(len(i) == 1 and None not in i for i in ids)
    assert ids[0] != ids[1]
    assert all(len(numbers(r)) > 5 for r in roots)
    last = ttrace.get_events()[-1]
    assert last["name"] == "MPIBlockDiag.matvec"
    assert "solve" not in last["args"]
