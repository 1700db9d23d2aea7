"""The port's solve service held against the JAX package and against its
own block solvers: bucket parsing and packing, the family checks, the
warm pool's packed solve (bitwise equal to ``block_cg``/``block_cgls`` on
the same zero-padded block, a pad column exactly zero, within 1e-12 of
the JAX package's pool and of sequential single-RHS solves in f64), the
daemon (a ragged final batch, a deadline-forced undersized dispatch, a
deadline already past, prewarm on the dispatcher thread, a poisoned
column isolated by the guards), admission (reject on full, a draining
queue), the spool (round trip, recovery, the retry budget, the drain
marker, files the JAX package wrote), ``worker_main`` in a thread, the
plan cache's banked widths, the knobs, and that the port imports no JAX.

No test sleeps more than a few tens of milliseconds; every wait and
join has a timeout; windows and deadlines are set far from the solve
times they are compared with.
"""

import os
import sys
import re
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import pylops_mpi_tpu as pmt
import pylops_mpi_tpu_torch as pmtt
from pylops_mpi_tpu import serving as jserving
from pylops_mpi_tpu.ops.local import MatrixMult as JM
from pylops_mpi_tpu.serving import spool as jspool
from pylops_mpi_tpu_torch import serving
from pylops_mpi_tpu_torch.diagnostics import metrics
from pylops_mpi_tpu_torch.resilience import elastic
from pylops_mpi_tpu_torch.serving import (AdmissionQueue, FamilySpec,
                                          QueueFull, SolveDaemon, WarmPool,
                                          bucket_for, k_buckets, pack, spool)
from pylops_mpi_tpu_torch.serving.queue import SolveRequest, batch_window_s
from pylops_mpi_tpu_torch.tuning import cache as tcache
from pylops_mpi_tpu_torch.tuning.plan import cached_batch_widths, plan_key
from pylops_mpi_tpu_torch.utils import deps

ROOT = Path(__file__).resolve().parent.parent
WAIT = 120  # seconds any ticket or thread may take before the test fails
_SCRUB = ("SERVE_QUEUE", "SERVE_WINDOW_MS", "SERVE_K_BUCKETS",
          "SERVE_DRAIN_TIMEOUT", "METRICS", "GUARDS", "RETRIES",
          "TUNE_CACHE")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in _SCRUB:
        monkeypatch.delenv("PYLOPS_MPI_TPU_TORCH_" + name, raising=False)
        monkeypatch.delenv("PYLOPS_MPI_TPU_" + name, raising=False)
    metrics.clear_metrics()
    elastic.reset_drain()
    tcache.clear_memory()
    yield
    metrics.clear_metrics()
    elastic.reset_drain()
    tcache.clear_memory()


def _mats(seed, nblk=4, n=12, dtype=np.float32):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(nblk):
        m = rng.standard_normal((n, n))
        out.append((np.eye(n) * 4 + 0.3 * (m + m.T)).astype(dtype))
    return out, rng


def family(seed=0, name="fam", solver="cg", niter=20, tol=0.0,
           dtype=np.float32, **kw):
    mats, rng = _mats(seed, dtype=dtype, **kw)
    Op = pmtt.convert.blockdiag_from_numpy(mats, device="cpu")
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    return FamilySpec(name=name, operator=Op, solver=solver, niter=niter,
                      tol=tol, dtype=tdt), mats, rng


def oracle(spec, y):
    yd = pmtt.DistributedArray.to_dist(np.asarray(y), device="cpu")
    if spec.solver == "cg":
        x = pmtt.cg(spec.operator, yd, niter=spec.niter, tol=spec.tol)[0]
    else:
        x = pmtt.cgls(spec.operator, yd, niter=spec.niter, damp=spec.damp,
                      tol=spec.tol)[0]
    return x.asarray()


def rel_close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.max(np.abs(want)))


def _requests(fam, Y):
    return [SolveRequest(f"r{j}", fam, Y[:, j], None)
            for j in range(Y.shape[1])]


# ------------------------------------------------------- buckets / pack
def test_k_buckets_parsing_matches_jax(monkeypatch):
    for raw in ("", "8, 2,junk,-3,8", "zero,,", "16,1"):
        monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_SERVE_K_BUCKETS", raw)
        monkeypatch.setenv("PYLOPS_MPI_TPU_SERVE_K_BUCKETS", raw)
        assert k_buckets() == jserving.k_buckets()
    bs = (1, 2, 4, 8, 16)
    for count in (1, 3, 16, 99):
        assert bucket_for(count, bs) == jserving.bucket_for(count, bs)


def test_pack_stacks_and_rejects_mixed(rng):
    Y = rng.standard_normal((24, 3)).astype(np.float32)
    reqs = _requests("fam", Y)
    Yp, bucket = pack(reqs, (1, 2, 4))
    np.testing.assert_array_equal(Yp, Y)
    assert bucket == 4
    reqs[1].family = "other"
    with pytest.raises(ValueError, match="one family per batch"):
        pack(reqs, (1, 2, 4))
    with pytest.raises(ValueError, match="empty batch"):
        pack([], (1, 2, 4))


def test_family_spec_checks():
    with pytest.raises(ValueError, match="'cg' or 'cgls'"):
        family(solver="ista")
    pool = WarmPool(buckets=(2,))
    spec = pool.register(family()[0])
    with pytest.raises(ValueError, match="already registered"):
        pool.register(spec)
    with pytest.raises(KeyError, match="unknown operator family"):
        pool.family("nope")
    with pytest.raises(ValueError, match="expects data length"):
        pool.solve("fam", np.zeros(7, dtype=np.float32))
    with pytest.raises(ValueError, match="exceeds the largest bucket"):
        pool.solve("fam", np.zeros((spec.nrows, 3), dtype=np.float32))
    assert spec.device == torch.device("cpu")
    # instances built alike share a signature; other shapes do not
    assert family()[0].signature() == spec.signature()
    assert family(n=6)[0].signature() != spec.signature()


# ------------------------------------------------------------ warm pool
@pytest.mark.parametrize("solver", ["cg", "cgls"])
def test_pool_solve_bitwise_block_solver_and_jax(solver):
    spec, mats, rng = family(solver=solver, dtype=np.float64)
    pool = WarmPool(buckets=(4,))
    pool.register(spec)
    Y = rng.standard_normal((spec.nrows, 3))
    out = pool.solve("fam", Y)
    assert out.x.shape == (spec.nrows, 3) and (out.k, out.bucket) == (3, 4)
    assert out.statuses == ("maxiter",) * 3 and out.wall_s > 0
    # the same padded block through the block solver: bitwise
    Yp = np.concatenate([Y, np.zeros((spec.nrows, 1))], axis=1)
    yb = pmtt.DistributedArray.to_dist(Yp, device="cpu")
    fn = pmtt.block_cg if solver == "cg" else pmtt.block_cgls
    xb = fn(spec.operator, yb, niter=spec.niter, tol=0.0)[0].asarray()
    np.testing.assert_array_equal(out.x, xb[:, :3])
    np.testing.assert_array_equal(xb[:, 3], 0.0)  # the pad stays zero
    # the JAX package's pool on the same numbers
    jpool = jserving.WarmPool(buckets=(4,))
    jpool.register(jserving.FamilySpec(
        name="fam", operator=pmt.MPIBlockDiag([JM(m) for m in mats]),
        solver=solver, niter=spec.niter, tol=0.0, dtype=np.float64))
    jout = jpool.solve("fam", Y)
    rel_close(out.x, jout.x, 1e-12)
    assert out.iiter == jout.iiter and out.statuses == jout.statuses
    # and the sequential single-RHS solves
    for j in range(3):
        rel_close(out.x[:, j], oracle(spec, Y[:, j]), 1e-12)


def test_prewarm_runs_every_bucket_and_consults_plan_cache(tmp_path,
                                                          monkeypatch):
    pool = WarmPool(buckets=(2, 4))
    spec = pool.register(family(solver="cgls")[0])
    assert pool.prewarm() == {"fam": [2, 4]}
    assert pool.warmed == {("fam", 2), ("fam", 4)}
    assert set(pool.prewarm_s) == {("fam", 2), ("fam", 4)}
    # banked widths of the operator's class choose the buckets
    path = str(tmp_path / "plans.json")
    key = plan_key(type(spec.operator).__name__, (48,), torch.float32, 1,
                   ("sp",), {"batch": 3})
    tcache.store(key, {"params": {}}, path=path)
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_TUNE_CACHE", path)
    tcache.clear_memory()
    assert cached_batch_widths("MPIBlockDiag") == [3]
    pool2 = WarmPool(buckets=(2, 4))
    pool2.register(spec)
    assert pool2.prewarm() == {"fam": [4]}
    assert pool2.prewarm(widths=[1]) == {"fam": [2]}


def test_cached_batch_widths_from_a_port_written_cache(tmp_path):
    path = str(tmp_path / "plans.json")
    for key in ("OpA|s64|f32|mesh[sp]x8|cpu:cpu",
                "OpA|s64|f32|mesh[sp]x8|cpu:cpu|b8",
                "OpA|s64|f32|mesh[sp]x8|cpu:cpu|b16|thybrid",
                "OpB|s64|f32|mesh[sp]x8|cpu:cpu|b4",
                "OpA|s64|f32|mesh[sp]x8|cpu:cpu|bbad"):
        tcache.store(key, {"params": {}}, path=path)
    tcache.clear_memory()  # read back from the file alone
    assert cached_batch_widths("OpA", path=path) == [1, 8, 16]
    assert cached_batch_widths("OpB", path=path) == [4]
    assert cached_batch_widths("OpC", path=path) == []
    from pylops_mpi_tpu.tuning.plan import cached_batch_widths as jwidths
    assert jwidths("OpA", path=path) == [1, 8, 16]  # the same file format
    assert plan_key("Op", (4000, 3), "float32", 2, ("x",),
                    {"batch": 8}).startswith("Op|s4096x4|float32|mesh[x]x2|")
    (tmp_path / "bad.json").write_text("{")
    with pytest.warns(UserWarning, match="unusable"):
        assert tcache.load_plans(str(tmp_path / "bad.json")) == {}


# ---------------------------------------------------- admission + queue
def test_reject_on_full_and_draining(monkeypatch):
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_METRICS", "on")
    q = AdmissionQueue(bound=2)
    y = np.zeros(4, dtype=np.float32)
    q.submit("fam", y)
    q.submit("fam", y)
    with pytest.raises(QueueFull, match="bound 2"):
        q.submit("fam", y)
    assert q.submitted == 2 and q.rejected == 1
    snap = metrics.snapshot()
    assert snap["counters"]["serve.rejects"] == 1
    assert snap["gauges"]["serve.queue.depth"] == 2
    q.start_drain()
    with pytest.raises(QueueFull, match="draining"):
        q.submit("fam", y)
    batch, forced = q.collect(k_max=4, window_s=0.0)  # queued work leaves
    assert len(batch) == 2 and not forced


def test_collect_takes_oldest_family_fifo():
    q = AdmissionQueue(bound=10)
    for _ in range(3):
        q.submit("a", np.zeros(4, dtype=np.float32))
    q.submit("b", np.zeros(4, dtype=np.float32))
    batch, _ = q.collect(k_max=2, window_s=0.0)
    assert [r.request_id for r in batch] == ["r0", "r1"]
    assert [r.family for r in q.collect(k_max=2, window_s=0.0)[0]] == ["a"]
    assert [r.family for r in q.collect(k_max=2, window_s=0.0)[0]] == ["b"]
    assert q.collect(k_max=2, window_s=0.0, poll_s=0.01) == ([], False)


def test_knobs_registered_and_parsed(monkeypatch):
    names = [k[0] for k in deps.SERVICE_KNOBS]
    assert names == ["PYLOPS_MPI_TPU_TORCH_" + knob for knob in (
        "GUARDS", "GUARD_STALL", "TRACE", "TRACE_FILE", "TRACE_BUFFER",
        "METRICS", "METRICS_FILE", "METRICS_INTERVAL", "HEARTBEAT",
        "HEARTBEAT_FILE", "RETRIES", "RETRY_BACKOFF", "RETRY_JITTER",
        "SERVE_K_BUCKETS", "SERVE_QUEUE", "SERVE_WINDOW_MS",
        "SERVE_DRAIN_TIMEOUT", "TUNE_CACHE", "AOT", "TUNE", "TUNE_BUDGET",
        "TUNE_TOPK", "TUNE_MARGIN", "TELEMETRY")]
    assert all(len(k) == 5 for k in deps.SERVICE_KNOBS)
    assert batch_window_s() == pytest.approx(0.010)
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_SERVE_WINDOW_MS", "-5")
    assert batch_window_s() == 0.0
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_SERVE_QUEUE", "junk")
    assert AdmissionQueue().bound == 1024
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_SERVE_DRAIN_TIMEOUT", "2.5")
    assert serving.drain_timeout_s() == 2.5


# ----------------------------------------------------- daemon dispatch
def test_ragged_final_batch_and_prewarm_on_dispatcher_thread(monkeypatch):
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_METRICS", "on")
    pool = WarmPool(buckets=(4,))
    spec, _, rng = family()
    pool.register(spec)
    threads = []
    solve = pool.solve

    def spy(name, Y):
        threads.append(threading.current_thread().name)
        return solve(name, Y)

    pool.solve = spy
    d = SolveDaemon(pool, window_s=0.2).start(prewarm=True)
    assert threads == ["pylops-torch-serve-dispatch"]
    assert d.dispatcher.prewarm_report == {"fam": [4]}
    try:
        Y = rng.standard_normal((spec.nrows, 5)).astype(np.float32)
        tickets = [d.submit("fam", Y[:, j]) for j in range(5)]
        res = [t.wait(timeout=WAIT) for t in tickets]
    finally:
        assert d.drain(timeout=WAIT)
    assert d.dispatcher.batches == 2 and d.dispatcher.solves == 5
    assert sorted(d.dispatcher.fill_samples) == [0.25, 1.0]
    assert res[4]["batch_k"] == 1 and res[4]["bucket"] == 4
    for j in range(5):
        rel_close(res[j]["x"], oracle(spec, Y[:, j]), 1e-5)
        assert 0 <= res[j]["queue_s"] <= res[j]["wait_s"]
    st = d.stats()
    assert st["wait_p99_s"] >= st["wait_p50_s"] >= 0.0
    assert st["solves_per_sec"] > 0 and st["failed"] == 0
    assert metrics.snapshot()["counters"]["serve.solves"] == 5


def test_deadline_forces_undersized_dispatch(monkeypatch):
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_METRICS", "on")
    pool = WarmPool(buckets=(8,))
    spec, _, rng = family()
    pool.register(spec)
    d = SolveDaemon(pool, window_s=30.0).start(prewarm=True)
    try:
        # a full batch goes at once and sets the margin's solve estimate
        full = rng.standard_normal((spec.nrows, 8)).astype(np.float32)
        for t in [d.submit("fam", full[:, j]) for j in range(8)]:
            t.wait(timeout=WAIT)
        Y = rng.standard_normal((spec.nrows, 3)).astype(np.float32)
        t0 = time.monotonic()
        tickets = [d.submit("fam", Y[:, j], deadline_ts=time.time() + 0.3)
                   for j in range(3)]
        res = [t.wait(timeout=WAIT) for t in tickets]
        elapsed = time.monotonic() - t0
    finally:
        d.drain(timeout=WAIT)
    assert elapsed < 10.0, "the window dispatched, not the deadline"
    assert d.dispatcher.forced == 1 and d.dispatcher.batches == 2
    assert res[0]["batch_k"] == 3 and res[0]["bucket"] == 8
    for j in range(3):
        rel_close(res[j]["x"], oracle(spec, Y[:, j]), 1e-5)
    assert metrics.snapshot()["counters"]["serve.deadline_forced"] == 1


def test_past_deadline_fails_tickets_without_a_solve(monkeypatch):
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_METRICS", "on")
    pool = WarmPool(buckets=(4,))
    spec = pool.register(family()[0])
    d = SolveDaemon(pool, window_s=30.0).start()
    try:
        t = d.submit("fam", np.ones(spec.nrows, dtype=np.float32),
                     deadline_ts=time.time() - 5.0)
        with pytest.raises(RuntimeError, match="window exhausted"):
            t.wait(timeout=WAIT)
    finally:
        d.drain(timeout=WAIT)
    assert d.dispatcher.failed == 1 and pool.warmed == set()
    assert metrics.snapshot()["counters"]["serve.deadline_missed"] == 1


def test_batch_error_fails_tickets(monkeypatch):
    pool = WarmPool(buckets=(2,))
    spec = pool.register(family()[0])

    def broken(name, Y):
        raise RuntimeError("device lost")

    pool.solve = broken
    d = SolveDaemon(pool, window_s=0.0).start()
    try:
        t = d.submit("fam", np.ones(spec.nrows, dtype=np.float32))
        with pytest.raises(RuntimeError, match="device lost"):
            t.wait(timeout=WAIT)
    finally:
        d.drain(timeout=WAIT)
    assert d.stats()["failed"] == 1


def test_poisoned_column_isolated(monkeypatch):
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_GUARDS", "on")
    pool = WarmPool(buckets=(4,))
    spec, _, rng = family(niter=80, tol=1e-6)
    pool.register(spec)
    Y = rng.standard_normal((spec.nrows, 4)).astype(np.float32)
    clean = pool.solve("fam", Y)
    Yp = Y.copy()
    Yp[0, 1] = np.nan
    d = SolveDaemon(pool, window_s=5.0).start()
    try:
        tickets = [d.submit("fam", Yp[:, j]) for j in range(4)]
        res = [t.wait(timeout=WAIT) for t in tickets]
    finally:
        d.drain(timeout=WAIT)
    assert res[1]["status"] == "breakdown"
    for j in (0, 2, 3):
        assert res[j]["status"] == "converged"
        np.testing.assert_array_equal(res[j]["x"], clean.x[:, j])


def test_daemon_requires_start_and_drains_clean(tmp_path):
    pool = WarmPool(buckets=(1,))
    spec = pool.register(family()[0])
    d = SolveDaemon(pool)
    with pytest.raises(RuntimeError, match="start"):
        d.submit("fam", np.zeros(spec.nrows, dtype=np.float32))
    d.start()
    assert d.drain(timeout=WAIT)
    with pytest.raises(RuntimeError, match="start"):
        d.submit("fam", np.zeros(spec.nrows, dtype=np.float32))
    # the supervised fleet runs now: a worker that exits clean ends it
    r = serving.serve_job([sys.executable, "-c", "pass"], 1,
                          str(tmp_path / "spool"), heartbeat_interval=0.2,
                          job_timeout_s=60)
    assert r.ok and r.attempts == 1


# ------------------------------------------------------------- spool
def test_spool_roundtrip_claim_order_and_jax_format(tmp_path, rng):
    root = str(tmp_path / "spool")
    y0 = rng.standard_normal(8).astype(np.float32)
    y1 = rng.standard_normal(8).astype(np.float32)
    r0 = spool.enqueue(root, "fam", y0, request_id="req0")
    # the JAX package writes the same files
    jspool.enqueue(root, "fam", y1, request_id="req1", deadline_ts=123.0)
    t = time.time()
    os.utime(os.path.join(root, "pending", "req0.a0.npz"), (t - 10, t - 10))
    assert spool.pending_count(root) == 2
    (c0,) = spool.claim(root, limit=1)
    assert c0.request_id == "req0" and c0.attempt == 0
    np.testing.assert_array_equal(c0.y, y0)
    assert spool.claimed_count(root) == 1
    x = rng.standard_normal(8).astype(np.float32)
    spool.complete(root, c0, x, iiter=7, status="converged")
    assert spool.claimed_count(root) == 0
    for reader in (spool, jspool):
        back = reader.read_result(root, r0)
        np.testing.assert_array_equal(back["x"], x)
        assert back["iiter"] == 7 and back["status"] == "converged"
    (c1,) = spool.claim(root, limit=4)
    assert c1.request_id == "req1" and c1.deadline_ts == 123.0
    spool.fail(root, c1, "boom")
    assert spool.result_ids(root) == ["req0"]
    assert "boom" in open(os.path.join(root, "failed",
                                       "req1.a0.npz.err")).read()


def test_spool_recover_is_idempotent(tmp_path, rng):
    import shutil
    root = str(tmp_path / "spool")
    y = rng.standard_normal(8).astype(np.float32)
    spool.enqueue(root, "fam", y, request_id="lost")
    spool.enqueue(root, "fam", y, request_id="banked")
    claims = {c.request_id: c for c in spool.claim(root, limit=2)}
    spool.complete(root, claims["banked"], np.zeros(8))
    assert spool.recover_claimed(root) == (1, 0)
    assert spool.recover_claimed(root) == (0, 0)
    (c2,) = spool.claim(root, limit=1)
    assert c2.request_id == "lost" and c2.attempt == 1
    spool.complete(root, c2, np.ones(8))
    # a claim whose result already landed is released, not re-enqueued
    stale = os.path.join(root, "claimed", "lost.a1.npz")
    shutil.copy(os.path.join(root, "results", "lost.npz"), stale)
    assert spool.recover_claimed(root) == (0, 0)
    assert not os.path.exists(stale) and spool.pending_count(root) == 0


def test_spool_retry_budget_quarantines(tmp_path, rng, monkeypatch):
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_RETRIES", "1")
    root = str(tmp_path / "spool")
    spool.enqueue(root, "fam", rng.standard_normal(8), request_id="killer")
    spool.claim(root, limit=1)
    assert spool.recover_claimed(root) == (1, 0)
    (c,) = spool.claim(root, limit=1)
    assert c.attempt == 1
    assert spool.recover_claimed(root) == (0, 1)
    assert spool.pending_count(root) == 0
    err = os.path.join(root, "failed", "killer.a1.npz.err")
    assert "retry budget exhausted" in open(err).read()


def test_spool_drain_marker_and_foreign_files(tmp_path, rng):
    root = str(tmp_path / "spool")
    spool.init_spool(root)
    assert not spool.drain_requested(root)
    spool.request_drain(root)
    assert spool.drain_requested(root) and jspool.drain_requested(root)
    open(os.path.join(root, "pending", "README.txt"), "w").write("x")
    open(os.path.join(root, "pending", "noattempt.npz"), "w").write("x")
    open(os.path.join(root, "pending", "torn.a0.npz"), "w").write("x")
    spool.enqueue(root, "fam", rng.standard_normal(4), request_id="ok")
    assert [c.request_id for c in spool.claim(root, limit=10)] == ["ok"]


def test_worker_main_in_a_thread(tmp_path):
    root = str(tmp_path / "spool")
    pool = WarmPool(buckets=(2,))
    spec, _, rng = family()
    pool.register(spec)
    Y = rng.standard_normal((spec.nrows, 3)).astype(np.float32)
    for j in range(3):
        spool.enqueue(root, "fam", Y[:, j], request_id=f"req{j}")
    out = []
    t = threading.Thread(target=lambda: out.append(serving.worker_main(
        root, pool, prewarm=False, window_s=0.02, idle_exit_s=0.2)))
    t.start()
    t.join(timeout=WAIT)
    assert not t.is_alive() and out == [3]
    assert spool.result_ids(root) == ["req0", "req1", "req2"]
    for j in range(3):
        res = spool.read_result(root, f"req{j}")
        rel_close(res["x"], oracle(spec, Y[:, j]), 1e-5)
    assert spool.pending_count(root) == spool.claimed_count(root) == 0
    # the drain marker ends a worker once nothing is pending
    spool.request_drain(root)
    assert serving.worker_main(root, pool, prewarm=False) == 0


# ------------------------------------------------------------ imports
def test_port_imports_no_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax\b|pylops_mpi_tpu\b(?!_torch))")
    files = sorted((ROOT / "pylops_mpi_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    bad = [f"{f.relative_to(ROOT)}:{i}" for f in files
           for i, line in enumerate(f.read_text().splitlines(), 1)
           if pat.match(line)]
    assert len(files) > 60 and bad == []
    for sub in ("serving", "diagnostics", "resilience"):
        mod = getattr(pmtt, sub)
        assert mod.__name__.startswith("pylops_mpi_tpu_torch.")
    for name in ("FamilySpec", "WarmPool", "AdmissionQueue", "Dispatcher",
                 "SolveDaemon", "worker_main", "spool"):
        assert hasattr(pmtt.serving, name)
    for name in ("trace", "metrics", "profiler"):
        assert hasattr(pmtt.diagnostics, name)
    for name in ("status", "retry", "request_drain", "drain_requested",
                 "start_heartbeat", "stop_heartbeat"):
        assert hasattr(pmtt.resilience, name)
