"""The bank of captured solver loops (``pylops_mpi_tpu_torch.aot``).

- The rewritten loops (setup, a step over a carry of device tensors, a
  host check every 8 iterations) held against the JAX package's fused
  solvers at niter 1, 8 and 13 in f64 (rtol 1e-10 relative to the
  largest entry; ``iiter`` and the lengths of the cost arrays equal).
- The bank driven on the CPU with ``FakeGraph``, a stand-in for the CUDA
  capture that lives in this file only: a capture runs the segment's
  Python once and leaves the buffers as they were, a replay computes
  with the Python counters held still. Every solver's result through the
  bank equals the eager loop's bit for bit, with the same launch and
  path counts, and a second solve captures nothing.
- The key, the eligibility (CPU tensors run eagerly with reason
  ``cpu``), ``aot_mode`` against the JAX package's, and the serving
  pool's prewarm of banked buckets.
- On the card (``cuda``, skipped here): the real graphs against the
  eager loops, bitwise, and a write in place seen by the next replay.
"""

import warnings

import numpy as np
import pytest
import torch

import pylops_mpi_tpu as pmt
import pylops_mpi_tpu_torch as pmtt
from pylops_mpi_tpu.aot import store as jstore
from pylops_mpi_tpu.ops import precond as jpc
from pylops_mpi_tpu.ops.local import MatrixMult as JM
from pylops_mpi_tpu_torch.aot import graphs, store
from pylops_mpi_tpu_torch.diagnostics import metrics
from pylops_mpi_tpu_torch.ops import derivatives, normal_kernels
from pylops_mpi_tpu_torch.ops import precond as tpc
from pylops_mpi_tpu_torch.serving import engine

KNOBS = ("PYLOPS_MPI_TPU_TORCH_AOT", "PYLOPS_MPI_TPU_TORCH_CA",
         "PYLOPS_MPI_TPU_TORCH_CA_S", "PYLOPS_MPI_TPU_TORCH_GUARDS",
         "PYLOPS_MPI_TPU_TORCH_METRICS", "PYLOPS_MPI_TPU_TORCH_PRECISION",
         "PYLOPS_MPI_TPU_AOT", "PYLOPS_MPI_TPU_AOT_CACHE")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)

    def reset():
        store.clear_memory()
        graphs.reset_capture_count()
        engine.clear_warmed_signatures()
        metrics.clear_metrics()
    reset()
    yield
    reset()


class FakeGraph:
    """The CPU stand-in for ``graphs._CudaGraph``: the capture runs the
    segment once for its Python side effects and restores the buffers
    (a capture computes nothing); a replay computes it with the Python
    counters held still (a replay runs no Python)."""

    def __init__(self, body, device, buffers):
        saved = [b.clone() for b in buffers]
        body()
        for b, v in zip(buffers, saved):
            b.copy_(v)
        self.body = body

    def replay(self):
        snap = graphs._counters()
        self.body()
        graphs._add(graphs._delta(snap, graphs._counters()), -1)


@pytest.fixture
def fake_bank(monkeypatch):
    """The tier armed on the CPU, through :class:`FakeGraph`."""
    monkeypatch.setattr(graphs, "_CudaGraph", FakeGraph)
    monkeypatch.setattr(graphs, "_ineligible", lambda tensors: None)
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_AOT", "on")


@pytest.fixture
def counted(monkeypatch):
    """The CPU's plain normal product counted as the card's kernel
    launch is."""
    plain = normal_kernels.normal_matvec

    def launch(A, X):
        normal_kernels.launches += 1
        return plain(A, X)
    monkeypatch.setattr(normal_kernels, "normal_matvec", launch)


# ------------------------------------------------------------ problems
def spd(rng, nblk=4, n=6):
    out = []
    for _ in range(nblk):
        m = rng.standard_normal((n, n))
        out.append(np.eye(n) * 4 + 0.3 * (m + m.T))
    return out


def rect(rng, nblk=4, m=8, n=6):
    return [rng.standard_normal((m, n)) / np.sqrt(n) + 2 * np.eye(m, n)
            for _ in range(nblk)]


def tbd(blocks):
    return pmtt.convert.blockdiag_from_numpy(blocks, device="cpu")


def jbd(blocks):
    return pmt.MPIBlockDiag([JM(b) for b in blocks])


def tvec(v):
    return pmtt.DistributedArray.to_dist(np.asarray(v), device="cpu")


def jvec(v):
    return pmt.DistributedArray.to_dist(np.asarray(v))


def close(got, want, rtol=1e-10):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.max(np.abs(want)), 1e-300))


# ---------------------------------------------- the rewrite against JAX
REWRITE = ["cg", "cgls_classic", "cgls_normal_damped", "cgls_jacobi",
           "block_cgls", "ista_decay", "fista_decay", "power_iteration"]


def _rewrite_case(case, rng, niter):
    """The same problem through the JAX package and the port:
    ``(jax outputs, port outputs)`` as lists of numbers and arrays."""
    if case == "cg":
        b = spd(rng)
        y = rng.standard_normal(24)
        j = pmt.cg(jbd(b), jvec(y), niter=niter, tol=0.0)
        t = pmtt.cg(tbd(b), tvec(y), niter=niter, tol=0.0)
        return ([j[0].asarray(), j[1], np.asarray(j[2])],
                [t[0].asarray(), t[1], t[2].numpy()])
    if case.startswith("cgls"):
        b = rect(rng)
        y = rng.standard_normal(32)
        normal = case == "cgls_normal_damped"
        damp = {"cgls_classic": 0.0, "cgls_normal_damped": 0.3,
                "cgls_jacobi": 0.2}[case]
        jop, top = jbd(b), tbd(b)
        jM = tM = None
        if case == "cgls_jacobi":
            # diag(OpᴴOp + damp²I): the column norms of the blocks
            jM = jpc.JacobiPrecond(np.concatenate(
                [np.sum(m * m, axis=0) for m in b]) + damp ** 2)
            tM = pmtt.convert.jacobi_from_numpy(np.asarray(jM._dinv),
                                                device="cpu")
        j = pmt.cgls(jop, jvec(y), niter=niter, damp=damp, tol=0.0,
                     normal=normal, M=jM)
        t = pmtt.cgls(top, tvec(y), niter=niter, damp=damp, tol=0.0,
                      normal=normal, M=tM)
        return ([j[0].asarray(), j[1], j[2], np.asarray(j[4]),
                 np.asarray(j[5])],
                [t[0].asarray(), t[1], t[2], t[4].numpy(), t[5].numpy()])
    if case == "block_cgls":
        b = rect(rng)
        Y = rng.standard_normal((32, 3))
        jy = pmt.DistributedArray.to_dist(Y)
        ty = pmtt.DistributedArray.to_dist(Y, device="cpu")
        from pylops_mpi_tpu.solvers import block as jblock
        j = jblock.block_cgls(jbd(b), jy, niter=niter, damp=0.1, tol=0.0)
        t = pmtt.solvers.block.block_cgls(tbd(b), ty, niter=niter, damp=0.1,
                                          tol=0.0)
        return ([j[0].asarray(), j[2], np.asarray(j[4]), np.asarray(j[5])],
                [t[0].asarray(), t[2], t[4].numpy(), t[5].numpy()])
    if case in ("ista_decay", "fista_decay"):
        b = rect(rng)
        y = rng.standard_normal(32)
        kw = dict(niter=niter, eps=0.05, tol=0.0,
                  decay=np.linspace(2.0, 0.5, niter))
        fn = case.split("_")[0]
        j = getattr(pmt, fn)(jbd(b), jvec(y), jvec(np.zeros(24)), **kw)
        t = getattr(pmtt, fn)(tbd(b), tvec(y), tvec(np.zeros(24)), **kw)
        return ([j[0].asarray(), j[1], np.asarray(j[2])],
                [t[0].asarray(), t[1], t[2].numpy()])
    b = spd(rng)
    j = pmt.power_iteration(jbd(b), jvec(np.zeros(24)), niter=niter,
                            tol=1e-30)
    t = pmtt.power_iteration(tbd(b), tvec(np.zeros(24)), niter=niter,
                             tol=1e-30)
    return ([j[0], j[1].asarray(), j[2]], [t[0], t[1].asarray(), t[2]])


@pytest.mark.parametrize("niter", [1, 8, 13])
@pytest.mark.parametrize("case", REWRITE)
def test_rewritten_loops_match_jax(case, niter):
    want, got = _rewrite_case(case, np.random.default_rng(7), niter)
    for w, g in zip(want, got):
        if isinstance(w, (int, np.integer)):
            assert int(g) == int(w)
        else:
            close(g, w)


# ------------------------------------------------- the bank on the CPU
def _gradient_cgls(rng, niter):
    """CGLS through a derivative operator: its applies move
    ``derivatives.paths``."""
    Op = pmtt.MPIFirstDerivative((20, 3), dtype=torch.float64)
    y = tvec(rng.standard_normal(60))
    return pmtt.cgls(Op, y, niter=niter, damp=0.1, tol=0.0)


BANK = {  # name: (solve(rng, niter), env)
    "cg": (lambda r, n: pmtt.cg(tbd(spd(r)), tvec(r.standard_normal(24)),
                                niter=n, tol=0.0), {}),
    "cg_guarded_jacobi": (lambda r, n: pmtt.cg_guarded(
        tbd(spd(r)), tvec(r.standard_normal(24)), niter=n, tol=0.0,
        M=tpc.JacobiPrecond.from_operator(tbd(spd(r)))), {}),
    "cgls_normal": (lambda r, n: pmtt.cgls(
        tbd(rect(r)), tvec(r.standard_normal(32)), niter=n, damp=0.3,
        tol=0.0, normal=True), {}),
    "cgls_classic_guards": (lambda r, n: pmtt.cgls(
        tbd(rect(r)), tvec(r.standard_normal(32)), niter=n, damp=0.2,
        tol=0.0, guards=True), {}),
    "block_cgls": (lambda r, n: pmtt.solvers.block.block_cgls(
        tbd(rect(r)), pmtt.DistributedArray.to_dist(
            r.standard_normal((32, 3)), device="cpu"),
        niter=n, damp=0.1, tol=0.0), {}),
    "block_cg_guards": (lambda r, n: pmtt.solvers.block.block_cg(
        tbd(spd(r)), pmtt.DistributedArray.to_dist(
            r.standard_normal((24, 3)), device="cpu"),
        niter=n, tol=0.0, guards=True), {}),
    "fista": (lambda r, n: pmtt.fista(
        tbd(rect(r)), tvec(r.standard_normal(32)), tvec(np.zeros(24)),
        niter=n, eps=0.05, alpha=0.1, tol=0.0,
        decay=np.linspace(2.0, 0.5, n)), {}),
    "ista_half": (lambda r, n: pmtt.ista(
        tbd(rect(r)), tvec(r.standard_normal(32)), tvec(np.zeros(24)),
        niter=n, eps=0.05, alpha=0.1, tol=0.0, threshkind="half"), {}),
    "power_iteration": (lambda r, n: pmtt.power_iteration(
        tbd(spd(r)), tvec(np.zeros(24)), niter=n, tol=1e-30), {}),
    "pipelined_cgls_normal": (lambda r, n: pmtt.cgls(
        tbd(rect(r)), tvec(r.standard_normal(32)), niter=n, damp=0.1,
        tol=0.0, normal=True), {"PYLOPS_MPI_TPU_TORCH_CA": "pipelined"}),
    "sstep_cg": (lambda r, n: pmtt.cg(
        tbd(spd(r)), tvec(r.standard_normal(24)), niter=n, tol=0.0),
        {"PYLOPS_MPI_TPU_TORCH_CA": "sstep",
         "PYLOPS_MPI_TPU_TORCH_CA_S": "2"}),
    "gradient_cgls": (_gradient_cgls, {}),
}


def _flat(out):
    res = []
    for v in out if isinstance(out, tuple) else (out,):
        if isinstance(v, (pmtt.DistributedArray,)):
            res.append(v.array)
        elif isinstance(v, torch.Tensor):
            res.append(v)
        elif isinstance(v, list):
            res.extend(v)
        else:
            res.append(v)
    return res


def _counts():
    return (normal_kernels.launches, dict(derivatives.paths))


def _solve_counted(name, niter):
    normal_kernels.reset_launches()
    derivatives.paths.clear()
    out = BANK[name][0](np.random.default_rng(3), niter)
    return _flat(out), _counts()


def _same(a, b):
    assert len(a) == len(b)
    for u, v in zip(a, b):
        if isinstance(u, torch.Tensor):
            assert u.dtype == v.dtype and torch.equal(u, v)
        else:
            assert u == v


@pytest.mark.parametrize("name", sorted(BANK))
def test_bank_equals_eager_bitwise_with_counts(name, monkeypatch, counted):
    for k, v in BANK[name][1].items():
        monkeypatch.setenv(k, v)
    niter = 29  # an eager first segment, two replays, a tail of 5
    eager, eager_counts = _solve_counted(name, niter)
    monkeypatch.setattr(graphs, "_CudaGraph", FakeGraph)
    monkeypatch.setattr(graphs, "_ineligible", lambda tensors: None)
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_AOT", "on")
    banked, banked_counts = _solve_counted(name, niter)
    _same(banked, eager)
    assert banked_counts == eager_counts
    st = graphs.stats()
    assert graphs.capture_count() == 1 and st["replays"] >= 1, st
    assert "eager" not in st


def test_second_solve_on_a_banked_key_replays_only(fake_bank, counted):
    rng = np.random.default_rng(0)
    op = tbd(rect(rng))
    y = tvec(rng.standard_normal(32))
    outs = []
    for _ in range(2):
        normal_kernels.reset_launches()
        outs.append(_flat(pmtt.cgls(op, y, niter=29, damp=0.3, tol=0.0,
                                    normal=True)) + [normal_kernels.launches])
    _same(outs[1], outs[0])
    assert outs[0][-1] == 29  # one launch an iteration, replays included
    st = graphs.stats()
    # first solve: eager [0, 8), capture, replays [8, 16) [16, 24);
    # second: a hit, replays [0, 8) .. [16, 24); each tail of 5 eager
    assert (st["captures"], st["hits"], st["replays"]) == (1, 1, 5)
    assert len(store.mem_entries()) == 1


def test_early_exit_falls_where_the_eager_loop_exits(monkeypatch):
    rng = np.random.default_rng(1)
    op, y = tbd(spd(rng)), tvec(rng.standard_normal(24))
    want = pmtt.cg(op, y, niter=100, tol=1e-20)
    assert 8 < want[1] < 100
    monkeypatch.setattr(graphs, "_CudaGraph", FakeGraph)
    monkeypatch.setattr(graphs, "_ineligible", lambda tensors: None)
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_AOT", "on")
    for _ in range(2):
        got = pmtt.cg(op, y, niter=100, tol=1e-20)
        _same(_flat(got), _flat(want))


def test_bookkeeping_metrics_and_stats(fake_bank, monkeypatch, counted):
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_METRICS", "on")
    rng = np.random.default_rng(2)
    op, y = tbd(rect(rng)), tvec(rng.standard_normal(32))
    pmtt.cgls(op, y, niter=20, tol=0.0, normal=True)   # capture
    pmtt.cgls(op, y, niter=20, tol=0.0, normal=True)   # hit
    pmtt.cgls(op, y, niter=12, tol=0.0, normal=True)   # a new key: short
    c = metrics.snapshot()["counters"]
    assert c["aot.graph.captures"] == 1 and c["aot.graph.hits"] == 1
    assert c["aot.graph.replays"] == 1 + 2
    assert c["aot.graph.eager"] == 1 and c["aot.graph.eager.short"] == 1
    assert metrics.snapshot()["gauges"]["aot.graph.bank_bytes"] > 0
    assert graphs.bank_bytes() == metrics.snapshot()["gauges"][
        "aot.graph.bank_bytes"]


def test_a_failed_capture_raises(fake_bank, monkeypatch):
    class Broken:
        def __init__(self, body, device, buffers):
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
    monkeypatch.setattr(graphs, "_CudaGraph", Broken)
    rng = np.random.default_rng(2)
    op, y = tbd(rect(rng)), tvec(rng.standard_normal(32))
    normal_kernels.reset_launches()
    with pytest.raises(RuntimeError, match="capturing"):
        pmtt.cgls(op, y, niter=20, tol=0.0)
    assert graphs.capture_count() == 0 and not store.mem_entries()


def test_bank_evicts_the_least_recently_used_unlocked_entry(fake_bank,
                                                            monkeypatch):
    monkeypatch.setattr(store, "_MEM_MAX", 2)
    rng = np.random.default_rng(12)
    y = tvec(rng.standard_normal(32))
    ops = [tbd(rect(rng)) for _ in range(3)]
    for op in ops:
        pmtt.cgls(op, y, niter=20, tol=0.0)
    assert graphs.capture_count() == 3 and len(store.mem_entries()) == 2
    assert {id(e.keepalive[0]) for e in store.mem_entries()} == {
        id(ops[1]), id(ops[2])}
    pmtt.cgls(ops[1], y, niter=20, tol=0.0)  # a hit: now the most recent
    pmtt.cgls(ops[0], y, niter=20, tol=0.0)  # captured again, evicts ops[2]
    assert graphs.capture_count() == 4 and graphs.stats()["hits"] == 1
    assert {id(e.keepalive[0]) for e in store.mem_entries()} == {
        id(ops[0]), id(ops[1])}
    # an entry a solve holds is never evicted
    held = store.mem_entries()[0]
    held.lock.acquire()
    try:
        pmtt.cgls(ops[2], y, niter=20, tol=0.0)
        assert held in store.mem_entries() and len(store.mem_entries()) == 2
    finally:
        held.lock.release()


# ------------------------------------------------------------- the key
def _tensors_of(op):
    from pylops_mpi_tpu_torch.aot.signature import _tensors
    out = []
    _tensors(op, out, set(), lambda t: t)
    assert out
    return out


def _key(op, y, damp=0.0, tol=0.0, M=None):
    carry = [y.array, torch.zeros(3, dtype=torch.float64)]
    return graphs.key("cgls", dict(damp=damp, tol=tol), op, M, y, carry)


def test_key_storage_scalars_and_knobs(monkeypatch):
    rng = np.random.default_rng(4)
    blocks = rect(rng)
    y = tvec(rng.standard_normal(32))
    a, b = tbd(blocks), tbd(blocks)
    assert pmtt.aot.op_signature(a) == pmtt.aot.op_signature(b)
    assert _key(a, y) == _key(a, y)
    assert _key(a, y) != _key(b, y)  # same structure, other tensors
    assert _key(a, y, damp=0.1) != _key(a, y)
    assert _key(a, y, tol=1e-3) != _key(a, y)
    M = tpc.JacobiPrecond.from_operator(a)
    assert _key(a, y, M=M) != _key(a, y)
    k = _key(a, y)
    for t in _tensors_of(a):
        t.mul_(2.0)  # a write in place keeps the addresses
    assert _key(a, y) == k
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_PRECISION", "bf16")
    assert _key(a, y) != k


def test_key_through_solves(fake_bank):
    rng = np.random.default_rng(5)
    blocks = rect(rng)
    op, y = tbd(blocks), tvec(rng.standard_normal(32))
    pmtt.cgls(op, y, niter=20, damp=0.1, tol=0.0)
    pmtt.cgls(op, y, niter=20, damp=0.1, tol=0.0)
    assert graphs.capture_count() == 1
    pmtt.cgls(op, y, niter=20, damp=0.2, tol=0.0)
    assert graphs.capture_count() == 2
    pmtt.cgls(tbd(blocks), y, niter=20, damp=0.1, tol=0.0)
    assert graphs.capture_count() == 3
    # an entry keeps its operator alive
    assert all(e.keepalive[0] is not None for e in store.mem_entries())


@pytest.mark.parametrize("kw", [dict(sampling=2.5), dict(kind="forward"),
                                dict(edge=True)])
def test_operators_differing_in_a_scalar_never_share_a_graph(kw,
                                                             monkeypatch):
    """Two derivative operators that hold no tensors and differ only in a
    Python scalar the captured program bakes in: each solve through the
    bank equals its own eager solve."""
    y = tvec(np.random.default_rng(11).standard_normal(60))

    def solves():
        return [_flat(pmtt.cgls(pmtt.MPIFirstDerivative(
            (20, 3), dtype=torch.float64, **k), y, niter=20, damp=0.1,
            tol=0.0)) for k in ({}, kw)]
    eager = solves()
    monkeypatch.setattr(graphs, "_CudaGraph", FakeGraph)
    monkeypatch.setattr(graphs, "_ineligible", lambda tensors: None)
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_AOT", "on")
    banked = solves()
    assert graphs.capture_count() == 2
    for got, want in zip(banked, eager):
        _same(got, want)


# ------------------------------------------------------- eligibility
@pytest.mark.parametrize("solver", ["cgls", "block_cg", "fista"])
def test_cpu_tensors_run_eagerly_with_reason(solver, monkeypatch):
    name = {"cgls": "cgls_normal", "block_cg": "block_cg_guards",
            "fista": "fista"}[solver]
    off, _ = _solve_counted(name, 20)
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_AOT", "on")
    on, _ = _solve_counted(name, 20)
    _same(on, off)
    assert graphs.capture_count() == 0
    assert graphs.stats() == {"eager": 1, "eager.cpu": 1}


def test_knob_off_never_touches_the_bank(monkeypatch):
    _solve_counted("cg", 20)
    assert graphs.stats() == {} and not store.mem_entries()


# ------------------------------------------------------------ aot_mode
@pytest.mark.parametrize("raw", ["", "on", "1", "off", "0", "none", "auto",
                                 " ON "])
def test_aot_mode_matches_jax(raw, monkeypatch):
    for name in ("PYLOPS_MPI_TPU_AOT", "PYLOPS_MPI_TPU_TORCH_AOT"):
        monkeypatch.setenv(name, raw)
    assert store.aot_mode() == jstore.aot_mode()
    # auto arms the JAX package only with a disk bank, which the port
    # does not have
    assert store.aot_enabled() == jstore.aot_enabled() == (
        store.aot_mode() == "on")


def test_aot_mode_warns_once_like_jax(monkeypatch):
    msgs = []
    for mod, name in ((jstore, "PYLOPS_MPI_TPU_AOT"),
                      (store, "PYLOPS_MPI_TPU_TORCH_AOT")):
        monkeypatch.setattr(mod, "_warned_mode", False)
        monkeypatch.setenv(name, "sideways")
        with pytest.warns(UserWarning) as rec:
            assert mod.aot_mode() == "off"
        msgs.append(str(rec[0].message).replace(name, "KNOB"))
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert mod.aot_mode() == "off"  # once only
    assert msgs[0] == msgs[1]


# ------------------------------------------------------------ prewarm
def _family(niter=20):
    rng = np.random.default_rng(6)
    op = tbd(rect(rng))
    return engine.FamilySpec(name="fam", operator=op, solver="cgls",
                             niter=niter, dtype=torch.float64)


def test_prewarm_captures_and_skips_banked_buckets(fake_bank, monkeypatch):
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_METRICS", "on")
    spec = _family()
    pool = engine.WarmPool(buckets=(1, 4))
    pool.register(spec)
    assert pool.prewarm() == {"fam": [1, 4]}
    assert graphs.capture_count() == 2  # the zero-RHS solves captured
    assert {b for _, b in engine._WARMED_SIGS} == {1, 4}
    # a fresh pool on the same operator: both buckets banked, skipped
    pool2 = engine.WarmPool(buckets=(1, 4))
    pool2.register(spec)
    assert pool2.prewarm() == {"fam": [1, 4]}
    assert pool2.prewarm_s == {}
    assert metrics.snapshot()["counters"]["serve.pool.prewarm_skipped"] == 2
    # the first request replays the banked loop and equals block_cgls
    Y = np.random.default_rng(8).standard_normal((32, 3))
    out = pool2.solve("fam", Y)
    assert graphs.capture_count() == 2 and graphs.stats()["hits"] == 1
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_AOT", "off")
    Yp = np.concatenate([Y, np.zeros((32, 1))], axis=1)
    want = pmtt.solvers.block.block_cgls(
        spec.operator, pmtt.DistributedArray.to_dist(Yp, device="cpu"),
        niter=20, tol=0.0)[0].asarray()[:, :3]
    np.testing.assert_array_equal(out.x, want)
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_AOT", "on")
    # clearing the ledger makes prewarm solve again (the bank still hits)
    engine.clear_warmed_signatures()
    pool3 = engine.WarmPool(buckets=(1, 4))
    pool3.register(spec)
    assert pool3.prewarm() == {"fam": [1, 4]}
    assert set(pool3.prewarm_s) == {("fam", 1), ("fam", 4)}
    assert graphs.capture_count() == 2


def test_prewarm_solves_again_once_the_bank_lost_its_loop(fake_bank):
    spec = _family()
    pool = engine.WarmPool(buckets=(4,))
    pool.register(spec)
    pool.prewarm()
    assert graphs.capture_count() == 1
    pmtt.aot.clear_memory()  # the ledger stays, the graphs are gone
    pool2 = engine.WarmPool(buckets=(4,))
    pool2.register(spec)
    assert pool2.prewarm() == {"fam": [4]}
    assert ("fam", 4) in pool2.prewarm_s and graphs.capture_count() == 2


def test_prewarm_of_a_fresh_operator_instance_captures_again(fake_bank):
    pool = engine.WarmPool(buckets=(4,))
    pool.register(_family())
    pool.prewarm()
    pool2 = engine.WarmPool(buckets=(4,))
    spec2 = _family()  # the same structure, a new instance
    pool2.register(spec2)
    assert spec2.signature() == pool.family("fam").signature()
    assert pool2.prewarm() == {"fam": [4]}
    assert graphs.capture_count() == 2 and ("fam", 4) in pool2.prewarm_s


# ------------------------------------------------------------ on the card
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card, not here)")


def _cuda_problem(rng, nblk=4, m=40, n=32):
    blocks = [rng.standard_normal((m, n)) / np.sqrt(n) + 2 * np.eye(m, n)
              for _ in range(nblk)]
    op = pmtt.convert.blockdiag_from_numpy(
        [b.astype(np.float32) for b in blocks], device="cuda")
    y = pmtt.DistributedArray.to_dist(
        rng.standard_normal(nblk * m).astype(np.float32), device="cuda")
    return op, y


@pytest.mark.cuda
@pytest.mark.parametrize("normal", [True, False])
def test_cuda_graphs_equal_eager_bitwise(normal, monkeypatch):
    _need_cuda()
    op, y = _cuda_problem(np.random.default_rng(9))
    outs = []
    for knob in ("off", "on", "on"):
        monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_AOT", knob)
        normal_kernels.reset_launches()
        x, istop, iiter, r1, r2, cost = pmtt.cgls(op, y, niter=50, tol=0.0,
                                                  normal=normal)
        outs.append((x.array.cpu(), iiter, cost.cpu(), r2.cpu(),
                     normal_kernels.launches))
    for o in outs[1:]:
        assert torch.equal(o[0], outs[0][0]) and o[1] == outs[0][1]
        assert torch.equal(o[2], outs[0][2]) and torch.equal(o[3], outs[0][3])
        assert o[4] == outs[0][4]
    assert graphs.capture_count() == 1 and graphs.stats()["hits"] == 1


@pytest.mark.cuda
def test_cuda_replay_sees_a_write_in_place(monkeypatch):
    _need_cuda()
    op, y = _cuda_problem(np.random.default_rng(10))
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_AOT", "on")
    pmtt.cgls(op, y, niter=24, tol=0.0, normal=True)
    for t in _tensors_of(op):
        t.mul_(1.5)
    got = pmtt.cgls(op, y, niter=24, tol=0.0, normal=True)[0].array
    assert graphs.capture_count() == 1
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_AOT", "off")
    want = pmtt.cgls(op, y, niter=24, tol=0.0, normal=True)[0].array
    assert torch.equal(got, want)


def test_gloo_group_is_ineligible(tmp_path):
    import types
    import torch.distributed as dist
    on_card = [types.SimpleNamespace(is_cuda=True)]
    assert graphs._ineligible(on_card) is None
    assert graphs._ineligible([torch.zeros(2)]) == "cpu"
    pmtt.parallel.init(backend="gloo", world_size=1, rank=0, device="cpu",
                       store=dist.FileStore(str(tmp_path / "store"), 1))
    try:
        assert graphs._ineligible(on_card) == "gloo"
        assert graphs._group() == (1, "gloo")
    finally:
        pmtt.parallel.destroy()
