"""In-loop solver telemetry of the port
(``pylops_mpi_tpu_torch.diagnostics.telemetry``) held against the JAX
package's ``pylops_mpi_tpu.diagnostics.telemetry`` on the CPU.

The same f64 problems (seed 29) go through both packages' fused cg,
cgls (both schedules), block_cgls, ista, fista and the pipelined CA
engine with telemetry on; the recorded histories must hold the same
iterations with every scalar within 1e-10 of the JAX value (relative to
the largest of its series). The port's ``resid`` equals its returned
cost history bit for bit; through the graph bank (``FakeGraph``, the
CPU stand-in of tests/test_torch_aot.py) the history is bitwise the
eager run's; off, nothing is recorded.
"""

import numpy as np
import pytest
import torch

import pylops_mpi_tpu as pmt
import pylops_mpi_tpu_torch as pmtt
from pylops_mpi_tpu.diagnostics import telemetry as jtel
from pylops_mpi_tpu.ops.local import MatrixMult as JMatrixMult
from pylops_mpi_tpu.solvers import block as jblock
from pylops_mpi_tpu_torch.aot import graphs, store
from pylops_mpi_tpu_torch.diagnostics import telemetry as ttel
from pylops_mpi_tpu_torch.diagnostics import trace as ttrace

NITER = 10
_KNOBS = [f"PYLOPS_MPI_TPU{p}_{k}" for p in ("", "_TORCH")
          for k in ("TELEMETRY", "TRACE", "CA", "AOT", "GUARDS")]


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in _KNOBS:
        monkeypatch.delenv(k, raising=False)
    jtel.clear_history()
    ttel.clear_history()
    yield
    jtel.clear_history()
    ttel.clear_history()


@pytest.fixture(scope="module")
def prob():
    rng = np.random.default_rng(29)
    rect = [rng.standard_normal((12, 8)) + 3 * np.eye(12, 8)
            for _ in range(8)]
    spd = [b.T @ b + np.eye(8) for b in rect]
    return {"rect": rect, "spd": spd, "y": rng.standard_normal(96),
            "yspd": rng.standard_normal(64),
            "Y": rng.standard_normal((96, 3))}


def _ops(blocks):
    return (pmt.MPIBlockDiag([JMatrixMult(b) for b in blocks]),
            pmtt.convert.blockdiag_from_numpy(blocks, device="cpu"))


def _run(name, prob, pkg):
    jax_side = pkg is pmt
    if name in ("cg", "pipelined_cg"):
        jop, top = _ops(prob["spd"])
        op = jop if jax_side else top
        y = (pmt.DistributedArray.to_dist(prob["yspd"]) if jax_side else
             pmtt.DistributedArray.to_dist(prob["yspd"], device="cpu"))
        out = pkg.cg(op, y, niter=NITER, tol=0.0)
        return "cg", out[2]
    jop, top = _ops(prob["rect"])
    op = jop if jax_side else top
    if name == "block_cgls":
        Y = (pmt.DistributedArray.to_dist(prob["Y"]) if jax_side else
             pmtt.DistributedArray.to_dist(prob["Y"], device="cpu"))
        fn = jblock.block_cgls if jax_side else pmtt.block_cgls
        out = fn(op, Y, niter=NITER, damp=0.1, tol=0.0)
        return "block_cgls", out[5]
    y = (pmt.DistributedArray.to_dist(prob["y"]) if jax_side else
         pmtt.DistributedArray.to_dist(prob["y"], device="cpu"))
    if name in ("cgls_classic", "cgls_normal"):
        out = pkg.cgls(op, y, niter=NITER, damp=0.2, tol=0.0,
                       normal=name == "cgls_normal")
        return "cgls", out[5]
    x0 = (pmt.DistributedArray.to_dist(np.zeros(64)) if jax_side else
          pmtt.DistributedArray.to_dist(np.zeros(64), device="cpu"))
    out = getattr(pkg, name)(op, y, x0=x0, niter=NITER, eps=0.05, tol=0.0)
    return name, out[2]


CASES = ["cg", "cgls_classic", "cgls_normal", "block_cgls", "ista",
         "fista", "pipelined_cg"]


@pytest.mark.parametrize("name", CASES)
def test_history_equals_jax(monkeypatch, prob, name):
    monkeypatch.setenv("PYLOPS_MPI_TPU_TELEMETRY", "on")
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_TELEMETRY", "on")
    if name.startswith("pipelined"):
        monkeypatch.setenv("PYLOPS_MPI_TPU_CA", "pipelined")
        monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_CA", "pipelined")
    solver, _ = _run(name, prob, pmt)
    want = jtel.history(solver)
    _, cost = _run(name, prob, pmtt)
    got = ttel.history(solver)
    assert len(want) == NITER and [s["iiter"] for s in got] == \
        [s["iiter"] for s in want]
    assert set(got[0]) == set(want[0])
    for key in want[0]:
        if key == "iiter":
            continue
        w = np.asarray([s[key] for s in want], dtype=float)
        g = np.asarray([s[key] for s in got], dtype=float)
        np.testing.assert_allclose(g, w, rtol=1e-10,
                                   atol=1e-10 * np.abs(w).max())
    if "resid" in got[0] and name != "block_cgls":
        # the value the solve returns in its cost history, bit for bit
        c = np.asarray(cost)[1:NITER + 1]
        assert np.array_equal(np.asarray([s["resid"] for s in got]), c)


def test_off_records_nothing_and_auto_follows_trace(monkeypatch, prob):
    pmtt.cg(*_args(prob), niter=4, tol=0.0)
    assert ttel.history() == {}
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_TRACE", "full")
    assert ttel.telemetry_enabled()
    ttrace.clear_events()
    pmtt.cg(*_args(prob), niter=4, tol=0.0)
    assert [s["iiter"] for s in ttel.history("cg")] == [1, 2, 3, 4]
    ev = ttrace.get_events()
    spans = [e for e in ev if e["name"] == "solver.cg" and e["ph"] == "X"]
    assert spans and spans[0]["args"]["telemetry"] is True
    counters = [e for e in ev if e["name"] == "solver.cg"
                and e["ph"] == "C"]
    assert [c["args"]["iiter"] for c in counters] == [1, 2, 3, 4]
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_TRACE", "spans")
    assert not ttel.telemetry_enabled()
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_TELEMETRY", "off")
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_TRACE", "full")
    assert not ttel.telemetry_enabled()


def _args(prob):
    _, top = _ops(prob["spd"])
    return top, pmtt.DistributedArray.to_dist(prob["yspd"], device="cpu")


class _FakeGraph:
    """``graphs._CudaGraph`` on the CPU (tests/test_torch_aot.py)."""

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


def test_banked_history_bitwise_eager(monkeypatch, prob):
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_TELEMETRY", "on")
    top, y = _ops(prob["rect"])[1], pmtt.DistributedArray.to_dist(
        prob["y"], device="cpu")
    eager = pmtt.cgls(top, y, niter=30, tol=0.0, normal=True)
    h_eager = ttel.history("cgls")
    ttel.clear_history()
    monkeypatch.setattr(graphs, "_CudaGraph", _FakeGraph)
    monkeypatch.setattr(graphs, "_ineligible", lambda tensors: None)
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_AOT", "on")
    store.clear_memory()
    graphs.reset_capture_count()
    try:
        for run in range(2):
            banked = pmtt.cgls(top, y, niter=30, tol=0.0, normal=True)
            assert torch.equal(banked[0].array, eager[0].array)
            assert ttel.history("cgls") == h_eager
            ttel.clear_history()
        assert graphs.stats()["captures"] == 1
        assert graphs.stats()["replays"] >= 4
        # telemetry joins the key: with it off the bank captures anew
        monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_TELEMETRY", "off")
        pmtt.cgls(top, y, niter=30, tol=0.0, normal=True)
        assert graphs.stats()["captures"] == 2 and ttel.history() == {}
    finally:
        store.clear_memory()
    assert len(h_eager) == 30
