"""The port's solver guards held against the JAX package: the status
word of ``cg_guarded``/``cgls_guarded`` (classic and ``normal=True``) on
healthy, NaN-at-an-iteration and stagnating problems, the per-column
verdicts of ``block_cg``/``block_cgls`` with a poisoned column, the
guard knob, and the repaired unguarded loops: a non-finite ``y``
(or operator) returns what the JAX package's ``while_loop`` returns.

The JAX package injects its NaN with ``resilience.faults.arm("nan", j)``
(the operator apply of iteration ``j`` multiplied by NaN); the port is
given the same poison by an operator wrapper that multiplies the same
apply by NaN. Stagnation is natural: ill-conditioned blocks whose
residual does not improve for ``GUARD_STALL`` iterations.

Tolerance: x within 1e-12 relative to its largest entry (f64); status
codes and iteration counts equal; the repaired loops' x and ``iiter``
equal (``assert_array_equal``, NaN where NaN).
"""

import os

import numpy as np
import pytest
import torch

import pylops_mpi_tpu as pmt
import pylops_mpi_tpu_torch as pmtt
from pylops_mpi_tpu.ops.local import MatrixMult as JM
from pylops_mpi_tpu.resilience import faults
from pylops_mpi_tpu.resilience import status as jstatus
from pylops_mpi_tpu.solvers import block as jblock
from pylops_mpi_tpu.solvers.basic import cg_guarded as jcg_guarded
from pylops_mpi_tpu.solvers.basic import cgls_guarded as jcgls_guarded
from pylops_mpi_tpu_torch.resilience import status as tstatus

RTOL = 1e-12
_KNOBS = ("PYLOPS_MPI_TPU_GUARDS", "PYLOPS_MPI_TPU_GUARD_STALL",
          "PYLOPS_MPI_TPU_TORCH_GUARDS", "PYLOPS_MPI_TPU_TORCH_GUARD_STALL",
          "PYLOPS_MPI_TPU_CA", "PYLOPS_MPI_TPU_TORCH_CA")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in _KNOBS:
        monkeypatch.delenv(k, raising=False)
    faults.disarm()
    jstatus.clear_statuses()
    tstatus.clear_statuses()
    yield
    faults.disarm()
    pmt.clear_fused_cache()


def close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.max(np.abs(want)))


def spd_blocks(seed, nblk=4, n=12, cond=None):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(nblk):
        if cond is None:
            a = rng.standard_normal((n, n))
            out.append(a @ a.T + n * np.eye(n))
        else:
            q, _ = np.linalg.qr(rng.standard_normal((n, n)))
            out.append(q @ np.diag(np.logspace(0, np.log10(cond), n)) @ q.T)
    return out, rng


def rect_blocks(seed, nblk=4, m=14, n=12, spread=None):
    rng = np.random.default_rng(seed)
    if spread is None:
        return [rng.standard_normal((m, n)) / 3 + 2 * np.eye(m, n)
                for _ in range(nblk)], rng
    return [rng.standard_normal((m, n)) @ np.diag(np.logspace(0, spread, n))
            for _ in range(nblk)], rng


def pair(blocks):
    return (pmt.MPIBlockDiag([JM(b) for b in blocks]),
            pmtt.convert.blockdiag_from_numpy(blocks, device="cpu"))


def vecs(v):
    if np.ndim(v) == 2:
        j = pmt.DistributedArray(global_shape=v.shape)
        j[:] = v
    else:
        j = pmt.DistributedArray.to_dist(v)
    return j, pmtt.DistributedArray.to_dist(v, device="cpu")


class Poisoned:
    """A port operator whose ``which`` apply number ``at`` (0-based)
    returns NaN everywhere, as the JAX package's ``inject_nan``."""

    def __init__(self, op, which, at):
        self._op, self._which, self._at, self._n = op, which, at, 0

    def __getattr__(self, name):
        return getattr(self._op, name)

    def _count(self, out):
        hit = self._n == self._at
        self._n += 1
        if not hit:
            return out
        if isinstance(out, tuple):
            return tuple(o * float("nan") for o in out)
        return out * float("nan")

    def matvec(self, x):
        out = self._op.matvec(x)
        return self._count(out) if self._which == "matvec" else out

    def normal_matvec(self, x):
        out = self._op.normal_matvec(x)
        return self._count(out) if self._which == "normal" else out


# ------------------------------------------------------ single RHS
def _run(kind, J, T, yj, yt, niter, tol):
    if kind == "cg":
        jo = jcg_guarded(J, yj, niter=niter, tol=tol)
        to = pmtt.cg_guarded(T, yt, niter=niter, tol=tol)
        return (jo[0], jo[1], jo[3]), (to[0], to[1], to[3])
    normal = kind == "cgls_normal"
    jo = jcgls_guarded(J, yj, niter=niter, tol=tol, normal=normal)
    to = pmtt.cgls_guarded(T, yt, niter=niter, tol=tol, normal=normal)
    return (jo[0], jo[1], jo[5]), (to[0], to[1], to[5])


def _problem(kind, seed=1, **kw):
    if kind == "cg":
        blocks, rng = spd_blocks(seed, **kw)
        n = sum(b.shape[0] for b in blocks)
    else:
        blocks, rng = rect_blocks(seed, **kw)
        n = sum(b.shape[0] for b in blocks)
    J, T = pair(blocks)
    yj, yt = vecs(rng.standard_normal(n))
    return J, T, yj, yt


KINDS = ["cg", "cgls", "cgls_normal"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("niter,tol,want", [(200, 1e-20, tstatus.CONVERGED),
                                            (3, 1e-30, tstatus.MAXITER)])
def test_healthy_status_matches_jax(kind, niter, tol, want):
    J, T, yj, yt = _problem(kind)
    (jx, jit, jcode), (tx, tit, tcode) = _run(kind, J, T, yj, yt, niter, tol)
    assert jcode == tcode == want
    assert jit == tit
    close(tx.asarray(), jx.asarray())
    name = "cg" if kind == "cg" else "cgls"
    assert tstatus.last_status(name)["status_name"] == \
        tstatus.status_name(want)


@pytest.mark.parametrize("kind", KINDS)
def test_guards_do_not_perturb_a_healthy_solve(kind):
    _, T, _, yt = _problem(kind)
    normal = kind == "cgls_normal"
    if kind == "cg":
        plain = pmtt.cg(T, yt, niter=20, tol=0.0, guards=False)
        guarded = pmtt.cg(T, yt, niter=20, tol=0.0, guards=True)
        assert plain[1] == guarded[1]
    else:
        plain = pmtt.cgls(T, yt, niter=20, tol=0.0, normal=normal,
                          guards=False)
        guarded = pmtt.cgls(T, yt, niter=20, tol=0.0, normal=normal,
                            guards=True)
        assert plain[2] == guarded[2]
    np.testing.assert_array_equal(guarded[0].asarray(), plain[0].asarray())
    # guards=False is the default loop
    default = (pmtt.cg(T, yt, niter=20, tol=0.0) if kind == "cg" else
               pmtt.cgls(T, yt, niter=20, tol=0.0, normal=normal))
    np.testing.assert_array_equal(default[0].asarray(), plain[0].asarray())


# where each solver's poisoned apply is: CG's Op c, classic CGLS's Op c
# at the end of the body, the one-sweep normal_matvec
SITES = {"cg": ("matvec", 1), "cgls": ("matvec", 2),
         "cgls_normal": ("normal", 0)}


@pytest.mark.parametrize("kind", KINDS)
def test_nan_at_iteration_breaks_down_like_jax(kind):
    J, T, yj, yt = _problem(kind)
    at = 4
    which, offset = SITES[kind]
    faults.arm("nan", at)
    (jx, jit, jcode), (tx, tit, tcode) = _run(
        kind, J, Poisoned(T, which, offset + at), yj, yt, 200, 1e-30)
    assert jcode == tcode == tstatus.BREAKDOWN
    # found in the iteration that first uses the poisoned apply: the same
    # one for CG and the one-sweep schedule, the next for classic CGLS
    assert jit == tit == at + (2 if kind == "cgls" else 1)
    tx = tx.asarray()
    assert np.all(np.isfinite(tx))  # the last finite iterate
    close(tx, jx.asarray())


@pytest.mark.parametrize("kind", KINDS)
def test_stagnation_matches_jax(kind, monkeypatch):
    monkeypatch.setenv("PYLOPS_MPI_TPU_GUARD_STALL", "3")
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_GUARD_STALL", "3")
    kw = dict(cond=1e4) if kind == "cg" else dict(seed=2, spread=1.0)
    J, T, yj, yt = _problem(kind, **kw)
    (jx, jit, jcode), (tx, tit, tcode) = _run(kind, J, T, yj, yt, 200, 1e-30)
    assert jcode == tcode == tstatus.STAGNATION
    assert jit == tit < 200
    close(tx.asarray(), jx.asarray())


def test_knob_and_kwarg(monkeypatch):
    _, T, _, yt = _problem("cg")
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_GUARDS", "on")
    pmtt.cg(T, yt, niter=200, tol=1e-12)
    assert tstatus.last_status("cg")["status_name"] == "converged"
    out = pmtt.cgls(T, yt, niter=200, tol=1e-12)
    assert out[1] == 1 and tstatus.last_status("cgls") is not None
    tstatus.clear_statuses()
    pmtt.cg(T, yt, niter=5, guards=False)  # the kwarg beats the knob
    assert tstatus.last_status("cg") is None
    with pytest.raises(ValueError, match="guards="):
        pmtt.cg(T, yt, niter=5, guards="on")
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_GUARDS", "sideways")
    monkeypatch.setattr(tstatus, "_warned_mode", False)
    with pytest.warns(UserWarning, match="PYLOPS_MPI_TPU_TORCH_GUARDS"):
        assert tstatus.guards_mode() == "off"
    for raw, want in [("7", 7), ("1", 2), ("junk", 50)]:
        monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_GUARD_STALL", raw)
        assert tstatus.stall_window() == want
    assert tstatus.STATUS_NAMES == jstatus.STATUS_NAMES
    assert tstatus.status_name(9) == jstatus.status_name(9)


# ------------------------------------------------------ block solvers
def _block_problem(solver, K=4, poison=1):
    if solver == "block_cg":
        blocks, rng = spd_blocks(3, nblk=2, n=6)
    else:
        blocks, rng = rect_blocks(3, nblk=2, m=8, n=6)
    J, T = pair(blocks)
    n = sum(b.shape[0] for b in blocks)
    Y = rng.standard_normal((n, K))
    if poison is not None:
        Y[3, poison] = np.nan
    return J, T, Y


@pytest.mark.parametrize("solver", ["block_cg", "block_cgls"])
def test_block_poisoned_column_statuses_match_jax(solver):
    J, T, Y = _block_problem(solver)
    yj, yt = vecs(Y)
    jo = getattr(jblock, solver)(J, yj, niter=60, tol=1e-20, guards=True)
    to = getattr(pmtt, solver)(T, yt, niter=60, tol=1e-20, guards=True)
    jst, tst = jstatus.last_status(solver), tstatus.last_status(solver)
    assert tst["columns"] == jst["columns"]
    assert tst["column_names"][1] == "breakdown"
    assert tst["column_names"][0] == "converged"
    it = 1 if solver == "block_cg" else 2
    assert to[it] == jo[it]
    jx, tx = np.asarray(jo[0].asarray()), to[0].asarray()
    np.testing.assert_array_equal(tx[:, 1], 0.0)  # rejected from the start
    close(tx, jx)
    # the healthy columns equal the unpoisoned batch's bitwise
    _, _, clean = _block_problem(solver, poison=None)
    ref = getattr(pmtt, solver)(T, vecs(clean)[1], niter=60, tol=1e-20,
                                guards=True)
    healthy = [0, 2, 3]
    np.testing.assert_array_equal(tx[:, healthy],
                                  ref[0].asarray()[:, healthy])


@pytest.mark.parametrize("solver", ["block_cg", "block_cgls"])
def test_block_guards_k1_and_knob(solver, monkeypatch):
    _, T, Y = _block_problem(solver, K=1, poison=None)
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_GUARDS", "on")
    getattr(pmtt, solver)(T, vecs(Y)[1], niter=200, tol=1e-20)
    assert tstatus.last_status(solver)["column_names"] == ["converged"]


# ------------------------------------------------- the repaired loops
@pytest.mark.parametrize("solver", ["block_cg", "block_cgls"])
def test_block_nan_column_unguarded_returns_x0(solver):
    J, T, Y = _block_problem(solver)
    yj, yt = vecs(Y)
    jo = getattr(jblock, solver)(J, yj, niter=20, tol=0.0)
    to = getattr(pmtt, solver)(T, yt, niter=20, tol=0.0)
    it = 1 if solver == "block_cg" else 2
    assert to[it] == jo[it] == 0
    np.testing.assert_array_equal(to[0].asarray(),
                                  np.asarray(jo[0].asarray()))
    np.testing.assert_array_equal(to[0].asarray(), 0.0)


def _nan_y(blocks, rng, every_block=False):
    n = sum(b.shape[0] for b in blocks)
    y = rng.standard_normal(n)
    if every_block:
        y[np.cumsum([0] + [b.shape[0] for b in blocks[:-1]])] = np.nan
    else:
        y[3] = np.nan
    return vecs(y)


@pytest.mark.parametrize("kind", KINDS + ["pipelined_cg", "pipelined_cgls",
                                          "pipelined_block_cg"])
def test_scalar_loops_with_nan_y_match_jax(kind, monkeypatch):
    if kind.startswith("pipelined"):
        monkeypatch.setenv("PYLOPS_MPI_TPU_CA", "pipelined")
        monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_CA", "pipelined")
        pmt.clear_fused_cache()
    blocks, rng = (spd_blocks(5) if "cg" in kind and "cgls" not in kind
                   else rect_blocks(5))
    J, T = pair(blocks)
    if kind == "pipelined_block_cg":
        J, T, Y = _block_problem("block_cg")
        yj, yt = vecs(Y)
        jo = jblock.block_cg(J, yj, niter=20, tol=0.0)
        to = pmtt.block_cg(T, yt, niter=20, tol=0.0)
        jit, tit = jo[1], to[1]
    elif kind.endswith("cg"):
        yj, yt = _nan_y(blocks, rng)
        jo, to = pmt.cg(J, yj, niter=20, tol=0.0), pmtt.cg(T, yt, niter=20,
                                                          tol=0.0)
        jit, tit = jo[1], to[1]
    else:
        yj, yt = _nan_y(blocks, rng)
        normal = kind == "cgls_normal"
        jo = pmt.cgls(J, yj, niter=20, tol=0.0, normal=normal)
        to = pmtt.cgls(T, yt, niter=20, tol=0.0, normal=normal)
        jit, tit = jo[2], to[2]
    assert tit == jit == 0
    np.testing.assert_array_equal(to[0].asarray(),
                                  np.asarray(jo[0].asarray()))


@pytest.mark.parametrize("name", ["ista", "fista"])
def test_sparse_solvers_with_nan_y_match_jax(name):
    blocks, rng = rect_blocks(6)
    J, T = pair(blocks)
    yj, yt = _nan_y(blocks, rng, every_block=True)
    n = J.shape[1]
    jo = getattr(pmt, name)(J, yj, pmt.DistributedArray.to_dist(np.zeros(n)),
                            niter=20, eps=0.1, alpha=0.01, tol=0.0)
    to = getattr(pmtt, name)(T, yt, pmtt.DistributedArray.to_dist(
        np.zeros(n), device="cpu"), niter=20, eps=0.1, alpha=0.01, tol=0.0)
    assert to[1] == jo[1] == 1
    np.testing.assert_array_equal(to[0].asarray(),
                                  np.asarray(jo[0].asarray()))


def test_power_iteration_with_nan_operator_matches_jax():
    blocks, _ = spd_blocks(7)
    blocks[0][2, 2] = np.nan
    J, T = pair(blocks)
    n = J.shape[0]
    jo = pmt.power_iteration(J, pmt.DistributedArray(global_shape=n),
                             niter=12)
    to = pmtt.power_iteration(T, pmtt.DistributedArray(global_shape=n,
                                                       device="cpu"),
                              niter=12)
    assert to[2] == int(jo[2]) == 12
    assert np.isnan(to[0]) and np.isnan(complex(jo[0]).real)
    np.testing.assert_array_equal(to[1].asarray(),
                                  np.asarray(jo[1].asarray()))


def test_guards_refused_on_ca_engines(monkeypatch):
    # the CA engines carry the guard words too now: a healthy guarded
    # solve reads maxiter, and its x is the unguarded engine's, bit for bit
    _, T, _, yt = _problem("cg")
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_CA", "pipelined")
    x, iiter, cost, code = pmtt.cg_guarded(T, yt, niter=3, tol=0.0)
    assert code == tstatus.MAXITER and iiter == 3
    assert tstatus.last_status("cg")["status_name"] == "maxiter"
    xu, itu, costu = pmtt.cg(T, yt, niter=3, tol=0.0, guards=False)
    assert torch.isfinite(costu).all() and itu == iiter
    assert torch.equal(x.array, xu.array)
