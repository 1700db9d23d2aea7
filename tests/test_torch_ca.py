"""The port's communication-avoiding engines held against the JAX
package's under the same mode: pipelined CG and CGLS (``normal`` both
ways, with and without ``M``), s-step CG, pipelined block CG/CGLS; the
s-step breakdown falling back to the pipelined engine; spaces that
s-step cannot serve routing to pipelined; the knobs, the reduction
tables and ``auto`` raising.

Each package's knob is set in its own namespace
(``PYLOPS_MPI_TPU_CA`` for the JAX package, ``PYLOPS_MPI_TPU_TORCH_CA``
for the port). Tolerance: f64 rtol 1e-9 (relative to the largest entry)
over 10 iterations (short of the machine floor, where the JAX
package's s-step loop would spin with tol=0).
"""

import os
import warnings

import numpy as np
import pytest
import torch

import pylops_mpi_tpu as pmt
import pylops_mpi_tpu_torch as pmtt
from pylops_mpi_tpu.ops import precond as jpc
from pylops_mpi_tpu.ops.local import MatrixMult as JM
from pylops_mpi_tpu.solvers import block as jblock
from pylops_mpi_tpu.solvers import ca as jca
from pylops_mpi_tpu_torch.ops import precond as tpc
from pylops_mpi_tpu_torch.solvers import ca
from pylops_mpi_tpu_torch.utils import deps

NITER = 10
KNOBS = ("PYLOPS_MPI_TPU_CA", "PYLOPS_MPI_TPU_CA_S",
         "PYLOPS_MPI_TPU_TORCH_CA", "PYLOPS_MPI_TPU_TORCH_CA_S")


@pytest.fixture(autouse=True)
def _fresh_knobs():
    saved = {k: os.environ.pop(k, None) for k in KNOBS}
    ca.clear_fallback()
    yield
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    ca.clear_fallback()


def set_modes(mode, s=None):
    """The same engine in both packages."""
    os.environ["PYLOPS_MPI_TPU_CA"] = mode
    os.environ["PYLOPS_MPI_TPU_TORCH_CA"] = mode
    if s is not None:
        os.environ["PYLOPS_MPI_TPU_CA_S"] = str(s)
        os.environ["PYLOPS_MPI_TPU_TORCH_CA_S"] = str(s)
    pmt.clear_fused_cache()


def close(got, want, rtol):
    want = np.asarray(want)
    got = np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.max(np.abs(want)))


def spd_blocks(rng, nblk=8, n=8, spread=1e2, dtype=np.float64):
    out = []
    for s in np.logspace(0, np.log10(spread), nblk):
        a = rng.standard_normal((n, n))
        out.append((((a @ a.T) * 0.1 + n * np.eye(n)) * s).astype(dtype))
    return out


def jarr(v):
    return pmt.DistributedArray.to_dist(v)


def tarr(v, **kw):
    return pmtt.DistributedArray.to_dist(v, device="cpu", **kw)


def jbd(blocks):
    return pmt.MPIBlockDiag([JM(b) for b in blocks])


def tbd(blocks):
    return pmtt.convert.blockdiag_from_numpy(blocks, device="cpu")


# ------------------------------------------------------------- knobs

def test_knobs_and_tables(monkeypatch):
    for raw, want in [("", "off"), ("none", "off"), ("classic", "off"),
                      ("PIPELINED", "pipelined"), (" sstep ", "sstep"),
                      ("auto", "auto")]:
        monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_CA", raw)
        assert deps.ca_mode() == want
    monkeypatch.setattr(deps, "_warned_ca", False)
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_CA", "bogus")
    with pytest.warns(UserWarning, match="bogus"):
        assert deps.ca_mode() == "off"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert deps.ca_mode() == "off"  # warned once only
    for raw, want in [("6", 6), ("1", 2), ("junk", 4)]:
        monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_CA_S", raw)
        assert deps.ca_s_default() == want
    assert [n for n, *_ in deps.KNOBS] == [
        "PYLOPS_MPI_TPU_TORCH_PRECISION", "PYLOPS_MPI_TPU_TORCH_PRECOND",
        "PYLOPS_MPI_TPU_TORCH_MG_LEVELS", "PYLOPS_MPI_TPU_TORCH_CA",
        "PYLOPS_MPI_TPU_TORCH_CA_S", "PYLOPS_MPI_TPU_TORCH_REDUCE_STALL",
        "PYLOPS_MPI_TPU_TORCH_BATCH"]
    for solver in ("cg", "cgls", "block_cg", "block_cgls", "other"):
        assert ca.classic_reductions_per_iter(solver) == \
            jca.classic_reductions_per_iter(solver)
    for mode, s in [("pipelined", 1), ("sstep", 4), ("sstep", 0),
                    ("off", 1)]:
        assert ca.ca_reductions_per_iter(mode, s) == \
            jca.ca_reductions_per_iter(mode, s)
        assert ca.ca_key(mode, 3) == jca.ca_key(mode, 3)
    assert ca.BREAKDOWN == 3 and ca.RUNNING == 0


def test_auto_raises(rng):
    # auto no longer raises: it resolves through the cost model as the
    # JAX package's does; on the CPU with no latency stall armed that is
    # the classic engine, so each solve equals its CA=off run bitwise
    top = tbd(spd_blocks(rng))
    y = tarr(rng.standard_normal(64))
    yb = tarr(np.ones((64, 2)))
    calls = (lambda: pmtt.cg(top, y, niter=3),
             lambda: pmtt.cgls(top, y, niter=3),
             lambda: pmtt.block_cg(top, yb, niter=3))
    for call in calls:
        set_modes("auto")
        got = call()
        set_modes("off")
        want = call()
        assert torch.equal(got[0].array, want[0].array)
        assert got[1] == want[1]


# ------------------------------------------------- engines against JAX

CASES = {  # name: (mode, solver, normal, precond, damp)
    "pipe_cg": ("pipelined", "cg", None, None, 0.0),
    "pipe_cg_jacobi": ("pipelined", "cg", None, "jacobi", 0.0),
    "pipe_cgls": ("pipelined", "cgls", False, None, 0.3),
    "pipe_cgls_normal": ("pipelined", "cgls", True, None, 0.0),
    "pipe_cgls_normal_block": ("pipelined", "cgls", True, "block", 0.2),
    "sstep_cg": ("sstep", "cg", None, None, 0.0),
    "sstep_cg_jacobi": ("sstep", "cg", None, "jacobi", 0.0),
    "sstep_cgls_routes": ("sstep", "cgls", False, None, 0.0),
    "pipe_block_cg": ("pipelined", "block_cg", None, "jacobi", 0.0),
    "pipe_block_cgls": ("pipelined", "block_cgls", None, None, 0.2),
}


def _precond(mod, op, kind, damp, normal_blocks=None):
    if kind == "jacobi":
        return mod.JacobiPrecond.from_operator(op)
    return mod.BlockJacobiPrecond.from_block_diag(op, normal=True, damp=damp)


def _solve(pkg, op, y, mode, solver, normal, M, damp):
    if solver == "cg":
        x, it, cost = pkg.cg(op, y, niter=NITER, tol=0.0, M=M)
        return x, it, cost, None
    if solver == "cgls":
        x, _, it, kold, _, cost = pkg.cgls(op, y, niter=NITER, damp=damp,
                                           tol=0.0, normal=normal, M=M)
        return x, it, cost, kold
    if solver == "block_cg":
        fn = jblock.block_cg if pkg is pmt else pmtt.block_cg
        x, it, cost = fn(op, y, niter=NITER, tol=0.0, M=M)
        return x, it, cost, None
    fn = jblock.block_cgls if pkg is pmt else pmtt.block_cgls
    x, _, it, kold, _, cost = fn(op, y, niter=NITER, damp=damp, tol=0.0, M=M)
    return x, it, cost, kold


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(5)
    spd = spd_blocks(rng)
    rect = [rng.standard_normal((10, 8)) * s + 2 * np.eye(10, 8)
            for s in np.logspace(0, 1, 8)]
    ys = {"cg": rng.standard_normal(64), "cgls": rng.standard_normal(80),
          "block_cg": rng.standard_normal((64, 3)),
          "block_cgls": rng.standard_normal((80, 3))}
    saved = {k: os.environ.get(k) for k in KNOBS}
    ref = {}
    try:
        for name, (mode, solver, normal, pk, damp) in CASES.items():
            set_modes(mode)
            jop = jbd(spd if solver.endswith("cg") else rect)
            jM = _precond(jpc, jop, pk, damp) if pk else None
            x, it, cost, kold = _solve(pmt, jop, jarr(ys[solver]), mode,
                                       solver, normal, jM, damp)
            ref[name] = (np.asarray(x.asarray()), it, np.asarray(cost),
                         None if kold is None else np.asarray(kold))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        pmt.clear_fused_cache()
    return dict(spd=spd, rect=rect, ys=ys, ref=ref)


@pytest.mark.parametrize("name", list(CASES))
def test_engine_matches_jax(problem, name):
    mode, solver, normal, pk, damp = CASES[name]
    set_modes(mode)
    top = tbd(problem["spd"] if solver.endswith("cg") else problem["rect"])
    tM = _precond(tpc, top, pk, damp) if pk else None
    x, it, cost, kold = _solve(pmtt, top, tarr(problem["ys"][solver]), mode,
                               solver, normal, tM, damp)
    jx, jit, jcost, jkold = problem["ref"][name]
    assert it == jit
    close(x.asarray(), jx, 1e-9)
    close(cost.numpy(), jcost, 1e-9)
    if jkold is not None:  # held relative to the initial kold
        np.testing.assert_allclose(kold.numpy(), jkold, rtol=0,
                                   atol=1e-9 * np.max(jcost[0]) ** 2)
    assert ca.last_fallback() is None


def test_pipelined_converges_like_classic(problem):
    """Near the classic engine's iteration count (the parity rule of
    ``bench.py:_ca_race_row``), to the same point."""
    top = tbd(problem["spd"])
    y = tarr(problem["ys"]["cg"])
    tol = 1e-16 * float(problem["ys"]["cg"] @ problem["ys"]["cg"])
    x0, it0, _ = pmtt.cg(top, y, niter=200, tol=tol)
    set_modes("pipelined")
    x1, it1, _ = pmtt.cg(top, y, niter=200, tol=tol)
    assert abs(it1 - it0) <= max(2, round(0.1 * it0))
    close(x1.asarray(), x0.asarray(), 1e-6)


# ------------------------------------------------------- s-step rails

def test_sstep_breakdown_falls_back_to_pipelined():
    """An ill-conditioned f32 system at deep s breaks the monomial basis:
    the solve continues under the pipelined engine from the last
    completed outer iterate, reports it, and makes real progress (JAX
    ``tests/test_ca.py:374-405``, without guards)."""
    rng = np.random.default_rng(42)
    mats = spd_blocks(rng, spread=1e4, dtype=np.float32)
    top = tbd(mats)
    import scipy.linalg as spla
    xt = rng.standard_normal(64)
    y = (spla.block_diag(*mats).astype(np.float64) @ xt).astype(np.float32)
    set_modes("sstep", s=8)
    x, it, cost = pmtt.cg(top, tarr(y), niter=300, tol=1e-10)
    fb = ca.last_fallback()
    assert fb is not None and fb["solver"] == "cg" and fb["s"] == 8
    err = np.linalg.norm(x.asarray() - xt) / np.linalg.norm(xt)
    assert np.isfinite(err) and err < 0.5
    assert cost.shape == (it + 1,)
    # the basis broke at iteration 0, so the continuation is a pure
    # pipelined solve, bit for bit
    assert fb["iteration"] == 0
    set_modes("pipelined")
    ca.clear_fallback()
    xp, itp, _ = pmtt.cg(top, tarr(y), niter=300, tol=1e-10)
    assert ca.last_fallback() is None and itp == it
    assert torch.equal(x.array, xp.array)


def test_sstep_ineligible_routes_to_pipelined(problem, rng):
    """Masked, complex and stacked spaces run the pipelined engine."""
    spd = problem["spd"]
    y = problem["ys"]["cg"]
    Stacked = pmtt.StackedDistributedArray
    cases = [(pmtt.convert.blockdiag_from_numpy(spd, device="cpu",
                                                mask=[0]),
              tarr(y, mask=[0]), None),
             (tbd([b.astype(np.complex128) for b in spd]),
              tarr(y + 1j * rng.standard_normal(64)), None),
             (pmtt.ops.blockdiag.MPIStackedBlockDiag(
                 [tbd(spd[:4]), tbd(spd[4:])]),
              Stacked([tarr(y[:32]), tarr(y[32:])]),
              Stacked([tarr(np.zeros(32)), tarr(np.zeros(32))]))]
    for op, yy, x0 in cases:
        set_modes("sstep")
        x, it, cost = pmtt.cg(op, yy, x0, niter=NITER, tol=0.0)
        set_modes("pipelined")
        xp, itp, costp = pmtt.cg(op, yy, x0, niter=NITER, tol=0.0)
        assert it == itp
        assert torch.equal(cost, costp)
        assert np.array_equal(x.asarray(), xp.asarray())
    assert ca.last_fallback() is None
