"""The port's ISTA/FISTA (fused functions and classes) and CG/CGLS
classes held against the JAX package: the same numpy blocks, data and
seeds through both.

Tolerances: float64 throughout. Iterates and cost histories at rtol
1e-9 of their largest entry, with equal iteration counts (the packages
sum in different orders; tens of iterations amplify that only
slightly). The threshold functions at rtol 1e-12. The port's class API
against its own fused path, and its CG/CGLS classes against its
functional cg/cgls, at rtol 1e-12 (same arithmetic, other dispatch).
"""

import numpy as np
import pytest
import torch

import pylops_mpi_tpu as pmt
import pylops_mpi_tpu_torch as pmtt
from pylops_mpi_tpu.ops.local import (Conv1D as JConv1D,
                                      FirstDerivative as JFirstDerivative,
                                      MatrixMult as JMatrixMult)
from pylops_mpi_tpu.solvers import sparsity as jsp
from pylops_mpi_tpu_torch.ops.local import (Conv1D as TConv1D,
                                            FirstDerivative as TFirstDerivative,
                                            MatrixMult as TMatrixMult)
from pylops_mpi_tpu_torch.solvers import sparsity as tsp

RTOL = 1e-9
NBLK = 8


def close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * np.max(np.abs(want)))


def _cplx(rng, shape, cmplx):
    x = rng.standard_normal(shape)
    return x + 1j * rng.standard_normal(shape) if cmplx else x


def _blockdiag(blocks):
    return (pmt.MPIBlockDiag([JMatrixMult(b, dtype=b.dtype) for b in blocks]),
            pmtt.MPIBlockDiag([TMatrixMult(b, device="cpu") for b in blocks]))


def _vec(x):
    return (pmt.DistributedArray.to_dist(x),
            pmtt.DistributedArray.to_dist(x, device="cpu"))


def _problem(rng, m=12, n=8, cmplx=False):
    """Tall blocks and a sparse model with its exact data."""
    blocks = [_cplx(rng, (m, n), cmplx) / np.sqrt(m) for _ in range(NBLK)]
    xtrue = np.zeros(NBLK * n, dtype=blocks[0].dtype)
    idx = rng.choice(NBLK * n, size=NBLK, replace=False)
    xtrue[idx] = _cplx(rng, NBLK, cmplx) * 3
    y = np.concatenate([b @ xtrue[i * n:(i + 1) * n]
                        for i, b in enumerate(blocks)])
    return blocks, xtrue, y


def _sop(rng, n=8):
    """A sparsifying transform: a block diagonal of orthogonal blocks."""
    qs = [np.linalg.qr(rng.standard_normal((n, n)))[0] for _ in range(NBLK)]
    return _blockdiag(qs)


CASES = [  # (solver, threshkind, complex, SOp, decay, tol, stacked)
    ("ista", "soft", False, False, False, 1e-10, False),
    ("ista", "hard", False, False, False, 1e-10, False),
    ("ista", "half", False, False, False, 1e-10, False),
    ("fista", "soft", False, False, False, 1e-10, False),
    ("fista", "hard", False, False, False, 1e-10, False),
    ("fista", "half", False, False, False, 1e-10, False),
    ("ista", "soft", True, False, False, 1e-10, False),
    ("fista", "soft", True, False, False, 1e-10, False),
    ("fista", "soft", False, True, False, 1e-10, False),
    ("ista", "soft", False, False, True, 1e-10, False),
    ("fista", "half", False, False, True, 1e-10, False),
    ("ista", "soft", False, False, False, 5e-2, False),
    ("fista", "soft", False, False, False, 1e-2, False),
    ("fista", "soft", False, False, False, 1e-10, True),
]


def _setup(rng, cmplx, sop, decay, stacked, niter):
    blocks, xtrue, y = _problem(rng, cmplx=cmplx)
    jop, top = _blockdiag(blocks)
    jy, ty = _vec(y)
    if stacked:
        # a second block row: the data is a two-component stack
        blocks2 = [_cplx(rng, (5, 8), cmplx) / np.sqrt(5)
                   for _ in range(NBLK)]
        j2, t2 = _blockdiag(blocks2)
        y2 = np.concatenate([b @ xtrue[i * 8:(i + 1) * 8]
                             for i, b in enumerate(blocks2)])
        jy2, ty2 = _vec(y2)
        jop, top = pmt.MPIStackedVStack([jop, j2]), \
            pmtt.MPIStackedVStack([top, t2])
        jy = pmt.StackedDistributedArray([jy, jy2])
        ty = pmtt.StackedDistributedArray([ty, ty2])
    jx0, tx0 = _vec(np.zeros_like(xtrue))
    kw = dict(niter=niter, eps=0.05)
    if decay:
        kw["decay"] = np.linspace(2.0, 0.5, niter)
    jkw, tkw = dict(kw), dict(kw)
    if sop:
        jkw["SOp"], tkw["SOp"] = _sop(rng)
    return (jop, jy, jx0, jkw), (top, ty, tx0, tkw), xtrue


@pytest.mark.parametrize("solver,threshkind,cmplx,sop,decay,tol,stacked",
                         CASES)
def test_fused_matches_jax(rng, solver, threshkind, cmplx, sop, decay, tol,
                           stacked):
    niter = 60
    (jop, jy, jx0, jkw), (top, ty, tx0, tkw), _ = _setup(
        rng, cmplx, sop, decay, stacked, niter)
    jfn, tfn = getattr(pmt, solver), getattr(pmtt, solver)
    jx, jit, jcost = jfn(jop, jy, jx0, tol=tol, threshkind=threshkind, **jkw)
    tx, tit, tcost = tfn(top, ty, tx0, tol=tol, threshkind=threshkind, **tkw)
    assert tit == jit
    if tol > 1e-6:
        assert 0 < tit < niter and tit % 8 != 0
    assert tx.dtype == (torch.complex128 if cmplx else torch.float64)
    close(tx.asarray(), jx.asarray())
    close(tcost.numpy(), jcost)


@pytest.mark.parametrize("case", [0, 4, 7, 8, 12])
def test_class_api_matches_jax_and_fused(rng, case):
    """fused=False runs the class API: held against the JAX package's
    class API, and against the port's own fused path."""
    solver, threshkind, cmplx, sop, decay, tol, stacked = CASES[case]
    niter = 40
    (jop, jy, jx0, jkw), (top, ty, tx0, tkw), _ = _setup(
        rng, cmplx, sop, decay, stacked, niter)
    jfn, tfn = getattr(pmt, solver), getattr(pmtt, solver)
    jx, jit, jcost = jfn(jop, jy, jx0, tol=tol, threshkind=threshkind,
                         fused=False, **jkw)
    tx, tit, tcost = tfn(top, ty, tx0, tol=tol, threshkind=threshkind,
                         fused=False, **tkw)
    assert tit == jit and isinstance(tcost, np.ndarray)
    close(tx.asarray(), jx.asarray())
    close(tcost, jcost)
    fx, fit, fcost = tfn(top, ty, tx0, tol=tol, threshkind=threshkind, **tkw)
    assert fit == tit
    close(fx.asarray(), tx.asarray(), 1e-12)
    close(fcost.numpy(), tcost, 1e-12)


def test_class_steps_and_hooks(rng):
    """The class API step by step: callback once per iteration, the
    ISTA/FISTA classes importable from optimization paths, and solve()
    against the JAX package's classes."""
    from pylops_mpi_tpu_torch.optimization.cls_sparsity import FISTA, ISTA
    (jop, jy, jx0, jkw), (top, ty, tx0, tkw), _ = _setup(
        rng, False, False, False, False, 25)
    for jcls, tcls in ((jsp.ISTA, ISTA), (jsp.FISTA, FISTA)):
        seen = []
        solver = tcls(top)
        solver.callback = lambda x: seen.append(x.asarray().copy())
        tx, tit, tcost = solver.solve(ty, tx0, tol=0.0, **tkw)
        jx, jit, jcost = jcls(jop).solve(jy, jx0, tol=0.0, **jkw)
        assert tit == jit == 25 == len(seen)
        close(seen[-1], tx.asarray(), 0)
        close(tx.asarray(), jx.asarray())
        close(tcost, jcost)
        x = solver.setup(ty, tx0, niter=3, eps=0.05)
        for _ in range(3):
            x, xupdate = solver.step(x)
        assert solver.iiter == 3 and xupdate > 0


def test_callback_and_show_through_function(rng, capsys):
    """A callback or show routes the functions to the class API."""
    (_, _, _, _), (top, ty, tx0, tkw), _ = _setup(
        rng, False, False, False, False, 12)
    calls = []
    x, iiter, cost = pmtt.fista(top, ty, tx0, tol=0.0,
                                callback=lambda x: calls.append(1), **tkw)
    assert iiter == 12 == len(calls) == len(cost)
    pmtt.ista(top, ty, tx0, tol=0.0, show=True, **tkw)
    out = capsys.readouterr().out
    assert out.startswith("ISTA") and len(out.splitlines()) == 2 + 12


@pytest.mark.parametrize("solver", ["ista", "fista"])
def test_monitorres_raises(rng, solver):
    """Too long a step makes the residual grow: both packages stop with
    a ValueError."""
    (jop, jy, jx0, jkw), (top, ty, tx0, tkw), _ = _setup(
        rng, False, False, False, False, 30)
    alpha = 4.0 / pmtt.power_iteration(top.H @ top, tx0.zeros_like(),
                                       niter=200, tol=1e-10)[0]
    with pytest.raises(ValueError, match="residual increasing"):
        getattr(pmt, solver)(jop, jy, jx0, alpha=alpha, monitorres=True,
                             **jkw)
    with pytest.raises(ValueError, match="residual increasing"):
        getattr(pmtt, solver)(top, ty, tx0, alpha=alpha, monitorres=True,
                              **tkw)


def test_argument_errors(rng):
    (_, _, _, _), (top, ty, tx0, tkw), _ = _setup(
        rng, False, False, False, False, 5)
    with pytest.raises(ValueError, match="fused=True"):
        pmtt.ista(top, ty, tx0, fused=True, callback=print, **tkw)
    with pytest.raises(NotImplementedError):
        pmtt.fista(top, ty, tx0, perc=50, **tkw)
    with pytest.raises(NotImplementedError):
        pmtt.ista(top, ty, tx0, threshkind="nope", **tkw)
    with pytest.raises(NotImplementedError):
        pmtt.ISTA(top).setup(ty, tx0, perc=50)
    with pytest.raises(ValueError, match="x0"):
        pmtt.fista(top, ty, None, **tkw)


@pytest.mark.parametrize("cmplx", [False, True])
@pytest.mark.parametrize("kind", ["soft", "hard", "half"])
def test_thresholds(rng, kind, cmplx):
    """Each threshold on an input with exact zeros and entries on both
    sides of the cut: the half threshold's inf at zero yields zeros, no
    NaN."""
    import jax.numpy as jnp
    x = _cplx(rng, 200, cmplx)
    x[::17] = 0
    for t in (0.3, 1.2):
        want = np.asarray(jsp._THRESHF[kind](jnp.asarray(x), t))
        got = tsp._THRESHF[kind](torch.from_numpy(x), t)
        assert not torch.isnan(got).any()
        close(got.numpy(), want, 1e-12)
        got_t = tsp._THRESHF[kind](torch.from_numpy(x),
                                   torch.tensor(t, dtype=torch.float64))
        close(got_t.numpy(), want, 1e-12)
        assert (got.numpy()[::17] == 0).all()


def test_reflectivity_example(rng):
    """examples/reflectivity.py end to end: FISTA for a spiky
    reflectivity through MPIBlockDiag of local Conv1D blocks, at the
    example's size and, through the port, its iteration count. The
    centered derivative turns
    each of the three impedance steps into two equal adjacent spikes;
    the six strongest recovered depths of a trace are those six."""
    ny, nx, nz = 8, 12, 64
    m1d = 5.0 * np.ones(nz)
    m1d[20:] = 7.0
    m1d[35:] = 4.5
    m1d[50:] = 6.0
    m3d = np.tile(m1d, (ny, nx, 1))
    wav = pmtt.models.ricker(np.arange(21) * 0.004, f0=15)[0]
    wavc = len(wav) // 2
    dims = (ny // NBLK, nx, nz)
    jD = pmt.MPIBlockDiag([JFirstDerivative(dims, axis=-1,
                                            dtype=np.float64)] * NBLK)
    jC = pmt.MPIBlockDiag([JConv1D(dims, wav, axis=-1, offset=wavc,
                                   dtype=np.float64)] * NBLK)
    tD = pmtt.MPIBlockDiag([TFirstDerivative(dims, axis=-1,
                                             dtype=torch.float64)] * NBLK)
    tC = pmtt.MPIBlockDiag([TConv1D(dims, wav, axis=-1, offset=wavc,
                                    dtype=torch.float64, device="cpu")] * NBLK)
    jm, tm = _vec(m3d.ravel())
    jr, tr = jD @ jm, tD @ tm
    jd, td = jC @ jr, tC @ tr
    close(td.asarray(), jd.asarray(), 1e-12)
    jr0, tr0 = _vec(np.zeros(ny * nx * nz))
    # the JAX package takes ~25 s for the example's 400 iterations on
    # the CPU mesh: held against it over the first 100
    jx, jit, jcost = pmt.fista(jC, jd, x0=jr0, niter=100, eps=1e-3,
                               tol=1e-10)[:3]
    tx, tit, tcost = pmtt.fista(tC, td, x0=tr0, niter=100, eps=1e-3,
                                tol=1e-10)
    assert tit == jit == 100
    close(tx.asarray(), jx.asarray())
    close(tcost.numpy(), jcost)
    tx, tit, _ = pmtt.fista(tC, td, x0=tr0, niter=400, eps=1e-3, tol=1e-10)
    spikes = np.nonzero(tr.asarray().reshape(ny, nx, nz)[0, 0])[0]
    assert list(spikes) == [19, 20, 34, 35, 49, 50]
    trace = tx.asarray().reshape(ny, nx, nz)[0, 0]
    assert sorted(np.argsort(np.abs(trace))[-6:]) == list(spikes)


@pytest.mark.parametrize("damp", [0.0, 0.3])
def test_cg_cgls_classes(rng, damp):
    """CG/CGLS classes: against the port's functional cg/cgls and the
    JAX package's classes, from the optimization import paths."""
    from pylops_mpi_tpu_torch.optimization.cls_basic import CG, CGLS
    from pylops_mpi_tpu_torch.optimization.basic import cg, cgls
    n = 6
    sym = []
    for _ in range(NBLK):
        a = rng.standard_normal((n, n))
        sym.append(a @ a.T + n * np.eye(n))
    jop, top = _blockdiag(sym)
    y = rng.standard_normal(NBLK * n)
    jy, ty = _vec(y)
    jx0, tx0 = _vec(np.zeros(NBLK * n))
    seen = []
    solver = CG(top)
    solver.callback = lambda x: seen.append(1)
    tx, tit, tcost = solver.solve(ty, tx0, niter=15, tol=1e-20, show=True)
    fx, fit, fcost = cg(top, ty, tx0, niter=15, tol=1e-20)
    jx, jit, jcost = pmt.solvers.basic.CG(jop).solve(jy, jx0, niter=15,
                                                     tol=1e-20)
    assert tit == fit == jit == len(seen)
    close(tx.asarray(), fx.asarray(), 1e-12)
    close(tcost, fcost.numpy(), 1e-12)
    close(tx.asarray(), jx.asarray())
    close(tcost, jcost)

    tall = [rng.standard_normal((9, n)) for _ in range(NBLK)]
    jop, top = _blockdiag(tall)
    y = rng.standard_normal(NBLK * 9)
    jy, ty = _vec(y)
    tout = CGLS(top).solve(ty, tx0, niter=12, damp=damp, tol=0.0)
    fout = cgls(top, ty, tx0, niter=12, damp=damp, tol=0.0)
    jout = pmt.solvers.basic.CGLS(jop).solve(jy, jx0, niter=12, damp=damp,
                                             tol=0.0)
    assert tout[1:3] == fout[1:3] == jout[1:3] == (2, 12)
    close(tout[0].asarray(), fout[0].asarray(), 1e-12)
    close(tout[5], fout[5].numpy(), 1e-12)
    close(float(tout[4]), float(fout[4]), 1e-12)
    close(tout[0].asarray(), jout[0].asarray())
    close(tout[5], jout[5])


def test_apply_thresh_stacked(rng):
    """_apply_thresh on a stacked vector, component by component,
    against the JAX package's on the same components; the port also
    takes a nested stack (the JAX package's function takes one level)."""
    comps = [rng.standard_normal(7), [rng.standard_normal(5),
                                      rng.standard_normal(9)]]
    want = jsp._apply_thresh(pmt.StackedDistributedArray(
        [pmt.DistributedArray.to_dist(x)
         for x in (comps[0], comps[1][0], comps[1][1])]),
        jsp._softthreshold, 0.4)
    got = tsp._apply_thresh(pmtt.convert.stacked_from_numpy(comps,
                                                            device="cpu"),
                            tsp._softthreshold, 0.4)
    assert isinstance(got[1], pmtt.StackedDistributedArray)
    close(got.asarray(), want.asarray(), 1e-12)


@pytest.mark.parametrize("module", ["basic", "cls_basic", "sparsity",
                                    "cls_sparsity", "eigs"])
def test_optimization_paths(module):
    """The reference's import paths: each name the JAX package's
    optimization module exports is there, and is the solver itself."""
    import importlib
    jmod = importlib.import_module(f"pylops_mpi_tpu.optimization.{module}")
    tmod = importlib.import_module(
        f"pylops_mpi_tpu_torch.optimization.{module}")
    names = [n for n in vars(jmod) if not n.startswith("_")]
    assert names
    for n in names:
        assert getattr(tmod, n) is getattr(pmtt.optimization, n) \
            is getattr(pmtt.solvers, n)
