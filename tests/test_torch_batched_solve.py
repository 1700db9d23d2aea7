"""The port's ``batched_solve`` held against the JAX package's: a family
of ``MPIBlockDiag`` members (the folded ``(B·nblk, m, n)`` product) and
a family of scaled stacked operators (members applied in turn), CG and
CGLS, each member's lane stopping on its own test (``iiter``, ``cost``
rows past it zero), the family cache (hit on the second call, the LRU
bound and its knob) and the refusals (an unregistered class, a
mismatched family, a family without parameter tensors, a bad solver).

Tolerances: lanes against the JAX package's rtol 1e-9 (relative to the
largest entry, f64, 30 iterations); against the port's own single
solves 1e-10.
"""

import numpy as np
import pytest
import torch

import pylops_mpi_tpu as pmt
from pylops_mpi_tpu.ops.local import MatrixMult as JM
from pylops_mpi_tpu.solvers import block as jblock
import pylops_mpi_tpu_torch as pmtt
from pylops_mpi_tpu_torch.diagnostics import metrics
from pylops_mpi_tpu_torch.solvers import block as tblock

B, NBLK, NITER = 4, 8, 30


@pytest.fixture(autouse=True)
def _fresh_cache():
    tblock._BATCHED_CACHE.clear()
    yield
    tblock._BATCHED_CACHE.clear()


def close(got, want, rtol):
    want = np.asarray(want)
    got = np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(1.0, np.max(np.abs(want))))


def family(rng, spd):
    out = []
    for _ in range(B):
        if spd:
            mats = []
            for _ in range(NBLK):
                a = rng.standard_normal((5, 5))
                mats.append(a @ a.T * 0.2 + (1 + rng.random()) * 3 * np.eye(5))
        else:
            mats = [0.3 * rng.standard_normal((6, 5)) + 3 * np.eye(6, 5)
                    for _ in range(NBLK)]
        out.append(mats)
    return out


def tfac(mats):
    return pmtt.convert.blockdiag_from_numpy(mats, device="cpu")


def jfac(mats):
    return pmt.MPIBlockDiag([JM(m) for m in mats])


def tvec(v):
    return pmtt.DistributedArray.to_dist(torch.as_tensor(v), device="cpu")


@pytest.mark.parametrize("solver", ["cg", "cgls"])
def test_blockdiag_family_matches_jax(rng, solver):
    fam = family(rng, spd=solver == "cg")
    m = 5 * NBLK if solver == "cg" else 6 * NBLK
    ys = [rng.standard_normal(m) for _ in range(B)]
    tol = 1e-10
    kw = dict(solver=solver, niter=NITER, tol=tol)
    if solver == "cgls":
        kw["damp"] = 1e-2
    res = tblock.batched_solve(tfac, fam, [tvec(y) for y in ys], **kw)
    ref = jblock.batched_solve(jfac, fam,
                               [pmt.DistributedArray.to_dist(y) for y in ys],
                               **kw)
    close(res.iiter, np.asarray(ref.iiter), 0)
    assert res.cost.shape == (B, NITER + 1)
    for b in range(B):
        close(res.xs[b].asarray(), np.asarray(ref.xs[b].asarray()), 1e-9)
        it = int(res.iiter[b])
        close(res.cost[b, :it + 1], np.asarray(ref.cost)[b, :it + 1], 1e-9)
        assert np.all(res.cost[b, it + 1:] == 0)
    if solver == "cgls":
        close(res.cost1, np.asarray(ref.cost1), 1e-9)
        close(res.kold, np.asarray(ref.kold), 1e-6)
    else:
        assert res.cost1 is None and res.kold is None
    # lanes stop on their own: the members converge at different counts
    assert len(set(res.iiter.tolist())) > 1 or solver == "cgls"


def test_lanes_match_solo_solves_and_cache_hits(rng):
    """Each lane equals its member's own cgls; a second call of the same
    family hits the cache (and refreshes the stacked parameters in
    place); the LRU keeps 8 families."""
    fam = family(rng, spd=False)
    ys = [tvec(rng.standard_normal(6 * NBLK)) for _ in range(B)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PYLOPS_MPI_TPU_TORCH_METRICS", "on")
        metrics.clear_metrics()
        r1 = tblock.batched_solve(tfac, fam, ys, niter=NITER, tol=0.0)
        fam2 = [[m * 1.5 for m in mats] for mats in fam]
        r2 = tblock.batched_solve(tfac, fam2, ys, niter=NITER, tol=0.0)
        c = metrics.snapshot()["counters"]
        metrics.clear_metrics()
    assert c["solver.batched.cache.miss"] == 1
    assert c["solver.batched.cache.hit"] == 1
    info = tblock.batched_cache_info()
    assert info["size"] == 1 and info["max"] == 8
    assert info["families"] == [("cgls", NITER, B, "MPIBlockDiag")]
    for b in range(B):
        for f, r in ((fam, r1), (fam2, r2)):
            x = pmtt.cgls(tfac(f[b]), ys[b], niter=NITER, tol=0.0)[0]
            close(r.xs[b].asarray(), x.asarray(), 1e-10)
    assert not np.allclose(r1.xs[0].asarray(), r2.xs[0].asarray())


def test_cache_bound(rng, monkeypatch):
    monkeypatch.setattr(tblock, "_BATCHED_MAX", 2)
    fam = family(rng, spd=False)
    ys = [tvec(rng.standard_normal(6 * NBLK)) for _ in range(B)]
    for niter in (3, 4, 5):
        tblock.batched_solve(tfac, fam, ys, niter=niter, tol=0.0)
    info = tblock.batched_cache_info()
    assert info["size"] == 2 and info["max"] == 2
    assert [f[1] for f in info["families"]] == [4, 5]


def test_scaled_stacked_family_matches_jax(rng):
    """A family without a fold (members scaled by their own 0-d ε, applied
    in turn), against the JAX package's vmapped family."""
    import jax.numpy as jnp
    mats = [0.3 * rng.standard_normal((6, 5)) + 3 * np.eye(6, 5)
            for _ in range(NBLK)]
    Top = tfac(mats)
    Jop = jfac(mats)
    epss = [0.5, 1.0, 2.0]
    ys = [rng.standard_normal(6 * NBLK) for _ in epss]
    res = tblock.batched_solve(
        lambda e: torch.tensor(e, dtype=torch.float64) * Top, epss,
        [tvec(y) for y in ys], niter=NITER, tol=0.0)
    ref = jblock.batched_solve(lambda e: jnp.asarray(e) * Jop, epss,
                               [pmt.DistributedArray.to_dist(y) for y in ys],
                               niter=NITER, tol=0.0)
    for b in range(len(epss)):
        close(res.xs[b].asarray(), np.asarray(ref.xs[b].asarray()), 1e-9)


def test_refusals(rng):
    fam = family(rng, spd=False)
    ys = [tvec(rng.standard_normal(6 * NBLK)) for _ in range(B)]
    with pytest.raises(ValueError, match="'cg' or 'cgls'"):
        tblock.batched_solve(tfac, fam, ys, solver="gmres")
    with pytest.raises(ValueError, match="one y per parameter set"):
        tblock.batched_solve(tfac, fam, ys[:2])

    class _Unreg(pmtt.MPILinearOperator):
        pass

    with pytest.raises(TypeError, match="register_operator_params"):
        tblock.batched_solve(lambda p: _Unreg(shape=(48, 40),
                                              dtype=np.float64),
                             [0, 1], ys[:2])
    with pytest.raises(ValueError, match="same-shape"):
        tblock.batched_solve(
            tfac, [fam[0], [m[:, :4] for m in fam[1]]], ys[:2])
    with pytest.raises(ValueError, match="no parameter tensors"):
        tblock.batched_solve(
            lambda p: pmtt.MPIFirstDerivative(48, dtype=torch.float64),
            [0, 1], ys[:2])
    with pytest.raises(ValueError, match="other shapes or dtypes"):
        tblock.batched_solve(
            lambda e: torch.tensor(e) * tfac(fam[0]),
            [np.float64(1.0), np.float32(1.0)], ys[:2])
