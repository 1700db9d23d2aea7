"""The port's preconditioners and the ``M=`` seam held against the JAX
package: each apply (Jacobi, block-Jacobi with its clamp, the V-cycle)
on the same numbers, ``probe_diagonal`` in its four branches,
``make_precond`` and the ``MG_LEVELS`` knob, the converters, and PCG /
PCGLS (classic and ``normal=True``) solves at a fixed iteration count.

Tolerances: applies rtol 1e-12 in f64 and 1e-5 in f32 (relative to the
largest entry); solves rtol 1e-9 in f64 over 12 iterations. The JAX
references are computed once per module (each fused solve compiles).
"""

import numpy as np
import pytest
import torch

import pylops_mpi_tpu as pmt
import pylops_mpi_tpu_torch as pmtt
import jax.numpy as jnp
from pylops_mpi_tpu.linearoperator import MPILinearOperator as JOp
from pylops_mpi_tpu.ops import precond as jpc
from pylops_mpi_tpu.ops.local import MatrixMult as JM
from pylops_mpi_tpu_torch.ops import precond as tpc

NITER = 12


def close(got, want, rtol):
    want = np.asarray(want)
    got = np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.max(np.abs(want)))


def varied_spd(rng, nblk=8, n=8, spread=1e2):
    """SPD blocks whose scales span ``spread``: diagonal
    ill-conditioning that Jacobi and block-Jacobi remove."""
    out = []
    for s in np.logspace(0, np.log10(spread), nblk):
        a = rng.standard_normal((n, n))
        out.append(((a @ a.T) * 0.1 + n * np.eye(n)) * s)
    return out


def jax_lap(dims):
    """The SPD Dirichlet 5-point Laplacian on ``dims`` (JAX side)."""
    ny, nx = dims

    class Lap(JOp):
        accepts_block = True

        def __init__(self):
            super().__init__(shape=(ny * nx, ny * nx), dtype=np.float64)

        def _matvec(self, x):
            g = x._global()
            vec = g.ndim == 1
            t = g.reshape((ny, nx) if vec else (ny, nx, g.shape[-1]))
            p = jnp.pad(t, ((1, 1), (1, 1)) + (() if vec else ((0, 0),)))
            out = (4.0 * t - p[:-2, 1:-1] - p[2:, 1:-1]
                   - p[1:-1, :-2] - p[1:-1, 2:])
            return jpc._wrap_like(out.reshape(g.shape), x)

        _rmatvec = _matvec

    return Lap()


def torch_lap(dims):
    """The same Laplacian in the port (every rank gathers, applies and
    keeps its rows)."""
    ny, nx = dims

    class Lap(pmtt.MPILinearOperator):
        accepts_block = True

        def __init__(self):
            super().__init__(shape=(ny * nx, ny * nx), dtype=torch.float64)

        def _matvec(self, x):
            g = x._global()
            t = g.reshape((ny, nx) + tuple(g.shape[1:]))
            p = torch.nn.functional.pad(
                t.movedim((0, 1), (-2, -1)), (1, 1, 1, 1)).movedim(
                    (-2, -1), (0, 1))
            out = (4.0 * t - p[:-2, 1:-1] - p[2:, 1:-1]
                   - p[1:-1, :-2] - p[1:-1, 2:])
            return pmtt.DistributedArray._wrap(
                x._shard_of(out.reshape(g.shape)).contiguous(), x)

        _rmatvec = _matvec

    return Lap()


def jvec(v):
    return pmt.DistributedArray.to_dist(v)


def tvec(v):
    return pmtt.DistributedArray.to_dist(v, device="cpu")


def jblocks(blocks, dtype=np.float64):
    return pmt.MPIBlockDiag([JM(b.astype(dtype)) for b in blocks])


def tblocks(blocks, dtype=np.float64):
    return pmtt.convert.blockdiag_from_numpy(
        [b.astype(dtype) for b in blocks], device="cpu")


# ------------------------------------------------------------ applies

@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-12),
                                        (np.float32, 1e-5)])
def test_jacobi_apply_and_convert(rng, dtype, rtol):
    mats = varied_spd(rng)
    jop, top = jblocks(mats, dtype), tblocks(mats, dtype)
    jM = jpc.JacobiPrecond.from_operator(jop)
    tM = tpc.JacobiPrecond.from_operator(top)
    close(tM._dinv.numpy(), np.asarray(jM._dinv), rtol)
    assert tM.precond_signature() == jM.precond_signature()
    v = rng.standard_normal(64).astype(dtype)
    V = rng.standard_normal((64, 3)).astype(dtype)
    close(tM.matvec(tvec(v)).asarray(), jM.matvec(jvec(v)).asarray(), rtol)
    close(tM.rmatvec(tvec(V)).asarray(), jM.rmatvec(jvec(V)).asarray(), rtol)
    # the JAX object's arrays carried over, bit for bit
    cM = pmtt.convert.jacobi_from_numpy(np.asarray(jM._dinv), device="cpu")
    np.testing.assert_array_equal(cM._dinv.numpy(), np.asarray(jM._dinv))
    np.testing.assert_array_equal(cM.matvec(tvec(v)).asarray(),
                                  np.asarray(jM.matvec(jvec(v)).asarray()))


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-12),
                                        (np.float32, 1e-5)])
def test_block_jacobi_apply_and_convert(rng, dtype, rtol):
    rect = [rng.standard_normal((10, 8)) + 2 * np.eye(10, 8)
            for _ in range(8)]
    jop, top = jblocks(rect, dtype), tblocks(rect, dtype)
    jM = jpc.BlockJacobiPrecond.from_block_diag(jop, normal=True, damp=0.3)
    tM = tpc.BlockJacobiPrecond.from_block_diag(top, normal=True, damp=0.3)
    close(tM._chol.numpy(), np.asarray(jM._chol), rtol)
    assert tM.precond_signature() == jM.precond_signature()
    # the mod-m probes of the normal operator give the same blocks
    pM = tpc.BlockJacobiPrecond.from_operator(top, 8, normal=True, damp=0.3)
    close(pM._chol.numpy(), tM._chol.numpy(), 10 * rtol)
    v = rng.standard_normal(64).astype(dtype)
    V = rng.standard_normal((64, 4)).astype(dtype)
    close(tM.matvec(tvec(v)).asarray(), jM.matvec(jvec(v)).asarray(), rtol)
    close(tM.matvec(tvec(V)).asarray(), jM.matvec(jvec(V)).asarray(), rtol)
    cM = pmtt.convert.block_jacobi_from_numpy(np.asarray(jM._chol),
                                              device="cpu")
    np.testing.assert_array_equal(cM._chol.numpy(), np.asarray(jM._chol))
    close(cM.matvec(tvec(V)).asarray(), jM.matvec(jvec(V)).asarray(), rtol)
    # square blocks without the normal form, from the whole stack
    sq = np.stack(varied_spd(rng)).astype(dtype)
    jS, tS = jpc.BlockJacobiPrecond(sq), tpc.BlockJacobiPrecond(sq,
                                                                device="cpu")
    close(tS.matvec(tvec(v)).asarray(), jS.matvec(jvec(v)).asarray(), rtol)
    assert tS.precond_signature() == jS.precond_signature()


def test_indefinite_block_is_clamped(rng):
    blocks = np.stack(varied_spd(rng, nblk=4, n=6))
    blocks[2] = -blocks[2]  # negative definite: its Cholesky fails
    jM = jpc.BlockJacobiPrecond(blocks)
    tM = tpc.BlockJacobiPrecond(blocks, device="cpu")
    assert tM.clamped == 1
    assert np.all(np.isfinite(tM._chol.numpy()))
    v = rng.standard_normal(24)
    close(tM.matvec(tvec(v)).asarray(), jM.matvec(jvec(v)).asarray(), 1e-10)


def test_vcycle_apply(rng):
    dims = (8, 8)
    jV = jpc.VCyclePrecond(jax_lap, dims, levels=3)
    tV = tpc.VCyclePrecond(torch_lap, dims, levels=3, device="cpu")
    assert tV.level_dims == jV.level_dims == [(8, 8), (4, 4), (2, 2)]
    assert tV.precond_signature() == jV.precond_signature()
    v = rng.standard_normal(64)
    V = rng.standard_normal((64, 3))
    close(tV.matvec(tvec(v)).asarray(), jV.matvec(jvec(v)).asarray(), 1e-12)
    # K columns in one cycle: each the cycle of its column (the JAX
    # package vmaps the cycle over the columns)
    block = tV.matvec(tvec(V)).asarray()
    for j in range(3):
        close(block[:, j], tV.matvec(tvec(V[:, j])).asarray(), 1e-12)
    t2 = tpc.VCyclePrecond(torch_lap, (8, 4), levels=2, nu_pre=2,
                           nu_post=2, device="cpu")
    j2 = jpc.VCyclePrecond(jax_lap, (8, 4), levels=2, nu_pre=2, nu_post=2)
    close(t2.matvec(tvec(v[:32])).asarray(),
          j2.matvec(jvec(v[:32])).asarray(), 1e-12)


# ------------------------------------------------------------ probing

def test_probe_diagonal_branches(rng):
    mats = varied_spd(rng)
    top = tblocks(mats)
    want = np.concatenate([np.diag(m) for m in mats])
    close(tpc.probe_diagonal(top).numpy(), want, 1e-15)  # diagonal()
    # the lattice on a grid: exact for the 5-point stencil
    lap = torch_lap((6, 5))
    close(tpc.probe_diagonal(lap, dims=(6, 5), device="cpu").numpy(),
          np.full(30, 4.0), 1e-15)
    jd = jpc.probe_diagonal(jax_lap((6, 5)), dims=(6, 5))
    close(tpc.probe_diagonal(lap, dims=(6, 5), device="cpu").numpy(),
          np.asarray(jd), 1e-15)
    # the 1-D lattice of a banded matrix, its diagonal() shadowed
    band = pmtt.MPISparseMatrixMult.from_banded(
        [-1, 0, 2], [rng.standard_normal(19), rng.standard_normal(20),
                     rng.standard_normal(18)], (20, 20), device="cpu")
    dense = band.todense()
    band.diagonal = None
    close(tpc.probe_diagonal(band, stride=4).numpy(), np.diag(dense), 1e-15)
    # the basis fallback, and its refusal above nmax
    A = rng.standard_normal((6, 6))
    small = tblocks([A])
    small.diagonal = None
    close(tpc.probe_diagonal(small, nmax=16).numpy(), np.diag(A), 1e-15)
    with pytest.raises(ValueError, match="nmax"):
        tpc.probe_diagonal(small, nmax=4)


def test_make_precond_and_knobs(rng, monkeypatch):
    top = tblocks(varied_spd(rng))
    assert tpc.make_precond(top, kind="none") is None
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_PRECOND", "jacobi")
    assert isinstance(tpc.make_precond(top), tpc.JacobiPrecond)
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_PRECOND", "block_jacobi")
    assert isinstance(tpc.make_precond(top), tpc.BlockJacobiPrecond)
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_PRECOND", "mg")
    with pytest.raises(ValueError, match="op_factory"):
        tpc.make_precond(top)
    M = tpc.make_precond(top, kind="mg", op_factory=torch_lap, dims=(8, 8),
                         levels=2, device="cpu")
    assert isinstance(M, tpc.VCyclePrecond) and len(M.level_dims) == 2
    with pytest.raises(ValueError, match="kind"):
        tpc.make_precond(top, kind="nope")
    # the JAX package's MG_LEVELS cases, in the port's namespace
    from pylops_mpi_tpu_torch.utils.deps import mg_levels_default
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_MG_LEVELS", "5")
    assert mg_levels_default() == 5
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_MG_LEVELS", "junk")
    assert mg_levels_default() == 3
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_MG_LEVELS", "0")
    assert mg_levels_default() == 1
    monkeypatch.delenv("PYLOPS_MPI_TPU_TORCH_MG_LEVELS")
    V = tpc.VCyclePrecond(torch_lap, (16, 16), device="cpu")
    assert len(V.level_dims) == 3


# ------------------------------------------------------- PCG and PCGLS

SOLVES = ["cg_jacobi", "cg_block", "cg_vcycle", "cgls_jacobi",
          "cgls_normal_block", "cgls_normal_jacobi_damped"]


@pytest.fixture(scope="module")
def pcg_problem():
    """The problems and the JAX solves, once for the module."""
    rng = np.random.default_rng(7)
    mats = varied_spd(rng)
    rect = [rng.standard_normal((10, 8)) * s + 2 * np.eye(10, 8)
            for s in np.logspace(0, 1.5, 8)]
    y = rng.standard_normal(64)
    y10 = rng.standard_normal(80)
    ylap = rng.standard_normal(64)
    jS, jR = jblocks(mats), jblocks(rect)
    out = {}
    out["cg_jacobi"] = (jS, y, "jacobi", None)
    out["cg_block"] = (jS, y, "block", None)
    out["cg_vcycle"] = ("lap", ylap, "vcycle", None)
    out["cgls_jacobi"] = (jR, y10, "jacobi_normal", (False, 0.0))
    out["cgls_normal_block"] = (jR, y10, "block_normal", (True, 0.0))
    out["cgls_normal_jacobi_damped"] = (jR, y10, "jacobi_normal",
                                        (True, 0.5))
    ref = {}
    for key, (jop, yv, kind, ls) in out.items():
        jop = jax_lap((8, 8)) if jop == "lap" else jop
        damp = 0.0 if ls is None else ls[1]
        jM = _precond(jpc, jop, kind, damp)
        if ls is None:
            x, it, cost = pmt.cg(jop, jvec(yv), niter=NITER, tol=0.0, M=jM)
            ref[key] = (np.asarray(x.asarray()), it, np.asarray(cost))
        else:
            x, _, it, _, r2, cost = pmt.cgls(jop, jvec(yv), niter=NITER,
                                             damp=damp, tol=0.0,
                                             normal=ls[0], M=jM)
            ref[key] = (np.asarray(x.asarray()), it, np.asarray(cost))
    return dict(mats=mats, rect=rect, cases=out, ref=ref)


def _precond(mod, op, kind, damp, **kw):
    if kind == "jacobi":
        return mod.JacobiPrecond.from_operator(op)
    if kind == "jacobi_normal":
        # diag(AᴴA) + damp²: the column norms of the blocks
        d = np.concatenate([np.sum(np.asarray(b.A) ** 2, axis=0)
                            for b in op.ops]) + damp ** 2
        return mod.JacobiPrecond(d, **kw)
    if kind == "block":
        return mod.BlockJacobiPrecond.from_block_diag(op)
    if kind == "block_normal":
        return mod.BlockJacobiPrecond.from_block_diag(op, normal=True,
                                                      damp=damp)
    return mod.VCyclePrecond(jax_lap if mod is jpc else torch_lap, (8, 8),
                             levels=2, **kw)


@pytest.mark.parametrize("key", SOLVES)
def test_pcg_pcgls_match_jax(pcg_problem, key):
    jop, yv, kind, ls = pcg_problem["cases"][key]
    if jop == "lap":
        top = torch_lap((8, 8))
    elif jop.shape[0] == 64:
        top = tblocks(pcg_problem["mats"])
    else:
        top = tblocks(pcg_problem["rect"])
    damp = 0.0 if ls is None else ls[1]
    kw = {"device": "cpu"} if kind in ("jacobi_normal", "vcycle") else {}
    tM = _precond(tpc, top, kind, damp, **kw)
    jx, jit, jcost = pcg_problem["ref"][key]
    if ls is None:
        x, it, cost = pmtt.cg(top, tvec(yv), niter=NITER, tol=0.0, M=tM)
    else:
        x, _, it, _, _, cost = pmtt.cgls(top, tvec(yv), niter=NITER,
                                         damp=damp, tol=0.0, normal=ls[0],
                                         M=tM)
    assert it == jit == NITER
    close(x.asarray(), jx, 1e-9)
    close(cost.numpy(), jcost, 1e-9)


def test_pcg_converges_with_relative_tol(pcg_problem):
    """``kold = r·z`` is tested absolutely: a tol relative to the
    preconditioned ``kold₀`` stops the preconditioned solve sooner."""
    mats = pcg_problem["mats"]
    top = tblocks(mats)
    y = pcg_problem["cases"]["cg_jacobi"][1]
    M = tpc.BlockJacobiPrecond.from_block_diag(top)
    z0 = M.matvec(tvec(y)).asarray()
    x, it, _ = pmtt.cg(top, tvec(y), niter=50, tol=1e-20 * float(y @ z0),
                       M=M)
    _, it0, _ = pmtt.cg(top, tvec(y), niter=50, tol=1e-20 * float(y @ y))
    assert it <= 2 < it0  # the exact block inverse: one step
    import scipy.linalg as spla
    close(x.asarray(), np.linalg.solve(spla.block_diag(*mats), y), 1e-9)


class _Identity(pmtt.MPILinearOperator):
    accepts_block = True

    def __init__(self, n):
        super().__init__(shape=(n, n), dtype=torch.float64)

    def _matvec(self, x):
        return x.copy()

    _rmatvec = _matvec


@pytest.mark.parametrize("solver", ["cg", "cgls", "cgls_normal"])
def test_m_none_unchanged(pcg_problem, solver):
    """``M=None`` runs the loop op for op: the same numbers as an
    identity preconditioner (whose ``z`` is a copy of ``r``), bit for
    bit, and the same collectives (none without a group)."""
    from pylops_mpi_tpu_torch.parallel import collectives as co
    mats = pcg_problem["mats"]
    top = tblocks(mats)
    y = tvec(pcg_problem["cases"]["cg_jacobi"][1])
    co.reset_counts()
    if solver == "cg":
        a = pmtt.cg(top, y, niter=NITER, tol=0.0)
        b = pmtt.cg(top, y, niter=NITER, tol=0.0, M=_Identity(64))
        pairs = [(a[0].array, b[0].array), (a[2], b[2])]
    else:
        normal = solver == "cgls_normal"
        a = pmtt.cgls(top, y, niter=NITER, damp=0.2, tol=0.0, normal=normal)
        b = pmtt.cgls(top, y, niter=NITER, damp=0.2, tol=0.0, normal=normal,
                      M=_Identity(64))
        pairs = [(a[0].array, b[0].array), (a[5], b[5]), (a[3], b[3])]
    for u, v in pairs:
        assert torch.equal(u, v)
    assert not co.counts


def test_m_requires_fused_path(pcg_problem):
    top = tblocks(pcg_problem["mats"])
    M = tpc.JacobiPrecond.from_operator(top)
    y = tvec(pcg_problem["cases"]["cg_jacobi"][1])
    for fn in (pmtt.cg, pmtt.cgls):
        with pytest.raises(ValueError, match="fused"):
            fn(top, y, niter=2, show=True, M=M)
        with pytest.raises(ValueError, match="fused"):
            fn(top, y, niter=2, callback=lambda x: None, M=M)
