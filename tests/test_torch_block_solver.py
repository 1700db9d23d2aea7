"""The port's block CG/CGLS held against the JAX package: K columns
through one loop on the same numbers (plain, damped from an ``x0``,
preconditioned, bf16 storage, ragged blocks), columns freezing on their
own, K=1 equal bit for bit to ``cg``/``cgls``, an operator without
block support, the refusals and the names ported since
(``batched_solve``).

Tolerances: f64 rtol 1e-9 (relative to the largest entry) over 15
iterations; bf16 storage at the JAX package's own tolerance for it
(atol 5e-2). The JAX references are computed once per module.
"""

import os

import numpy as np
import pytest
import torch

import pylops_mpi_tpu as pmt
import pylops_mpi_tpu_torch as pmtt
from pylops_mpi_tpu.ops import precond as jpc
from pylops_mpi_tpu.ops.local import MatrixMult as JM
from pylops_mpi_tpu.solvers import block as jblock
from pylops_mpi_tpu_torch.ops import precond as tpc

NITER = 15
K = 3


def close(got, want, rtol, atol=None):
    want = np.asarray(want)
    got = np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(
        got, want, rtol=rtol,
        atol=rtol * np.max(np.abs(want)) if atol is None else atol)


def spd_blocks(rng, nblk=8, n=8):
    out = []
    for _ in range(nblk):
        m = rng.standard_normal((n, n))
        out.append(np.eye(n) * 4 + 0.3 * (m + m.T))
    return out


def rect_blocks(rng, nblk=8, m=10, n=8):
    return [rng.standard_normal((m, n)) / np.sqrt(n) + 2 * np.eye(m, n)
            for _ in range(nblk)]


def jbd(blocks, **kw):
    return pmt.MPIBlockDiag([JM(b) for b in blocks], **kw)


def tbd(blocks, **kw):
    return pmtt.convert.blockdiag_from_numpy(blocks, device="cpu", **kw)


def jarr(v):
    return pmt.DistributedArray.to_dist(v)


def tarr(v):
    return pmtt.DistributedArray.to_dist(v, device="cpu")


CASES = {  # name: (solver, blocks, damp, x0, precond, compute_dtype)
    "cg": ("cg", "spd", 0.0, False, None, None),
    "cg_x0_block_jacobi": ("cg", "spd", 0.0, True, "block", None),
    "cgls": ("cgls", "rect", 0.0, False, None, None),
    "cgls_damped_x0": ("cgls", "rect", 0.4, True, None, None),
    "cgls_jacobi": ("cgls", "rect", 0.2, False, "jacobi", None),
    "cgls_ragged": ("cgls", "ragged", 0.0, False, None, None),
    "cgls_bf16": ("cgls", "rect", 0.05, False, None, "bf16"),
}


def _precond(mod, op, kind, damp, blocks):
    if kind == "block":
        return mod.BlockJacobiPrecond.from_block_diag(op)
    d = np.concatenate([np.sum(b ** 2, axis=0) for b in blocks]) + damp ** 2
    return mod.JacobiPrecond(d) if mod is jpc else mod.JacobiPrecond(
        d, device="cpu")


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(11)
    data = {"spd": spd_blocks(rng), "rect": rect_blocks(rng),
            "ragged": rect_blocks(rng, nblk=6)}
    Y = {k: rng.standard_normal((sum(b.shape[0] for b in v), K))
         for k, v in data.items()}
    X0 = {k: rng.standard_normal((sum(b.shape[1] for b in v), K))
          for k, v in data.items()}
    ref = {}
    for name, (solver, key, damp, x0, pk, cdt) in CASES.items():
        kw = {"compute_dtype": np.dtype("bfloat16")} if cdt else {}
        blocks = [b.astype(np.float32) for b in data[key]] if cdt \
            else data[key]
        jop = jbd(blocks, **kw)
        y = Y[key].astype(blocks[0].dtype)
        jx0 = jarr(X0[key].astype(y.dtype)) if x0 else None
        jM = _precond(jpc, jop, pk, damp, blocks) if pk else None
        if solver == "cg":
            x, it, cost = jblock.block_cg(jop, jarr(y), jx0, niter=NITER,
                                          tol=0.0, M=jM)
            ref[name] = (np.asarray(x.asarray()), it, np.asarray(cost))
        else:
            x, istop, it, kold, r2, cost = jblock.block_cgls(
                jop, jarr(y), jx0, niter=NITER, damp=damp, tol=0.0, M=jM)
            ref[name] = (np.asarray(x.asarray()), it, np.asarray(cost),
                         np.asarray(istop), np.asarray(kold),
                         np.asarray(r2))
    return dict(data=data, Y=Y, X0=X0, ref=ref)


@pytest.mark.parametrize("name", list(CASES))
def test_block_matches_jax(problem, name):
    solver, key, damp, x0, pk, cdt = CASES[name]
    blocks = problem["data"][key]
    kw = {}
    if cdt:
        blocks = [b.astype(np.float32) for b in blocks]
        kw = {"compute_dtype": torch.bfloat16}
    top = tbd(blocks, **kw)
    y = problem["Y"][key].astype(blocks[0].dtype)
    tx0 = tarr(problem["X0"][key].astype(y.dtype)) if x0 else None
    tM = _precond(tpc, top, pk, damp, blocks) if pk else None
    ref = problem["ref"][name]
    rtol, atol = (1e-9, None) if not cdt else (0, 5e-2)
    if solver == "cg":
        x, it, cost = pmtt.block_cg(top, tarr(y), tx0, niter=NITER, tol=0.0,
                                    M=tM)
    else:
        x, istop, it, kold, r2, cost = pmtt.block_cgls(
            top, tarr(y), tx0, niter=NITER, damp=damp, tol=0.0, M=tM)
        np.testing.assert_array_equal(istop.numpy(), ref[3])
        assert kold.shape == r2.shape == (K,)
        if not cdt:
            close(r2.numpy(), ref[5], 1e-9)
    assert it == ref[1] == NITER
    assert tuple(cost.shape) == (NITER + 1, K)
    close(x.asarray(), ref[0], rtol, atol)
    close(cost.numpy(), ref[2], 1e-9 if not cdt else 1e-2)


def test_columns_freeze_independently(problem):
    """Columns of different difficulty cross ``tol`` at different
    iterations; each holds the iterate its own single-RHS solve stops
    at."""
    blocks = problem["data"]["spd"]
    top = tbd(blocks)
    Y = problem["Y"]["spd"] * np.array([1.0, 1e-3, 1e3])
    tol = 1e-8
    x, it, cost = pmtt.block_cg(top, tarr(Y), niter=40, tol=tol)
    iters = []
    for j in range(K):
        xj, itj, cj = pmtt.cg(top, tarr(Y[:, j]), niter=40, tol=tol)
        iters.append(itj)
        close(x.asarray()[:, j], xj.asarray(), 1e-10)
        close(cost.numpy()[:itj + 1, j], cj.numpy(), 1e-10)
        # after its freeze the column's history stays put
        assert np.all(cost.numpy()[itj:, j] == cost.numpy()[itj, j])
    assert len(set(iters)) > 1 and it == max(iters)


def test_k1_is_cg_and_cgls_bitwise(problem):
    blocks = problem["data"]["spd"]
    top = tbd(blocks)
    y = problem["Y"]["spd"][:, :1]
    M = tpc.BlockJacobiPrecond.from_block_diag(top)
    x, it, cost = pmtt.block_cg(top, tarr(y), niter=NITER, tol=1e-9, M=M)
    x1, it1, cost1 = pmtt.cg(top, tarr(y[:, 0]), niter=NITER, tol=1e-9, M=M)
    assert it == it1 and x.global_shape == (64, 1)
    assert torch.equal(x.array[:, 0], x1.array)
    assert torch.equal(cost[:, 0], cost1)
    rect = problem["data"]["rect"]
    tr = tbd(rect)
    y = problem["Y"]["rect"][:, :1]
    out = pmtt.block_cgls(tr, tarr(y), niter=NITER, damp=0.3, tol=0.0)
    one = pmtt.cgls(tr, tarr(y[:, 0]), niter=NITER, damp=0.3, tol=0.0)
    assert torch.equal(out[0].array[:, 0], one[0].array)
    assert out[2] == one[2]
    assert torch.equal(out[3], one[3].reshape(1))
    assert torch.equal(out[4], one[4].reshape(1))
    assert torch.equal(out[5][:, 0], one[5])
    assert out[1].tolist() == [one[1]]


class _NoBlock(pmtt.MPILinearOperator):
    """A square operator that takes 1-D vectors only."""

    def __init__(self, A):
        self.A = torch.from_numpy(A)
        super().__init__(shape=A.shape, dtype=torch.float64)

    def _matvec(self, x):
        assert x.ndim == 1
        return pmtt.DistributedArray._wrap(self.A @ x.array, x)

    def _rmatvec(self, x):
        assert x.ndim == 1
        return pmtt.DistributedArray._wrap(self.A.T @ x.array, x)


def test_operator_without_block_support(problem):
    import scipy.linalg as spla
    A = spla.block_diag(*problem["data"]["spd"])
    Op = _NoBlock(A)
    Y = problem["Y"]["spd"]
    x, it, _ = pmtt.block_cg(Op, tarr(Y), niter=NITER, tol=0.0)
    for j in range(K):
        xj = pmtt.cg(Op, tarr(Y[:, j]), niter=NITER, tol=0.0)[0]
        close(x.asarray()[:, j], xj.asarray(), 1e-10)


def test_refusals_and_waiting_names(problem):
    top = tbd(problem["data"]["spd"])
    y1 = tarr(problem["Y"]["spd"][:, 0])
    for fn in (pmtt.block_cg, pmtt.block_cgls):
        with pytest.raises(ValueError, match="2-D"):
            fn(top, y1)
        with pytest.raises(ValueError, match="guards="):
            fn(top, tarr(problem["Y"]["spd"]), guards="on")
        # guards run on the communication-avoiding engine: one verdict
        # a column, x the unguarded engine's bit for bit
        os.environ["PYLOPS_MPI_TPU_TORCH_CA"] = "pipelined"
        try:
            Y = tarr(problem["Y"]["spd"])
            xg = fn(top, Y, niter=3, tol=0.0, guards=True)[0]
            xu = fn(top, Y, niter=3, tol=0.0, guards=False)[0]
            assert torch.equal(xg.array, xu.array)
            from pylops_mpi_tpu_torch.resilience import status as tstatus
            assert tstatus.last_status(fn.__name__)["column_names"] == \
                ["maxiter"] * Y.global_shape[1]
        finally:
            os.environ.pop("PYLOPS_MPI_TPU_TORCH_CA")
    with pytest.raises(ValueError, match="rows"):
        pmtt.block_cg(top, tarr(np.zeros((10, 2))))
    # the names that waited for §A.7 item 2 are ported: batched_solve
    # refuses a family without parameters as the JAX package does
    # (tests/test_torch_batched_solve.py holds it against the JAX one)
    from pylops_mpi_tpu_torch import solvers
    assert solvers.BatchedResult._fields == ("xs", "iiter", "cost", "cost1",
                                             "kold")
    assert set(solvers.batched_cache_info()) == {"size", "max", "families"}
    with pytest.raises(ValueError, match="no parameter tensors"):
        solvers.batched_solve(
            lambda p: pmtt.MPIFirstDerivative(10, dtype=torch.float64),
            [0, 1], [y1, y1])
