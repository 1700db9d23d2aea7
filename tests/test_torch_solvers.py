"""The port's cg and cgls held against pmt.cg / pmt.cgls on a system in
the style of bench.py:make_problem (diagonally dominant blocks on the
bf16 grid, a known model, exact data) — the slice's main path, from the
blocks to the solution.

Tolerances: float64 runs compare x, cost, iiter and istop at rtol 1e-9
(relative to the largest entry: the two packages sum in different
orders and 20 iterations amplify that only slightly); float32 runs
compare x at rtol 1e-4.
"""

import numpy as np
import pytest
import torch

import pylops_mpi_tpu as pmt
import pylops_mpi_tpu_torch as pmtt
from pylops_mpi_tpu.ops.local import MatrixMult as JMatrixMult

NBLK = 8


def close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * np.max(np.abs(want)))


def make_problem(rng, m, n, dtype, symmetric=False):
    blocks = []
    for _ in range(NBLK):
        b = rng.standard_normal((m, n)) / np.sqrt(n)
        if symmetric:
            b = 0.5 * (b + b.T)
        b[np.arange(min(m, n)), np.arange(min(m, n))] += 4.0
        b = torch.from_numpy(b).to(torch.bfloat16).double().numpy()
        blocks.append(b.astype(dtype))
    xtrue = rng.standard_normal(NBLK * n).astype(dtype)
    y = np.concatenate([b @ xtrue[i * n:(i + 1) * n]
                        for i, b in enumerate(blocks)])
    return blocks, xtrue, y


def _systems(blocks, y, x0=None):
    jop = pmt.MPIBlockDiag([JMatrixMult(b) for b in blocks])
    top = pmtt.convert.blockdiag_from_numpy(
        [np.asarray(op.A) for op in jop.ops], device="cpu")
    jy = pmt.DistributedArray.to_dist(y)
    ty = pmtt.DistributedArray.to_dist(y, device="cpu")
    jx0 = None if x0 is None else pmt.DistributedArray.to_dist(x0)
    tx0 = None if x0 is None else pmtt.DistributedArray.to_dist(x0,
                                                                device="cpu")
    return (jop, jy, jx0), (top, ty, tx0)


CGLS_CASES = [  # (normal, shape, damp, x0)
    (False, (32, 32), 0.0, False),
    (True, (32, 32), 0.0, False),
    (False, (64, 48), 0.3, True),
    (True, (64, 48), 0.3, True),
]


@pytest.mark.parametrize("normal,shape,damp,x0", CGLS_CASES)
def test_cgls_f64(rng, normal, shape, damp, x0):
    blocks, xtrue, y = make_problem(rng, *shape, np.float64)
    x0v = rng.standard_normal(NBLK * shape[1]) if x0 else None
    (jop, jy, jx0), (top, ty, tx0) = _systems(blocks, y, x0v)
    jout = pmt.cgls(jop, jy, jx0, niter=20, damp=damp, tol=0.0, normal=normal)
    tout = pmtt.cgls(top, ty, tx0, niter=20, damp=damp, tol=0.0, normal=normal)
    jx, jistop, jiiter, jr1, jr2, jcost = jout
    tx, tistop, tiiter, tr1, tr2, tcost = tout
    assert (tiiter, tistop) == (jiiter, jistop) == (20, 2)
    close(tx.asarray(), jx.asarray(), 1e-9)
    # r2 with the cost history: held relative to the initial residual
    close(np.append(tcost.numpy(), tr2.numpy()), np.append(jcost, jr2), 1e-9)
    close(tr1.numpy(), np.asarray(jr1), 1e-6)  # a squared norm near zero
    if damp == 0.0:
        close(tx.asarray(), xtrue, 1e-6)


@pytest.mark.parametrize("normal", [False, True])
def test_cgls_f32(rng, normal):
    blocks, xtrue, y = make_problem(rng, 32, 32, np.float32)
    (jop, jy, _), (top, ty, _) = _systems(blocks, y)
    jx = pmt.cgls(jop, jy, niter=20, tol=0.0, normal=normal)[0]
    tx = pmtt.cgls(top, ty, niter=20, tol=0.0, normal=normal)[0]
    assert tx.dtype == torch.float32
    close(tx.asarray(), jx.asarray(), 1e-4)
    close(tx.asarray(), xtrue, 1e-4)


@pytest.mark.parametrize("normal", [False, True])
def test_cgls_bf16_storage(rng, normal):
    blocks, xtrue, y = make_problem(rng, 32, 32, np.float32)
    top = pmtt.convert.blockdiag_from_numpy(blocks, compute_dtype=torch.bfloat16,
                                            device="cpu")
    ty = pmtt.DistributedArray.to_dist(y, device="cpu")
    x = pmtt.cgls(top, ty, niter=20, tol=0.0, normal=normal)[0]
    assert x.dtype == torch.float32  # vectors never narrowed
    close(x.asarray(), xtrue, 1e-4)  # the bf16 grid holds the blocks exactly


@pytest.mark.parametrize("normal", [False, True])
def test_cgls_early_stop_same_iteration(rng, normal):
    blocks, _, y = make_problem(rng, 32, 32, np.float64)
    (jop, jy, _), (top, ty, _) = _systems(blocks, y)
    # a tolerance the recurrence norm crosses part way through
    kolds = [float(pmt.cgls(jop, jy, niter=k, tol=0.0, normal=normal)[3])
             for k in (4, 5)]
    tol = float(np.sqrt(kolds[0] * kolds[1]))
    jout = pmt.cgls(jop, jy, niter=20, tol=tol, normal=normal)
    tout = pmtt.cgls(top, ty, niter=20, tol=tol, normal=normal)
    assert tout[2] == jout[2] == 5 and tout[1] == jout[1] == 1
    close(tout[0].asarray(), jout[0].asarray(), 1e-9)
    close(tout[5].numpy(), jout[5], 1e-9)


def test_cg_f64(rng):
    blocks, xtrue, y = make_problem(rng, 32, 32, np.float64, symmetric=True)
    (jop, jy, _), (top, ty, _) = _systems(blocks, y)
    jx, jiiter, jcost = pmt.cg(jop, jy, niter=20, tol=0.0)
    tx, tiiter, tcost = pmtt.cg(top, ty, niter=20, tol=0.0)
    assert tiiter == jiiter == 20
    close(tx.asarray(), jx.asarray(), 1e-9)
    close(tcost.numpy(), jcost, 1e-9)
    close(tx.asarray(), xtrue, 1e-6)


def test_cg_early_stop_and_f32(rng):
    blocks, xtrue, y = make_problem(rng, 32, 32, np.float64, symmetric=True)
    (jop, jy, _), (top, ty, _) = _systems(blocks, y)
    tol = 1e-6
    jx, jiiter, jcost = pmt.cg(jop, jy, niter=50, tol=tol)
    tx, tiiter, tcost = pmtt.cg(top, ty, niter=50, tol=tol)
    assert tiiter == jiiter < 50
    close(tcost.numpy(), jcost, 1e-9)
    b32 = [b.astype(np.float32) for b in blocks]
    (jop, jy, _), (top, ty, _) = _systems(b32, y.astype(np.float32))
    close(pmtt.cg(top, ty, niter=20, tol=0.0)[0].asarray(),
          pmt.cg(jop, jy, niter=20, tol=0.0)[0].asarray(), 1e-4)
