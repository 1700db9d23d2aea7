"""The port's power_iteration held against pmt.power_iteration: the same
operator blocks (numpy, from a seed) through both packages, the same
seeded start draws.

Tolerances: float64 throughout. The eigenvalue at rtol 1e-10 and the
iteration count equal (both packages draw the start vector with numpy
from the same seed, so only summation order differs); the last iterate
at rtol 1e-9 of its largest entry. The port's fused and host-synced
loops agree with each other to the last bit of the eigenvalue.
"""

import gc

import numpy as np
import pytest
import torch

import pylops_mpi_tpu as pmt
import pylops_mpi_tpu_torch as pmtt
from pylops_mpi_tpu.ops.local import MatrixMult as JMatrixMult
from pylops_mpi_tpu.solvers.eigs import power_iteration as jpower
from pylops_mpi_tpu_torch.ops.local import MatrixMult as TMatrixMult
from pylops_mpi_tpu_torch.solvers import sparsity as tsparsity

RTOL = 1e-9


def close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * np.max(np.abs(want)))


def _blocks(rng, nblk, m, n, cmplx=False, hermitian=True):
    out = []
    for _ in range(nblk):
        a = rng.standard_normal((m, n))
        if cmplx:
            a = a + 1j * rng.standard_normal((m, n))
        out.append(a @ a.conj().T if hermitian else a)
    return out


def _ops(blocks):
    jop = pmt.MPIBlockDiag([JMatrixMult(b, dtype=b.dtype) for b in blocks])
    top = pmtt.MPIBlockDiag([TMatrixMult(b, device="cpu") for b in blocks])
    return jop, top


@pytest.mark.parametrize("cmplx", [False, True])
@pytest.mark.parametrize("niter,tol", [(200, 1e-12), (9, 1e-12), (17, 0.0),
                                       (300, 1e-7)])
def test_power_iteration(rng, cmplx, niter, tol):
    """Real and complex Hermitian blocks; an early stop (tol 1e-7) and
    runs of the full count that end on and off the host check."""
    blocks = _blocks(rng, 8, 6, 6, cmplx)
    jop, top = _ops(blocks)
    dt = np.complex128 if cmplx else np.float64
    jb = pmt.DistributedArray(global_shape=48, dtype=dt)
    tb = pmtt.DistributedArray(global_shape=48, dtype=dt, device="cpu")
    jl, jv, jit = jpower(jop, jb, niter=niter, tol=tol, dtype=dt)
    eigs = []
    for fused in (True, False):
        tl, tv, tit = pmtt.power_iteration(top, tb, niter=niter, tol=tol,
                                           dtype=dt, fused=fused)
        assert tit == jit
        if tol == 1e-7:
            assert tit < niter
        assert type(tl) is type(jl)
        np.testing.assert_allclose(tl, jl, rtol=1e-10)
        close(tv.asarray(), jv.asarray())
        eigs.append(tl)
    assert eigs[0] == eigs[1]


def test_power_iteration_normal_operator(rng):
    """λmax(AᴴA) of a composed operator, as ISTA's step size asks it,
    against the dense SVD and the JAX package."""
    blocks = _blocks(rng, 8, 7, 5, hermitian=False)
    jop, top = _ops(blocks)
    jb = pmt.DistributedArray(global_shape=40, dtype=np.float64)
    tb = pmtt.DistributedArray(global_shape=40, dtype=torch.float64,
                               device="cpu")
    jl, _, jit = jpower(jop.H @ jop, jb, niter=500, tol=1e-13)
    tl, _, tit = pmtt.power_iteration(top.H @ top, tb, niter=500, tol=1e-13)
    assert tit == jit
    np.testing.assert_allclose(tl, jl, rtol=1e-10)
    smax = max(np.linalg.svd(b, compute_uv=False)[0] for b in blocks)
    np.testing.assert_allclose(tl, smax ** 2, rtol=1e-8)


def test_power_iteration_stacked(rng):
    """A stacked template: V Vᴴ on the data space of a VStack. Each
    component gets its own draws, in the JAX package's stream order.
    The JAX package's fused loop cannot take a stacked vector (its
    ``StackedDistributedArray`` has no ``dtype``), so its host-synced
    loop is the reference here; the port runs both of its loops."""
    b1, b2 = _blocks(rng, 8, 4, 3, hermitian=False), \
        _blocks(rng, 8, 2, 3, hermitian=False)
    (j1, t1), (j2, t2) = _ops(b1), _ops(b2)
    jV, tV = pmt.MPIStackedVStack([j1, j2]), pmtt.MPIStackedVStack([t1, t2])
    jb = pmt.StackedDistributedArray(
        [pmt.DistributedArray(global_shape=32, dtype=np.float64),
         pmt.DistributedArray(global_shape=16, dtype=np.float64)])
    tb = pmtt.convert.stacked_from_numpy([np.zeros(32), np.zeros(16)],
                                         device="cpu")
    jl, jv, jit = jpower(jV @ jV.H, jb, niter=40, tol=0.0, fused=False)
    for fused in (True, False):
        tl, tv, tit = pmtt.power_iteration(tV @ tV.H, tb, niter=40, tol=0.0,
                                           fused=fused)
        assert tit == jit == 40
        np.testing.assert_allclose(tl, jl, rtol=1e-10)
        close(tv.asarray(), jv.asarray())


def test_step_size_cache_is_weak(rng):
    """ISTA's λmax is computed once per operator object and forgotten
    with it (a weak key, not an id() that a new object can reuse)."""
    _, top = _ops(_blocks(rng, 8, 5, 4, hermitian=False))
    x0 = pmtt.DistributedArray(global_shape=32, dtype=torch.float64,
                               device="cpu")
    a1 = tsparsity._cached_step_size(top, x0, None)
    assert tsparsity._cached_step_size(top, x0, None) == a1
    assert top in tsparsity._ALPHA_CACHE
    n = len(tsparsity._ALPHA_CACHE)
    del top
    gc.collect()
    assert len(tsparsity._ALPHA_CACHE) == n - 1
