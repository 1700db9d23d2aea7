"""The port's StackedDistributedArray, MPIStackedVStack and CGLS on a
stacked (regularized) system, held against the JAX package: the same
numpy components through both.

Tolerances: float64 throughout. Vector algebra, dots and norms at rtol
1e-12 (summation order only). The Gradient-regularized CGLS of
tests/test_solver.py:301-332 at rtol 1e-9 on x and the cost history,
relative to their largest entries (20 iterations amplify the
summation-order differences only slightly), with the same iteration
count.
"""

import numpy as np
import pytest
import torch

import pylops_mpi_tpu as pmt
import pylops_mpi_tpu_torch as pmtt
from pylops_mpi_tpu.ops.local import MatrixMult as JMatrixMult

RTOL = 1e-12


def close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * np.max(np.abs(want)))


def _comps(rng, cmplx=False):
    """Numpy components of a nested stack: [a, [b, c]]."""
    def v(n):
        x = rng.standard_normal(n)
        return x + 1j * rng.standard_normal(n) if cmplx else x
    return [v(7), [v(5), v(9)]]


def _jax(comps):
    return pmt.StackedDistributedArray([
        _jax(c) if isinstance(c, list) else pmt.DistributedArray.to_dist(c)
        for c in comps])


def _pair(comps):
    return _jax(comps), pmtt.convert.stacked_from_numpy(comps, device="cpu")


@pytest.mark.parametrize("cmplx", [False, True])
def test_arithmetic(rng, cmplx):
    ja, ta = _pair(_comps(rng, cmplx))
    jb, tb = _pair(_comps(rng, cmplx))
    assert ta.size == ja.size == 21 and ta.narrays == 2
    assert isinstance(ta[1], pmtt.StackedDistributedArray)
    cases = [(ja + jb, ta + tb), (ja - jb, ta - tb), (ja * jb, ta * tb),
             (-ja, -ta), (ja * 2.5, ta * 2.5), (2.5 * ja, 2.5 * ta),
             (ja.conj(), ta.conj()), (ja.copy(), ta.copy()),
             (ja.zeros_like(), ta.zeros_like()),
             (ja.empty_like(), ta.empty_like())]
    for j, t in cases:
        close(t.asarray(), j.asarray())
    t2, j2 = ta.copy(), ja.copy()
    t2 += tb
    t2 -= tb * 0.5
    j2 += jb
    j2 -= jb * 0.5
    close(t2.asarray(), j2.asarray())
    close(ta.asarray(), ja.asarray())  # the copy left the original alone
    with pytest.raises(ValueError, match="Stacked size mismatch"):
        ta + pmtt.StackedDistributedArray([ta[0]])


@pytest.mark.parametrize("vdot", [False, True])
@pytest.mark.parametrize("cmplx", [False, True])
def test_dot(rng, cmplx, vdot):
    ja, ta = _pair(_comps(rng, cmplx))
    jb, tb = _pair(_comps(rng, cmplx))
    got = ta.dot(tb, vdot=vdot)
    assert got.ndim == 0 and got.device.type == "cpu"
    close(got.numpy(), np.asarray(ja.dot(jb, vdot=vdot)))


@pytest.mark.parametrize("ord", [None, 1, 2, np.inf, -np.inf, 0])
def test_norm(rng, ord):
    comps = _comps(rng)
    comps[1][0][2] = 0.0
    ja, ta = _pair(comps)
    got = ta.norm(ord)
    assert got.ndim == 0
    close(got.numpy(), np.asarray(ja.norm(ord)))


def test_dtype_device_and_shape(rng):
    _, ta = _pair(_comps(rng))
    assert ta.dtype == torch.float64 and ta.device.type == "cpu"
    assert ta.global_shape == (21,)
    mixed = pmtt.StackedDistributedArray([
        pmtt.DistributedArray.to_dist(np.ones(3, np.float32), device="cpu"),
        pmtt.DistributedArray.to_dist(np.ones((2, 2)), device="cpu")])
    assert mixed.dtype == torch.float64
    with pytest.raises(ValueError, match="equal-rank"):
        mixed.global_shape


def _blockdiag(rng):
    mats = []
    for _ in range(8):
        a = rng.standard_normal((4, 4))
        mats.append(a @ a.T + 4 * np.eye(4))
    jop = pmt.MPIBlockDiag([JMatrixMult(m, dtype=np.float64) for m in mats])
    top = pmtt.convert.blockdiag_from_numpy(mats, device="cpu")
    return jop, top


def test_stacked_vstack(rng):
    jb, tb = _blockdiag(rng)
    jS = pmt.MPIStackedVStack([jb, 0.5 * pmt.MPIGradient((32,))])
    tS = pmtt.MPIStackedVStack([tb, 0.5 * pmtt.MPIGradient((32,))])
    assert tS.shape == jS.shape == (64, 32)
    x = rng.standard_normal(32)
    jy = jS.matvec(pmt.DistributedArray.to_dist(x))
    ty = tS.matvec(pmtt.DistributedArray.to_dist(x, device="cpu"))
    assert isinstance(ty, pmtt.StackedDistributedArray)
    assert isinstance(ty[1], pmtt.StackedDistributedArray)  # the gradient's
    close(ty.asarray(), jy.asarray())
    v = [rng.standard_normal(32), [rng.standard_normal(32)]]
    close(tS.rmatvec(pmtt.convert.stacked_from_numpy(v, device="cpu"))
          .asarray(), jS.rmatvec(_jax(v)).asarray())
    close((tS @ pmtt.DistributedArray.to_dist(x, device="cpu")).asarray(),
          jy.asarray())
    assert pmtt.dottest(tS, rtol=1e-10, device="cpu")
    # the adjoint has a stacked model space: dottest with an explicit u
    u = pmtt.convert.stacked_from_numpy(
        [rng.standard_normal(32), [rng.standard_normal(32)]], device="cpu")
    assert pmtt.dottest(tS.H, u=u, rtol=1e-10, device="cpu")
    with pytest.raises(ValueError, match="both operands"):
        tS @ pmtt.MPIStackedVStack([tb])
    with pytest.raises(ValueError, match="column size"):
        pmtt.MPIStackedVStack([tb, pmtt.MPIGradient((16,))])
    with pytest.raises(ValueError, match="dimension mismatch"):
        tS.rmatvec(pmtt.convert.stacked_from_numpy([np.ones(3)],
                                                   device="cpu"))


@pytest.mark.parametrize("x0,damp", [(False, 0.0), (True, 0.3)])
@pytest.mark.parametrize("normal", [False, True])
def test_cgls_gradient_regularized(rng, x0, damp, normal):
    """tests/test_solver.py:301-332's system, CGLS in both packages."""
    n = 32
    jb, tb = _blockdiag(rng)
    jG, tG = pmt.MPIGradient((n,)), pmtt.MPIGradient((n,))
    jS = pmt.MPIStackedVStack([jb, 0.5 * jG])
    tS = pmtt.MPIStackedVStack([tb, 0.5 * tG])
    xtrue = rng.standard_normal(n)
    ytop = jb.matvec(pmt.DistributedArray.to_dist(xtrue)).asarray()
    x0v = rng.standard_normal(n) if x0 else np.zeros(n)
    jx0 = pmt.DistributedArray.to_dist(x0v)
    jy = pmt.StackedDistributedArray([pmt.DistributedArray.to_dist(ytop),
                                      jG.matvec(jx0.zeros_like())])
    ty = pmtt.convert.stacked_from_numpy([ytop, [np.zeros(n)]], device="cpu")
    # the port builds the default zero model from the operator
    tx0 = pmtt.DistributedArray.to_dist(x0v, device="cpu") if x0 else None
    jout = pmt.cgls(jS, jy, jx0, niter=20, damp=damp, tol=0.0,
                    normal=normal)
    tout = pmtt.cgls(tS, ty, tx0, niter=20, damp=damp, tol=0.0,
                     normal=normal)
    assert tout[2] == jout[2] == 20 and tout[1] == jout[1]
    assert tout[0].dtype == torch.float64
    close(tout[0].asarray(), jout[0].asarray(), 1e-9)
    close(tout[5].numpy(), jout[5], 1e-9)


def test_cgls_default_model_follows_operator():
    G = pmtt.MPIGradient((6, 4), dtype=torch.float32)
    y = pmtt.convert.stacked_from_numpy([np.ones(24, np.float32)] * 2,
                                        device="cpu")
    x = pmtt.cgls(G, y, niter=2, tol=0.0)[0]
    assert x.global_shape == (24,) and x.dtype == torch.float32
    assert x.device.type == "cpu"
