"""The port's post-stack pipeline held against the JAX package's
(``models/poststack.py``) at the settings of examples/poststack.py:
``(nx, nt0) = (16, 128)``, a 10-sample Ricker wavelet at 25 Hz, the
layered impedance model, float64.

Tolerances, relative to the largest entry of the reference:
- ``Conv1D`` and the modelling operator: rtol 1e-12 (the port runs one
  ``conv1d``, the JAX package a patch product: summation order only);
- ``poststack_inversion(epsR=1e-2)`` (Laplacian-regularized) and the
  Gradient-regularized solve: rtol 1e-9 (agreement reached: ~1e-15 and
  ~1e-13);
- ``poststack_inversion(epsR=None)``: rtol 1e-9 after 20 iterations
  (agreement reached: 6e-14), rtol 1e-3 after 100 (reached: 1.7e-4 on
  the model, 3.4e-4 on the data it predicts). Without regularization
  ``W·D`` is near-singular (the JAX module's comment: cond ~ 1e17): the
  two trajectories agree to 1e-13 up to iteration 20 and then CGLS's
  loss of conjugacy amplifies the last-bit differences of the two
  convolutions' summation orders to 3e-4 by iteration 40, where they
  stay. Both runs take the same number of iterations.
"""

import numpy as np
import pytest
import torch

import pylops_mpi_tpu as pmt
import pylops_mpi_tpu_torch as pmtt
from pylops_mpi_tpu.models import poststack as jp
from pylops_mpi_tpu.ops import local as jlocal
from pylops_mpi_tpu_torch.models import poststack as tp
from pylops_mpi_tpu_torch.ops import local as tlocal

NX, NT0 = 16, 128


def close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * np.max(np.abs(want)))


@pytest.fixture(scope="module")
def problem():
    """examples/poststack.py: wavelet, layered model, modelled data."""
    rng = np.random.default_rng(7)
    wav, _ = jp.ricker(np.arange(0, 0.02, 0.002), f0=25)
    m = np.cumsum(rng.standard_normal((NX, NT0)) * 0.03, axis=1) + 2.0
    jOp = jp.MPIPoststackLinearModelling(wav, NT0, NX)
    d = jOp.matvec(pmt.DistributedArray.to_dist(
        m.ravel(), local_shapes=jOp.local_shapes_m)).asarray()
    return wav, m, d.reshape(NX, NT0), jOp


def test_ricker():
    t = np.arange(0, 0.02, 0.002)
    for a, b in zip(tp.ricker(t, f0=25), jp.ricker(t, f0=25)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("nh,offset", [(7, 3), (7, 0), (7, 6), (6, 2)])
@pytest.mark.parametrize("axis", [0, 1])
def test_conv1d(rng, nh, offset, axis):
    dims = (11, 9)
    h = rng.standard_normal(nh)
    jop = jlocal.Conv1D(dims, h, axis=axis, offset=offset)
    top = tlocal.Conv1D(dims, h, axis=axis, offset=offset, device="cpu")
    x = rng.standard_normal(99)
    close(top.matvec(torch.from_numpy(x)).numpy(), jop.matvec(x), 1e-12)
    close(top.rmatvec(torch.from_numpy(x)).numpy(), jop.rmatvec(x), 1e-12)


def test_modelling_operator(rng, problem):
    wav, m, d, jOp = problem
    tOp = tp.MPIPoststackLinearModelling(wav, NT0, NX, device="cpu")
    assert tOp.shape == jOp.shape
    dt = tOp.matvec(pmtt.DistributedArray.to_dist(m.ravel(), device="cpu"))
    close(dt.asarray(), d.ravel(), 1e-12)
    v = rng.standard_normal(NX * NT0)
    close(tOp.rmatvec(pmtt.DistributedArray.to_dist(v, device="cpu"))
          .asarray(), jOp.rmatvec(pmt.DistributedArray.to_dist(
              v, local_shapes=jOp.local_shapes_n)).asarray(), 1e-12)
    assert pmtt.dottest(tOp, rtol=1e-10, device="cpu")


@pytest.mark.parametrize("epsR,niter,rtol", [(None, 20, 1e-9),
                                              (None, 100, 1e-3),
                                              (1e-2, 100, 1e-9)])
def test_poststack_inversion(problem, epsR, niter, rtol):
    wav, m, d, jOp = problem
    xj, _ = jp.poststack_inversion(d, wav, niter=niter, epsR=epsR,
                                   damp=1e-3)
    xt, tOp = tp.poststack_inversion(d, wav, niter=niter, epsR=epsR,
                                     damp=1e-3, device="cpu")
    assert isinstance(xt, np.ndarray) and xt.shape == (NX, NT0)
    close(xt, xj, rtol)
    # the data each model predicts
    pj = jOp.matvec(pmt.DistributedArray.to_dist(
        xj.ravel(), local_shapes=jOp.local_shapes_m)).asarray()
    pt = tOp.matvec(pmtt.DistributedArray.to_dist(
        xt.ravel(), device="cpu")).asarray()
    close(pt, pj, rtol)
    # a tensor d stays on its device
    xt2, _ = tp.poststack_inversion(torch.from_numpy(d), wav, niter=niter,
                                    epsR=epsR, damp=1e-3)
    np.testing.assert_array_equal(xt2, xt)


def test_gradient_regularized_solve(problem):
    """The slice's main path: CGLS on [Op; εR·∇] m = [d; 0]."""
    wav, m, d, jOp = problem
    eps = 0.1
    jG = pmt.MPIGradient((NX, NT0))
    jS = pmt.MPIStackedVStack([jOp, eps * jG])
    jx0 = pmt.DistributedArray.to_dist(np.zeros(NX * NT0),
                                       local_shapes=jOp.local_shapes_m)
    jy = pmt.StackedDistributedArray([
        pmt.DistributedArray.to_dist(d.ravel(),
                                     local_shapes=jOp.local_shapes_n),
        jG.matvec(jx0)])
    tOp = tp.MPIPoststackLinearModelling(wav, NT0, NX, device="cpu")
    tS = pmtt.MPIStackedVStack([tOp, eps * pmtt.MPIGradient((NX, NT0))])
    ty = pmtt.convert.stacked_from_numpy(
        [d.ravel(), [np.zeros(NX * NT0)] * 2], device="cpu")
    jout = pmt.cgls(jS, jy, jx0, niter=50, damp=1e-4, tol=0.0)
    tout = pmtt.cgls(tS, ty, niter=50, damp=1e-4, tol=0.0)
    assert tout[2] == jout[2] == 50
    close(tout[0].asarray(), jout[0].asarray(), 1e-9)
    close(tout[5].numpy(), jout[5], 1e-9)
    cost = tout[5].numpy()
    assert np.all(np.diff(cost) <= 1e-12 * cost[0])  # CGLS: non-increasing
