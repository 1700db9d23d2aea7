"""The port's MPIMDC and the MDD pipeline (models.mdd,
models.kernel_to_frequency) held against the JAX package: the same
numpy kernel and data through both.

Tolerances: float64 throughout. MDC forward and adjoint at rtol 1e-12
of the largest entry (FFTs and GEMMs summed in different orders;
nothing iterates). ``examples/mdd.py`` end to end: the inverted model at
rtol 1e-9 of its largest entry against the JAX package's and within
1e-6 of the true model; in float32 (a complex64 kernel) within 1e-3.
"""

import numpy as np
import pytest
import torch

import pylops_mpi_tpu as pmt
import pylops_mpi_tpu_torch as pmtt
from pylops_mpi_tpu.models import (kernel_to_frequency as jk2f,
                                   mdd as jmdd)
from pylops_mpi_tpu_torch.models import kernel_to_frequency, mdd

RTOL = 1e-12


def close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * np.max(np.abs(want)))


def _kernel(rng, ns, nr, nt):
    """examples/mdd.py's decaying random time-domain kernel."""
    return rng.standard_normal((ns, nr, nt)) * np.exp(
        -0.2 * np.arange(nt))[None, None, :]


def _bcast(x):
    return (pmt.DistributedArray.to_dist(x, partition=pmt.Partition.BROADCAST),
            pmtt.DistributedArray.to_dist(
                x, partition=pmtt.Partition.BROADCAST, device="cpu"))


MDC_CASES = [  # (nt, nv, nfreq, twosided, conj, prescaled, dt, dr)
    (17, 1, None, True, False, False, 1.0, 1.0),
    (17, 3, 6, True, True, False, 0.004, 10.0),
    (16, 2, None, False, False, False, 1.0, 1.0),
    (21, 2, 7, False, True, True, 0.5, 2.0),
]


@pytest.mark.parametrize("nt,nv,nfreq,twosided,conj,prescaled,dt,dr",
                         MDC_CASES)
def test_mdc_matches_jax(rng, nt, nv, nfreq, twosided, conj, prescaled, dt,
                         dr):
    """Forward and adjoint against the JAX package, the dot test, and a
    real operator dtype (model and data stay real through the chain)."""
    ns, nr = 5, 4
    G = kernel_to_frequency(_kernel(rng, ns, nr, nt), nfmax=9)
    kw = dict(nt=nt, nv=nv, nfreq=nfreq, dt=dt, dr=dr, twosided=twosided,
              conj=conj, prescaled=prescaled)
    jop = pmt.MPIMDC(G, **kw)
    top = pmtt.convert.mdc_from_numpy(G, device="cpu", **kw)
    assert top.shape == jop.shape == (nt * ns * nv, nt * nr * nv)
    assert top.dtype == torch.float64
    (jx, tx), (jy, ty) = _bcast(rng.standard_normal(top.shape[1])), \
        _bcast(rng.standard_normal(top.shape[0]))
    fwd = top.matvec(tx)
    assert fwd.dtype == torch.float64
    close(fwd.asarray(), jop.matvec(jx).asarray())
    adj = top.rmatvec(ty)
    assert adj.dtype == torch.float64
    close(adj.asarray(), jop.rmatvec(jy).asarray())
    assert pmtt.dottest(top, tx, ty, rtol=1e-12)


def test_mdc_narrow_kernel(rng):
    """compute_dtype=complex64 narrows the stored kernel; the chain
    stays complex128/float64 and agrees with the JAX package."""
    nt, nv = 15, 2
    G = kernel_to_frequency(_kernel(rng, 4, 3, nt))
    jop = pmt.MPIMDC(G, nt=nt, nv=nv, compute_dtype=np.complex64)
    top = pmtt.MPIMDC(G, nt=nt, nv=nv, compute_dtype=torch.complex64,
                      device="cpu")
    jx, tx = _bcast(rng.standard_normal(top.shape[1]))
    close(top.matvec(tx).asarray(), jop.matvec(jx).asarray())


def test_mdc_engines_and_arguments(rng):
    G = kernel_to_frequency(_kernel(rng, 3, 2, 9))
    with pytest.raises(NotImplementedError, match="planar"):
        pmtt.MPIMDC(G, nt=9, nv=1, engine="planar", device="cpu")
    with pytest.raises(ValueError, match="engine"):
        pmtt.MPIMDC(G, nt=9, nv=1, engine="other", device="cpu")
    with pytest.raises(ValueError, match="odd"):
        pmtt.MPIMDC(G, nt=10, nv=1, device="cpu")
    op = pmtt.MPIMDC(G, nt=9, nv=1, engine=None, device="cpu")
    assert op.shape == (27, 18)


def test_kernel_to_frequency(rng):
    Gt = _kernel(rng, 3, 4, 21)
    for nfmax in (None, 5):
        np.testing.assert_array_equal(kernel_to_frequency(Gt, nfmax),
                                      jk2f(Gt, nfmax))


def test_mdd_example():
    """examples/mdd.py end to end: the same kernel and data through both
    packages' mdd (200 CGLS iterations)."""
    rng = np.random.default_rng(3)
    ns, nr, nt, nv = 6, 4, 33, 1
    G = kernel_to_frequency(_kernel(rng, ns, nr, nt))
    Op = pmtt.MPIMDC(G, nt=nt, nv=nv, twosided=True, device="cpu")
    xtrue = rng.standard_normal(nt * nr * nv)
    d = Op.matvec(pmtt.DistributedArray.to_dist(
        xtrue, partition=pmtt.Partition.BROADCAST, device="cpu"))
    d = d.asarray().reshape(nt, ns, nv)
    jm, _ = jmdd(G, d, nt=nt, nv=nv, niter=200)
    tm, top = mdd(G, d, nt=nt, nv=nv, niter=200, device="cpu")
    assert tm.shape == (nt, nr, nv) and top.dtype == torch.float64
    close(tm, jm, 1e-9)
    close(tm.ravel(), xtrue, 1e-6)
    # a complex64 tensor kernel keeps its device and gives float32
    # vectors
    tm32, op32 = mdd(torch.from_numpy(G).to(torch.complex64),
                     torch.from_numpy(d), nt=nt, nv=nv, niter=60)
    assert op32.dtype == torch.float32 and tm32.dtype == np.float32
    close(tm32.ravel(), xtrue, 1e-3)
