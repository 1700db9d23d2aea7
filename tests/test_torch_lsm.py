"""The port's least-squares migration (TravelTimeSpray,
KirchhoffDemigration, MPILSM, lsm) held against the JAX package: the
same geometry, wavelet and reflectivity through both.

Tolerances: float64. The travel-time tables (``itrav``, ``amp``) are
equal bit for bit. Single applies at rtol 1e-12 of the largest entry
(the port scatter-adds and gathers where the JAX package contracts with
one-hot matrices and reduces over traces at once; the sums run in
other orders). ``examples/lsm.py``'s ``lsm``: its first five CGLS
iterations at rtol 1e-9; its 100 iterations at the looser tolerance
:func:`test_lsm_example_100_iterations` explains.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pylops_mpi_tpu as pmt
import pylops_mpi_tpu_torch as pmtt
from pylops_mpi_tpu import models as jm
from pylops_mpi_tpu_torch import models as tm

RTOL = 1e-12
CPU = "cpu"
F64 = torch.float64
# the module (its name is shadowed by the function lsm in models)
lsm_module = importlib.import_module("pylops_mpi_tpu_torch.models.lsm")


def close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * np.max(np.abs(want)))


def _example(nt=400):
    """examples/lsm.py's geometry, wavelet and two-interface model."""
    nx, nz, dx = 81, 60, 4
    x, z = np.arange(nx) * dx, np.arange(nz) * dx
    refl = np.zeros((nz, nx))
    refl[30] = -1.0
    refl[50] = 0.5
    nr, ns = 11, 16
    recs = np.vstack((np.linspace(10 * dx, (nx - 10) * dx, nr),
                      20 * np.ones(nr)))
    srcs = np.vstack((np.linspace(10 * dx, (nx - 10) * dx, ns),
                      10 * np.ones(ns)))
    t = np.arange(nt) * 0.002
    wav, _ = jm.ricker(t[:21], f0=20)
    return dict(z=z, x=x, t=t, sources=srcs, recs=recs, vel=1000.0,
                wav=wav, wavcenter=len(wav) // 2), refl


@pytest.mark.parametrize("nt,dtype", [(400, "float64"), (400, "float32"),
                                      (120, "float64")])
def test_tables_bitwise_equal(nt, dtype):
    """itrav and amp equal the JAX package's bit for bit; with nt 120
    the deep points' travel times fall past the trace and are dropped
    (index 0, amplitude 0) as in the JAX package."""
    geo, _ = _example(nt)
    jk = jm.KirchhoffDemigration(**geo, dtype=np.dtype(dtype))
    tk = tm.KirchhoffDemigration(**geo, dtype=getattr(torch, dtype),
                                 device=CPU)
    spray = tk.B
    assert spray.index.dtype == torch.int32 and spray.index.is_contiguous()
    assert spray.itrav.dtype == torch.int32
    assert spray.amp.dtype == getattr(torch, dtype) \
        and spray.amp.is_contiguous()
    np.testing.assert_array_equal(spray.itrav.numpy(), np.asarray(jk.B.itrav))
    np.testing.assert_array_equal(spray.amp.numpy(), np.asarray(jk.B.amp))
    if nt == 120:
        assert (spray.amp == 0).any() and (spray.amp != 0).any()


@pytest.mark.parametrize("chunk", [None, 7])
def test_spray_oracle(rng, monkeypatch, chunk):
    """TravelTimeSpray against tests/test_models.py:105's dense scatter
    oracle and against the JAX package, forward and adjoint, in one
    chunk and in chunks of 7 entries (one trace each)."""
    if chunk is not None:
        monkeypatch.setattr(lsm_module, "_CHUNK", chunk)
    npairs, npix, nt = 3, 7, 12
    itrav = rng.integers(0, nt + 3, size=(npairs, npix))  # some invalid
    amp = rng.standard_normal((npairs, npix))
    op = tm.TravelTimeSpray(itrav, amp, nt, dtype=F64, device=CPU)
    jop = jm.TravelTimeSpray(itrav, amp, nt, dtype=np.float64)
    np.testing.assert_array_equal(op.itrav.numpy(), np.asarray(jop.itrav))
    np.testing.assert_array_equal(op.amp.numpy(), np.asarray(jop.amp))
    m = rng.standard_normal(npix)
    dense = np.zeros((npairs, nt))
    for p in range(npairs):
        for i in range(npix):
            if itrav[p, i] < nt:
                dense[p, itrav[p, i]] += amp[p, i] * m[i]
    y = op.matvec(torch.from_numpy(m)).numpy()
    close(y.reshape(npairs, nt), dense)
    close(y, np.asarray(jop.matvec(jnp.asarray(m))))
    d = rng.standard_normal(npairs * nt)
    close(op.rmatvec(torch.from_numpy(d)).numpy(),
          np.asarray(jop.rmatvec(jnp.asarray(d))))
    np.testing.assert_allclose(np.vdot(y, d), np.vdot(
        m, op.rmatvec(torch.from_numpy(d)).numpy()), rtol=1e-12)


def test_kirchhoff_applies_match_jax(rng, monkeypatch):
    """KirchhoffDemigration (Conv1D · spray) forward and adjoint, in
    chunks of a few traces, and its dot test."""
    monkeypatch.setattr(lsm_module, "_CHUNK", 5000)
    geo, _ = _example()
    jk = jm.KirchhoffDemigration(**geo, dtype=np.float64)
    tk = tm.KirchhoffDemigration(**geo, dtype=F64, device=CPU)
    assert tk.shape == jk.shape
    m = rng.standard_normal(tk.shape[1])
    d = rng.standard_normal(tk.shape[0])
    y = tk.matvec(torch.from_numpy(m)).numpy()
    close(y, np.asarray(jk.matvec(jnp.asarray(m))))
    a = tk.rmatvec(torch.from_numpy(d)).numpy()
    close(a, np.asarray(jk.rmatvec(jnp.asarray(d))))
    np.testing.assert_allclose(np.vdot(y, d), np.vdot(m, a), rtol=1e-10)


def test_mpilsm_matches_jax(rng):
    """MPILSM at one worker (one batch of 16 sources) against the JAX
    package's on the 8-device mesh (8 batches of 2): forward BROADCAST →
    SCATTER, adjoint → BROADCAST; and the dot test."""
    geo, refl = _example()
    jop = jm.MPILSM(**geo, dtype=np.float64)
    top = tm.MPILSM(**geo, dtype=F64, device=CPU)
    assert isinstance(top, pmtt.MPIVStack) and top.shape == jop.shape
    m = refl.ravel()
    ty = top.matvec(pmtt.DistributedArray.to_dist(
        m, partition=pmtt.Partition.BROADCAST, device=CPU))
    assert ty.partition == pmtt.Partition.SCATTER
    jy = jop.matvec(pmt.DistributedArray.to_dist(
        m, partition=pmt.Partition.BROADCAST))
    close(ty.asarray(), jy.asarray())
    d = rng.standard_normal(top.shape[0])
    tz = top.rmatvec(pmtt.DistributedArray.to_dist(d, device=CPU))
    assert tz.partition == pmtt.Partition.BROADCAST
    close(tz.asarray(), jop.rmatvec(pmt.DistributedArray.to_dist(d)).asarray())
    assert pmtt.dottest(top, rtol=1e-10, device=CPU)


def test_lsm_example_first_iterations():
    """examples/lsm.py's ``lsm`` over five CGLS iterations against the
    JAX package on one device: data, image and cost at rtol 1e-9."""
    geo, refl = _example()
    jmin, jd, jcost = jm.lsm(**geo, refl=refl, niter=5, dtype=np.float64,
                             mesh=pmt.make_mesh(1))
    tmin, td, tcost = tm.lsm(**geo, refl=refl, niter=5, dtype=F64,
                             device=CPU)
    assert tmin.shape == refl.shape and td.shape == jd.shape
    close(td, jd)
    close(tmin, jmin, 1e-9)
    close(tcost, jcost, 1e-9)


def _peaks(minv):
    """examples/lsm.py's check: rows that are local maxima of the image's
    row energy above 0.3 of its largest."""
    e = np.abs(minv).sum(axis=1)
    return [i for i in range(1, len(e) - 1)
            if e[i] > e[i - 1] and e[i] > e[i + 1] and e[i] > 0.3 * e.max()]


def test_lsm_example_100_iterations():
    """examples/lsm.py's ``lsm`` (100 iterations) against the JAX package
    on one device.

    Where summation order enters, and why the tolerance is loose: the
    example's receivers sit on image grid points, so at those pixels
    ``d_r = 0`` and ``amp = 1/sqrt(1e-10) = 1e5``, against ~1e-2
    elsewhere. CGLS on that operator alternates steps of ~1e-12 and
    ~0.1 and amplifies the last-bit differences of the adjoint's sum
    over traces (one reduction in the JAX package, chunked sums here)
    to 1e-2 within 100 iterations. The JAX package differs from itself
    as much between a one-device and the 8-device mesh (up to 10% in
    the cost history and 2.4e-3 of the image's largest entry, measured
    on this example). So the image is held at 1e-2 of its largest entry
    (the port is at 1.0e-3) and the final cost at 5e-2 relative, both
    costs must not increase, and both must recover the two interfaces,
    as the example checks."""
    geo, refl = _example()
    jmin, jd, jcost = jm.lsm(**geo, refl=refl, niter=100, dtype=np.float64,
                             mesh=pmt.make_mesh(1))
    tmin, td, tcost = tm.lsm(**geo, refl=refl, niter=100, dtype=F64,
                             device=CPU)
    close(td, jd)
    close(tmin, jmin, 1e-2)
    np.testing.assert_allclose(tcost[-1], jcost[-1], rtol=5e-2)
    for c in (tcost, np.asarray(jcost)):
        assert len(c) == 101 and np.all(np.diff(c) <= 1e-12 * c[0])
    assert _peaks(tmin) == _peaks(np.asarray(jmin)) == [30, 50]


@pytest.mark.cuda
def test_tables_and_applies_on_card(rng):
    """On the card: the tables equal the CPU's bit for bit (CUDA's f64
    sqrt, true division by a device scalar and half-to-even rounding),
    and the spray's atomics and gather agree with the CPU's in f64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card, not here)")
    geo, _ = _example()
    ops = [tm.KirchhoffDemigration(**geo, dtype=F64, device=dev)
           for dev in ("cuda", CPU)]
    for name in ("index", "amp"):
        assert torch.equal(getattr(ops[0].B, name).cpu(),
                           getattr(ops[1].B, name))
    m = rng.standard_normal(ops[1].shape[1])
    d = rng.standard_normal(ops[1].shape[0])
    close(ops[0].matvec(torch.from_numpy(m).cuda()).cpu().numpy(),
          ops[1].matvec(torch.from_numpy(m)).numpy())
    close(ops[0].rmatvec(torch.from_numpy(d).cuda()).cpu().numpy(),
          ops[1].rmatvec(torch.from_numpy(d)).numpy())
