"""The port's local FFT, Identity and FunctionOperator and its
MPIFredholm1 held against the JAX package: the same numpy kernels and
vectors through both.

Tolerances: float64/complex128 at rtol 1e-12 of the largest entry
(the two packages' FFTs and GEMMs sum in different orders; nothing
iterates). With ``compute_dtype=complex64`` on a complex128 kernel the
two packages agree at rtol 1e-12 with each other (both widen the same
complex64 kernel) and each sits within rtol 1e-6 of the full-precision
product (complex64 rounding of the kernel, 2^-24 ≈ 6e-8 per entry,
summed over ny terms).
"""

import numpy as np
import pytest
import torch

import pylops_mpi_tpu as pmt
import pylops_mpi_tpu_torch as pmtt
from pylops_mpi_tpu.ops import local as jlocal
from pylops_mpi_tpu_torch.ops import local as tlocal

RTOL = 1e-12


def close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * np.max(np.abs(want)))


def _cplx(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("dims,axis,nfft", [((8, 3), 0, None),
                                            ((9, 3), 0, None),
                                            ((4, 9), 1, 16), ((4, 8), 1, 13),
                                            ((7, 2, 3), 0, 11)])
@pytest.mark.parametrize("shift", [False, True])
def test_fft_real(rng, dims, axis, nfft, shift):
    """Even and odd nfft, with and without ifftshift_before: forward,
    adjoint on a half-spectrum whose DC (and even-nfft Nyquist) bins
    have imaginary parts, and the adjoint identity."""
    kw = dict(axis=axis, nfft=nfft, real=True, ifftshift_before=shift,
              dtype="float64")
    jop, top = jlocal.FFT(dims, **kw), tlocal.FFT(dims, **kw)
    assert top.shape == jop.shape and top.dtype == torch.complex128
    x = rng.standard_normal(int(np.prod(dims)))
    close(top.matvec(_t(x)).numpy(), np.asarray(jop.matvec(x)))
    v = _cplx(rng, top.shape[0])
    xa = top.rmatvec(_t(v)).numpy()
    close(xa, np.asarray(jop.rmatvec(v)))
    # real model, complex data: the adjoint holds for the real part of
    # the data-side inner product
    y = top.matvec(_t(x)).numpy()
    np.testing.assert_allclose(np.vdot(y, v).real, np.vdot(x, xa), rtol=1e-12)


@pytest.mark.parametrize("nfft", [None, 12])
def test_fft_complex(rng, nfft):
    dims = (10, 3)
    kw = dict(axis=0, nfft=nfft, real=False, dtype="float64")
    jop, top = jlocal.FFT(dims, **kw), tlocal.FFT(dims, **kw)
    x = _cplx(rng, top.shape[1])
    close(top.matvec(_t(x)).numpy(), np.asarray(jop.matvec(x)))
    v = _cplx(rng, top.shape[0])
    close(top.rmatvec(_t(v)).numpy(), np.asarray(jop.rmatvec(v)))
    assert pmtt.dottest(pmtt.aslinearoperator(top), complexflag=3,
                        rtol=1e-12, device="cpu")


def test_fft_planes_not_ported():
    with pytest.raises(NotImplementedError):
        tlocal.FFT((8,), planes=True)


@pytest.mark.parametrize("N,M", [(5, 9), (9, 5), (6, 6)])
def test_identity_and_function_operator(rng, N, M):
    jop, top = jlocal.Identity(N, M), tlocal.Identity(N, M)
    x, v = _cplx(rng, M), _cplx(rng, N)
    close(top.matvec(_t(x)).numpy(), np.asarray(jop.matvec(x)))
    close(top.rmatvec(_t(v)).numpy(), np.asarray(jop.rmatvec(v)))
    fop = tlocal.FunctionOperator(top.matvec, top.rmatvec, N, M)
    assert fop.shape == (N, M)
    close(fop.matvec(_t(x)).numpy(), np.asarray(jop.matvec(x)))
    close(fop.rmatvec(_t(v)).numpy(), np.asarray(jop.rmatvec(v)))


def _bcast(x):
    return (pmt.DistributedArray.to_dist(x, partition=pmt.Partition.BROADCAST),
            pmtt.DistributedArray.to_dist(
                x, partition=pmtt.Partition.BROADCAST, device="cpu"))


@pytest.mark.parametrize("nsl,nx,ny,nz", [(16, 5, 4, 1), (17, 4, 6, 3)])
@pytest.mark.parametrize("cmplx", [False, True])
@pytest.mark.parametrize("saveGt", [False, True])
def test_fredholm1(rng, nsl, nx, ny, nz, cmplx, saveGt):
    """Forward and adjoint against the JAX package and the einsum,
    the dot test, and the conj() operator."""
    G = _cplx(rng, (nsl, nx, ny)) if cmplx else \
        rng.standard_normal((nsl, nx, ny))
    dt = G.dtype
    jop = pmt.MPIFredholm1(G, nz=nz, saveGt=saveGt, dtype=dt)
    top = pmtt.convert.fredholm_from_numpy(np.asarray(jop.G), nz=nz,
                                           saveGt=saveGt, device="cpu")
    assert top.shape == jop.shape and top.dtype == _t(G).dtype
    if saveGt:
        assert top.GT.is_contiguous() and not top.GT.is_conj()
    m = (_cplx(rng, nsl * ny * nz) if cmplx
         else rng.standard_normal(nsl * ny * nz))
    d = (_cplx(rng, nsl * nx * nz) if cmplx
         else rng.standard_normal(nsl * nx * nz))
    (jm, tm), (jd, td) = _bcast(m), _bcast(d)
    fwd = top.matvec(tm)
    close(fwd.asarray(), jop.matvec(jm).asarray())
    close(fwd.asarray().reshape(nsl, nx, nz),
          np.einsum("kxy,kyz->kxz", G, m.reshape(nsl, ny, nz)))
    close(top.rmatvec(td).asarray(), jop.rmatvec(jd).asarray())
    close(top.conj().matvec(tm).asarray(), jop.conj().matvec(jm).asarray())
    close(top.conj().rmatvec(td).asarray(), jop.conj().rmatvec(jd).asarray())
    assert pmtt.dottest(top, tm, td, rtol=1e-12)


def test_fredholm1_block_vectors(rng):
    """A 2-D (N, K) x is K model vectors through one product."""
    nsl, nx, ny, nz, K = 6, 4, 3, 2, 5
    G = _cplx(rng, (nsl, nx, ny))
    jop = pmt.MPIFredholm1(G, nz=nz, dtype=np.complex128)
    top = pmtt.MPIFredholm1(G, nz=nz, dtype=torch.complex128, device="cpu")
    X = _cplx(rng, (nsl * ny * nz, K))
    D = _cplx(rng, (nsl * nx * nz, K))
    (jX, tX), (jD, tD) = _bcast(X), _bcast(D)
    y = top.matvec(tX)
    assert y.global_shape == (nsl * nx * nz, K)
    close(y.asarray(), jop.matvec(jX).asarray())
    close(top.rmatvec(tD).asarray(), jop.rmatvec(jD).asarray())
    for j in range(K):
        col = pmtt.DistributedArray.to_dist(X[:, j], device="cpu")
        close(top.matvec(col).asarray(), y.asarray()[:, j])


@pytest.mark.parametrize("saveGt", [False, True])
def test_fredholm1_narrow_storage(rng, saveGt):
    """compute_dtype=complex64 on a complex128 operator: the kernel is
    stored narrow, vectors and products stay complex128."""
    nsl, nx, ny, nz = 8, 6, 5, 2
    G = _cplx(rng, (nsl, nx, ny))
    kw = dict(nz=nz, saveGt=saveGt, dtype=np.complex128)
    jop = pmt.MPIFredholm1(G, compute_dtype=np.complex64, **kw)
    top = pmtt.MPIFredholm1(G, compute_dtype=torch.complex64, device="cpu",
                            **dict(kw, dtype=torch.complex128))
    assert top.G.dtype == torch.complex64
    full = pmtt.MPIFredholm1(G, device="cpu",
                             **dict(kw, dtype=torch.complex128))
    (jm, tm), (jd, td) = _bcast(_cplx(rng, nsl * ny * nz)), \
        _bcast(_cplx(rng, nsl * nx * nz))
    for got, want, ref in ((top.matvec(tm), jop.matvec(jm), full.matvec(tm)),
                           (top.rmatvec(td), jop.rmatvec(jd),
                            full.rmatvec(td))):
        assert got.dtype == torch.complex128
        close(got.asarray(), want.asarray())
        close(got.asarray(), ref.asarray(), 1e-6)
    with pytest.raises(ValueError, match="imaginary"):
        pmtt.MPIFredholm1(G, compute_dtype=torch.float32, device="cpu")
