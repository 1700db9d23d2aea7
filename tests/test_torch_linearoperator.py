"""The port's lazy operator algebra and MatrixMult held against the JAX
package: the same numpy blocks and vectors through both.

Tolerance: float64 and complex128, rtol 1e-12 of the largest entry
(summation order only; entries that cancel to near zero are held to the
same absolute error as the rest). Each composed operator also passes the
port's own dottest.
"""

import numpy as np
import pytest
import torch

import pylops_mpi_tpu as pmt
import pylops_mpi_tpu_torch as pmtt
from pylops_mpi_tpu.ops.local import MatrixMult as JMatrixMult
from pylops_mpi_tpu_torch.ops.local import MatrixMult as TMatrixMult

RTOL = 1e-12
NBLK = 8


def close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.max(np.abs(want)))


def _blocks(rng, m, n, cmplx=False):
    out = []
    for _ in range(NBLK):
        b = rng.standard_normal((m, n))
        if cmplx:
            b = b + 1j * rng.standard_normal((m, n))
        out.append(b)
    return out


def _ops(blocks):
    jop = pmt.MPIBlockDiag([JMatrixMult(b) for b in blocks])
    top = pmtt.convert.blockdiag_from_numpy(blocks, device="cpu")
    return jop, top


def _vec(rng, n, cmplx):
    v = rng.standard_normal(n)
    return v + 1j * rng.standard_normal(n) if cmplx else v


def _compare(jop, top, rng, cmplx):
    x = _vec(rng, jop.shape[1], cmplx)
    y = _vec(rng, jop.shape[0], cmplx)
    close(
        top.matvec(pmtt.DistributedArray.to_dist(x, device="cpu")).asarray(),
        jop.matvec(pmt.DistributedArray.to_dist(x)).asarray())
    close(
        top.rmatvec(pmtt.DistributedArray.to_dist(y, device="cpu")).asarray(),
        jop.rmatvec(pmt.DistributedArray.to_dist(y)).asarray())
    assert pmtt.dottest(top, complexflag=3 if cmplx else 0, rtol=1e-10,
                        device="cpu")


EXPRESSIONS = {
    "H": lambda A, B: A.H,
    "T": lambda A, B: A.T,
    "conj": lambda A, B: A.conj(),
    "sum": lambda A, B: A + B,
    "sub": lambda A, B: A - B,
    "neg": lambda A, B: -A,
    "scaled": lambda A, B: 2.5 * A,
    "scaled_right": lambda A, B: A * (0.5 - 1.5j),
    "product": lambda A, B: A * B,
    "matmul": lambda A, B: A @ B.H,
    "power": lambda A, B: A ** 3,
    "normal": lambda A, B: A.H @ A,
    "nested": lambda A, B: (2.0 * A + B.T).H * B,
}


@pytest.mark.parametrize("name,cmplx", [
    (name, cmplx) for name in sorted(EXPRESSIONS) for cmplx in (False, True)
    if cmplx or name != "scaled_right"])  # a complex scale needs complex blocks
def test_lazy_algebra_matches_jax(rng, name, cmplx):
    ba, bb = _blocks(rng, 6, 6, cmplx), _blocks(rng, 6, 6, cmplx)
    (ja, ta), (jb, tb) = _ops(ba), _ops(bb)
    expr = EXPRESSIONS[name]
    jop, top = expr(ja, jb), expr(ta, tb)
    assert top.shape == jop.shape
    _compare(jop, top, rng, cmplx)


@pytest.mark.parametrize("otherdims", [(), (3,), (2, 2)])
@pytest.mark.parametrize("cmplx", [False, True])
def test_matrixmult_local(rng, otherdims, cmplx):
    A = rng.standard_normal((7, 5)) + (1j * rng.standard_normal((7, 5))
                                       if cmplx else 0)
    jm = JMatrixMult(A, otherdims=otherdims)
    tm = TMatrixMult(torch.from_numpy(A), otherdims=otherdims)
    assert tm.shape == jm.shape and tm.dims == jm.dims
    x = _vec(rng, jm.shape[1], cmplx)
    y = _vec(rng, jm.shape[0], cmplx)
    close(tm.matvec(torch.from_numpy(x)).numpy(),
                               np.asarray(jm.matvec(x)))
    close(tm.rmatvec(torch.from_numpy(y)).numpy(),
                               np.asarray(jm.rmatvec(y)))
    for name in ("H", "T", "conj"):
        j2, t2 = getattr(jm, name), getattr(tm, name)
        j2 = j2() if callable(j2) else j2
        t2 = t2() if callable(t2) else t2
        xx = _vec(rng, j2.shape[1], cmplx)
        close(t2.matvec(torch.from_numpy(xx)).numpy(),
                                   np.asarray(j2.matvec(xx)))


def test_local_algebra(rng):
    A, B = rng.standard_normal((5, 5)), rng.standard_normal((5, 5))
    ja, jb = JMatrixMult(A), JMatrixMult(B)
    ta, tb = TMatrixMult(torch.from_numpy(A)), TMatrixMult(torch.from_numpy(B))
    x = rng.standard_normal(5)
    for jop, top in [(ja + jb, ta + tb), (ja - jb, ta - tb), (ja * jb, ta * tb),
                     (2.0 * ja, 2.0 * ta), (-ja, -ta), (ja @ jb, ta @ tb)]:
        close(top.matvec(torch.from_numpy(x)).numpy(),
                                   np.asarray(jop.matvec(x)))
        close(top.rmatvec(torch.from_numpy(x)).numpy(),
                                   np.asarray(jop.rmatvec(x)))


def test_aslinearoperator_wraps_local(rng):
    A = rng.standard_normal((6, 4))
    top = pmtt.aslinearoperator(TMatrixMult(torch.from_numpy(A)))
    jop = pmt.aslinearoperator(JMatrixMult(A))
    x = rng.standard_normal(4)
    close(
        top.matvec(pmtt.DistributedArray.to_dist(x, device="cpu")).asarray(),
        jop.matvec(pmt.DistributedArray.to_dist(x)).asarray())
    assert pmtt.dottest(top, device="cpu")


def test_shape_errors():
    _, top = _ops([np.eye(3)] * NBLK)
    with pytest.raises(ValueError, match="dimension mismatch"):
        top.matvec(pmtt.DistributedArray.to_dist(np.ones(5), device="cpu"))
    _, other = _ops([np.ones((2, 3))] * NBLK)
    with pytest.raises(ValueError, match="shape mismatch"):
        top + other
    with pytest.raises(ValueError, match="Scalar not allowed"):
        top @ 2.0
    with pytest.raises(ValueError, match="square"):
        other ** 2
