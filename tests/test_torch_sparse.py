"""The port's sparse matrix product held against the JAX package's
``MPISparseMatrixMult`` and the dense matrix: forward and adjoint for
real, complex and ragged (a row count the JAX package's 8 devices do
not divide) matrices, block right-hand sides, unsorted triplets,
``from_banded``/``diagonal``/``todense``, the ``ring`` adjoint, a CGLS
solve through the operator, the converter and ``auto_sparse_matmult``.

Tolerances: applies rtol 1e-12 in f64 (relative to the largest entry);
the CGLS solve rtol 1e-9 over 15 iterations.
"""

import numpy as np
import pytest
import torch

import pylops_mpi_tpu as pmt
import pylops_mpi_tpu_torch as pmtt
from pylops_mpi_tpu.ops.sparse import MPISparseMatrixMult as JSparse
from pylops_mpi_tpu_torch.ops.sparse import (MPISparseMatrixMult,
                                             auto_sparse_matmult)


def close(got, want, rtol=1e-12):
    want = np.asarray(want)
    got = np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.max(np.abs(want)))


def sparse_matrix(rng, N, M, density=0.15, complex_=False):
    A = rng.standard_normal((N, M)) * (rng.random((N, M)) < density)
    if complex_:
        A = A + 1j * rng.standard_normal((N, M)) * (A != 0)
    return A


def jarr(v):
    return pmt.DistributedArray.to_dist(v)


def tarr(v):
    return pmtt.DistributedArray.to_dist(v, device="cpu")


@pytest.mark.parametrize("kind", ["real", "complex", "ragged"])
def test_apply_matches_jax_and_dense(rng, kind):
    N, M = (37, 29) if kind == "ragged" else (48, 40)
    A = sparse_matrix(rng, N, M, complex_=kind == "complex")
    J = JSparse.from_dense(A)
    T = MPISparseMatrixMult.from_dense(A, device="cpu")
    assert (T.nnz, T.shape, T.dtype) == (J.nnz, J.shape,
                                         torch.from_numpy(A).dtype)
    assert T.density == pytest.approx(J.density)
    x = rng.standard_normal(M)
    y = rng.standard_normal(N)
    if kind == "complex":
        x = x + 1j * rng.standard_normal(M)
        y = y + 1j * rng.standard_normal(N)
    fw, ad = T.matvec(tarr(x)).asarray(), T.rmatvec(tarr(y)).asarray()
    close(fw, J.matvec(jarr(x)).asarray())
    close(ad, J.rmatvec(jarr(y)).asarray())
    close(fw, A @ x)
    close(ad, A.conj().T @ y)
    # K columns in one apply
    X, Y = rng.standard_normal((M, 3)), rng.standard_normal((N, 3))
    close(T.matvec(tarr(X)).asarray(), J.matvec(jarr(X)).asarray())
    close(T.rmatvec(tarr(Y)).asarray(), A.conj().T @ Y)
    # the ring adjoint runs the scatter schedule
    R = MPISparseMatrixMult.from_dense(A, adjoint_mode="ring", device="cpu")
    assert torch.equal(R.rmatvec(tarr(y)).array, T.rmatvec(tarr(y)).array)
    with pytest.raises(ValueError, match="adjoint_mode"):
        MPISparseMatrixMult.from_dense(A, adjoint_mode="tree", device="cpu")


def test_unsorted_triplets_banded_diagonal_todense(rng):
    N = 30
    offsets = [-2, 0, 1, 3]
    bands = [rng.standard_normal(N - abs(o)) for o in offsets]
    T = MPISparseMatrixMult.from_banded(offsets, bands, (N, N), device="cpu")
    J = JSparse.from_banded(offsets, bands, (N, N))
    dense = sum(np.diag(b, o) for o, b in zip(offsets, bands))
    close(T.todense(), dense)
    close(T.todense(), np.asarray(J.todense()))
    close(T.diagonal().numpy(), np.asarray(J.diagonal()))
    close(T.diagonal().numpy(), np.diag(dense))
    # triplets in any order are sorted stably by row
    rows, cols = np.nonzero(dense)
    order = rng.permutation(rows.size)
    U = MPISparseMatrixMult(rows[order], cols[order], dense[rows, cols][order],
                            (N, N), device="cpu")
    assert np.all(np.diff(U._rows.numpy()) >= 0)
    x = rng.standard_normal(N)
    close(U.matvec(tarr(x)).asarray(), dense @ x)
    close(U.rmatvec(tarr(x)).asarray(), dense.T @ x)
    with pytest.raises(ValueError, match="outside"):
        MPISparseMatrixMult([0, 5], [0, 1], [1.0, 2.0], (4, 4), device="cpu")
    with pytest.raises(ValueError, match="diagonal length"):
        MPISparseMatrixMult.from_banded([0], [np.ones(3)], (4, 4),
                                        device="cpu")


def test_convert_round_trip(rng):
    A = sparse_matrix(rng, 40, 40)
    J = JSparse.from_dense(A)
    T = pmtt.convert.sparse_from_numpy(np.asarray(J._rows),
                                       np.asarray(J._cols),
                                       np.asarray(J._data), J.shape,
                                       device="cpu")
    np.testing.assert_array_equal(T._rows.numpy(), np.asarray(J._rows))
    np.testing.assert_array_equal(T._cols.numpy(), np.asarray(J._cols))
    np.testing.assert_array_equal(T._data.numpy(), np.asarray(J._data))
    x = rng.standard_normal(40)
    close(T.matvec(tarr(x)).asarray(), J.matvec(jarr(x)).asarray())


def test_cgls_through_sparse(rng):
    N, M = 64, 48
    A = sparse_matrix(rng, N, M, density=0.2) + np.eye(N, M) * 2
    y = rng.standard_normal(N)
    J = JSparse.from_dense(A)
    T = MPISparseMatrixMult.from_dense(A, device="cpu")
    jx, _, jit, _, _, jcost = pmt.cgls(J, jarr(y), niter=15, damp=0.1,
                                       tol=0.0)
    tx, _, tit, _, _, tcost = pmtt.cgls(T, tarr(y), niter=15, damp=0.1,
                                        tol=0.0)
    assert tit == jit == 15
    close(tx.asarray(), jx.asarray(), 1e-9)
    close(tcost.numpy(), jcost, 1e-9)
    # and with the Jacobi preconditioner of the normal system
    d = np.sum(A ** 2, axis=0) + 0.01
    tM = pmtt.JacobiPrecond(d, device="cpu")
    jM = pmt.JacobiPrecond(d)
    jx = pmt.cgls(J, jarr(y), niter=15, damp=0.1, tol=0.0, M=jM)[0]
    tx = pmtt.cgls(T, tarr(y), niter=15, damp=0.1, tol=0.0, M=tM)[0]
    close(tx.asarray(), jx.asarray(), 1e-9)


def test_auto_sparse_matmult_is_dense(rng):
    A = sparse_matrix(rng, 12, 10, density=0.05)
    Op = auto_sparse_matmult(A, device="cpu")
    assert not isinstance(Op, MPISparseMatrixMult)
    assert type(Op).__name__ == type(pmtt.MPIMatrixMult(
        A, 1, device="cpu")).__name__
    x = rng.standard_normal(10)
    close(Op.matvec(tarr(x)).asarray(), A @ x)
    with pytest.raises(ValueError, match="2-D"):
        auto_sparse_matmult(np.ones(3), device="cpu")
