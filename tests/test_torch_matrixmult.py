"""The port's MPIMatrixMult at a world of one rank, held against the JAX
package on a one-device mesh: every kind (``block``, ``summa`` with its
``gather``/``stat_a``/``auto`` schedules, ``auto``) in f64 and
complex128, block inputs ``(K·M, ncol)``, ``saveAt``, bf16 tile storage
on an f32 operator and the ``compute_dtype`` error on f64, the grid
helpers and the volume model, ``dottest``, CGLS, the flows of
``examples/plot_matrixmult.py`` and ``plot_summamatrixmult.py``, and the
factory's positional order.

Tolerances: rtol 1e-12 of the largest reference entry in f64 and
complex128 (the packages' GEMMs sum in different orders); 1e-10 for
CGLS; 1e-5 with bf16 storage (both widen the same bf16 tiles to f32).
"""

import numpy as np
import pytest
import torch

import pylops_mpi_tpu as pmt
import pylops_mpi_tpu_torch as pmtt
from pylops_mpi_tpu.ops import matrixmult as jmm
from pylops_mpi_tpu_torch.ops import matrixmult as tmm

CPU = "cpu"
KINDS = [("block", "auto"), ("summa", "gather"), ("summa", "stat_a"),
         ("summa", "auto"), ("auto", "auto")]


@pytest.fixture(scope="module")
def mesh1():
    from pylops_mpi_tpu.parallel.mesh import make_mesh
    return make_mesh(1)


def close(got, want, rtol=1e-12):
    want = np.asarray(want)
    got = np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.max(np.abs(want)))


def _mat(rng, shape, cmplx):
    a = rng.standard_normal(shape)
    return a + 1j * rng.standard_normal(shape) if cmplx else a


def _pair(mesh1, A, M, kind, schedule, **kw):
    jop = pmt.MPIMatrixMult(A, M, kind=kind, mesh=mesh1, **(
        dict(schedule=schedule) if kind == "summa" else {}), **kw)
    top = pmtt.MPIMatrixMult(A, M, kind=kind, schedule=schedule,
                             device=CPU, **kw)
    return jop, top


def _jvec(mesh1, x):
    return pmt.DistributedArray.to_dist(x, mesh=mesh1)


def _tvec(x):
    return pmtt.DistributedArray.to_dist(x, device=CPU)


@pytest.mark.parametrize("kind,schedule", KINDS)
@pytest.mark.parametrize("cmplx", [False, True])
@pytest.mark.parametrize("shape", [(23, 17, 10), (6, 9, 1)])
def test_matches_jax(rng, mesh1, kind, schedule, cmplx, shape):
    N, K, M = shape
    A = _mat(rng, (N, K), cmplx)
    jop, top = _pair(mesh1, A, M, kind, schedule)
    assert top.shape == jop.shape and (top.dims, top.dimsd) == (jop.dims,
                                                                jop.dimsd)
    assert top.dtype == (torch.complex128 if cmplx else torch.float64)
    if kind == "summa":
        assert top.schedule == jop.schedule and top.grid == jop.grid
    x = _mat(rng, K * M, cmplx)
    y, yj = top.matvec(_tvec(x)), jop.matvec(_jvec(mesh1, x))
    close(y.asarray(), yj.asarray())
    assert y.local_shapes == yj.local_shapes
    assert y.partition == pmtt.Partition.SCATTER
    v = _mat(rng, N * M, cmplx)
    xa, xj = top.rmatvec(_tvec(v)), jop.rmatvec(_jvec(mesh1, v))
    close(xa.asarray(), xj.asarray())
    assert xa.local_shapes == xj.local_shapes
    close(y.asarray().reshape(N, M), A @ x.reshape(K, M))


@pytest.mark.parametrize("kind,schedule", KINDS)
def test_block_input_matches_jax(rng, mesh1, kind, schedule):
    """A ``(K·M, ncol)`` input folds its columns into the GEMM."""
    N, K, M, ncol = 11, 7, 5, 3
    A = rng.standard_normal((N, K))
    jop, top = _pair(mesh1, A, M, kind, schedule)
    X = rng.standard_normal((K * M, ncol))
    y, yj = top.matvec(_tvec(X)), jop.matvec(_jvec(mesh1, X))
    assert y.global_shape == (N * M, ncol)
    close(y.asarray(), yj.asarray())
    assert y.local_shapes == yj.local_shapes
    V = rng.standard_normal((N * M, ncol))
    close(top.rmatvec(_tvec(V)).asarray(),
          jop.rmatvec(_jvec(mesh1, V)).asarray())
    for c in range(ncol):
        close(y.asarray()[:, c], (A @ X[:, c].reshape(K, M)).ravel())


@pytest.mark.parametrize("kind", ["block", "summa", "auto"])
def test_save_at(rng, mesh1, kind):
    """``saveAt`` keeps the block rows' ``Aᴴ``; the SUMMA kinds store
    none (their adjoint reads the tile), as the JAX SUMMA kind."""
    A = _mat(rng, (9, 6), True)
    top = pmtt.MPIMatrixMult(A, 4, saveAt=True, kind=kind, device=CPU)
    plain = pmtt.MPIMatrixMult(A, 4, kind=kind, device=CPU)
    if kind == "block":
        np.testing.assert_array_equal(top.At.numpy(), A.conj().T)
    else:
        assert top.At is None
    v = _tvec(_mat(rng, 36, True))
    close(top.rmatvec(v).asarray(), plain.rmatvec(v).asarray(), 0)
    jop = pmt.MPIMatrixMult(A, 4, saveAt=True, kind=kind, mesh=mesh1)
    close(top.rmatvec(v).asarray(), jop.rmatvec(_jvec(mesh1,
                                                      v.asarray())).asarray())


@pytest.mark.parametrize("kind,schedule", KINDS)
def test_bf16_storage(rng, mesh1, kind, schedule):
    """bf16 tiles on an f32 operator: stored narrow, the f32 vector kept
    wide, f32 output; against the JAX package's bf16 tiles."""
    import jax.numpy as jnp
    N, K, M = 20, 12, 6
    A = rng.standard_normal((N, K)).astype(np.float32)
    top = pmtt.MPIMatrixMult(A, M, kind=kind, schedule=schedule,
                             compute_dtype=torch.bfloat16, device=CPU)
    assert top.A.dtype == torch.bfloat16 and top.dtype == torch.float32
    jop = pmt.MPIMatrixMult(A, M, kind=kind, mesh=mesh1,
                            compute_dtype=jnp.bfloat16, **(
                                dict(schedule=schedule)
                                if kind == "summa" else {}))
    x = rng.standard_normal(K * M).astype(np.float32)
    y = top.matvec(_tvec(x))
    assert y.dtype == torch.float32
    close(y.asarray(), jop.matvec(_jvec(mesh1, x)).asarray(), 1e-5)
    v = rng.standard_normal(N * M).astype(np.float32)
    close(top.rmatvec(_tvec(v)).asarray(),
          jop.rmatvec(_jvec(mesh1, v)).asarray(), 1e-5)
    # the bf16 tile is the only rounding: against the f32 product
    Ab = torch.from_numpy(A).to(torch.bfloat16).float().numpy()
    close(y.asarray(), (Ab @ x.reshape(K, M)).ravel(), 1e-5)


def test_compute_dtype_only_on_f32(rng):
    A = rng.standard_normal((4, 3))
    with pytest.raises(ValueError, match="only supported for real float32"):
        pmtt.MPIMatrixMult(A, 2, compute_dtype=torch.bfloat16, device=CPU)
    with pytest.raises(ValueError, match="only supported for real float32"):
        pmtt.MPIMatrixMult(A.astype(np.complex64), 2, kind="block",
                           compute_dtype=torch.bfloat16, device=CPU)


def test_schedule_and_kind_errors(rng):
    A = rng.standard_normal((4, 3))
    with pytest.raises(ValueError, match="schedule='ring'"):
        pmtt.MPIMatrixMult(A, 2, schedule="ring", device=CPU)
    with pytest.raises(NotImplementedError, match="kind must be"):
        pmtt.MPIMatrixMult(A, 2, kind="cannon", device=CPU)
    with pytest.raises(ValueError, match="does not tile 1 ranks"):
        pmtt.MPIMatrixMult(A, 2, grid=(2, 1), device=CPU)


@pytest.mark.parametrize("shape,grid", [((7, 5), (2, 2)), ((9, 4), (1, 3)),
                                        ((3, 8), (3, 2)), ((10, 10), (1, 1))])
def test_grid_helpers_match_jax(rng, shape, grid):
    P = grid[0] * grid[1]
    for r in range(P):
        assert tmm.local_block_split(shape, r, grid) == \
            jmm.local_block_split(shape, r, grid)
    A = rng.standard_normal(shape)
    tiles = [A[tmm.local_block_split(shape, r, grid)] for r in range(P)]
    np.testing.assert_array_equal(tmm.block_gather(tiles, shape, grid),
                                  jmm.block_gather(tiles, shape, grid))
    np.testing.assert_array_equal(tmm.block_gather(tiles, shape, grid), A)
    with pytest.raises(ValueError, match="outside grid"):
        tmm.local_block_split(shape, P, grid)


def test_active_grid_and_best_grid(mesh1):
    """At a world of one rank every rank is active and no group is made;
    ``best_grid_2d`` factors as the JAX package's."""
    from pylops_mpi_tpu.parallel.mesh import best_grid_2d as jbest
    group, grid, active, full = tmm.active_grid_comm(5, 7)
    _, jgrid, jactive, jfull = jmm.active_grid_comm(5, 7, n_devices=1)
    assert (group, grid, active, full) == (None, jgrid, jactive, jfull)
    with pytest.raises(ValueError, match="only 1 exist"):
        tmm.active_grid_comm(5, 7, n_devices=2)
    for n in range(1, 13):
        assert pmtt.parallel.best_grid_2d(n) == jbest(n)
    g = pmtt.parallel.make_grid_2d()
    assert (g.shape, g.coords, g.c, g.r) == ((1, 1), (0, 0), None, None)


@pytest.mark.parametrize("shape", [(4096, 2048, 64), (23, 17, 10),
                                   (8, 6, 1), (64, 48, 32)])
@pytest.mark.parametrize("grid", [(1, 1), (1, 2), (2, 2), (1, 3), (2, 3)])
def test_volume_model_matches_jax(shape, grid):
    from pylops_mpi_tpu.diagnostics import costmodel
    assert tmm.summa_comm_volume(*shape, grid) == \
        costmodel.summa_comm_volume(*shape, grid)
    assert tmm.summa_comm_volume_split(*shape, grid) == \
        costmodel.summa_comm_volume_split(*shape, grid)


@pytest.mark.parametrize("kind,schedule", KINDS)
@pytest.mark.parametrize("cmplx", [False, True])
def test_dottest(rng, kind, schedule, cmplx):
    A = _mat(rng, (13, 8), cmplx)
    top = pmtt.MPIMatrixMult(A, 3, kind=kind, schedule=schedule, device=CPU)
    assert pmtt.dottest(top, complexflag=3 if cmplx else 0, rtol=1e-12,
                        device=CPU)


@pytest.mark.parametrize("kind,schedule", KINDS)
def test_cgls_matches_jax(rng, mesh1, kind, schedule):
    N, K, M = 30, 12, 4
    A = rng.standard_normal((N, K))
    jop, top = _pair(mesh1, A, M, kind, schedule)
    X = rng.standard_normal(K * M)
    y = A @ X.reshape(K, M)
    xt = pmtt.cgls(top, _tvec(y.ravel()), x0=_tvec(np.zeros(K * M)),
                   niter=15, tol=0.0)[0]
    xj = pmt.cgls(jop, _jvec(mesh1, y.ravel()),
                  x0=_jvec(mesh1, np.zeros(K * M)), niter=15, tol=0.0)[0]
    close(xt.asarray(), xj.asarray(), 1e-10)
    close(xt.asarray(), X, 1e-6)


def test_plot_matrixmult_flow(mesh1):
    """examples/plot_matrixmult.py: the block kind, forward, adjoint and
    60 CGLS iterations."""
    N, K, M = 24, 18, 10
    rng = np.random.default_rng(3)
    A = rng.standard_normal((N, K))
    X = rng.standard_normal((K, M))
    Op = pmtt.MPIMatrixMult(A, M=M, kind="block", dtype=np.float64,
                            device=CPU)
    jop = pmt.MPIMatrixMult(A, M=M, kind="block", dtype=np.float64,
                            mesh=mesh1)
    y = Op.matvec(_tvec(X.ravel()))
    close(y.asarray().reshape(N, M), A @ X)
    z = Op.rmatvec(y)
    close(z.asarray().reshape(K, M), A.T @ (A @ X))
    xinv = pmtt.cgls(Op, y, x0=_tvec(np.zeros(K * M)), niter=60, tol=0)[0]
    xj = pmt.cgls(jop, _jvec(mesh1, (A @ X).ravel()),
                  x0=_jvec(mesh1, np.zeros(K * M)), niter=60, tol=0)[0]
    close(xinv.asarray(), xj.asarray(), 1e-10)
    close(xinv.asarray().reshape(K, M), X, 1e-8)


def test_plot_summamatrixmult_flow(mesh1):
    """examples/plot_summamatrixmult.py: each kind's forward and adjoint
    against the dense products and the JAX package."""
    rng = np.random.default_rng(0)
    N, K, M = 64, 48, 32
    A = rng.standard_normal((N, K))
    X = rng.standard_normal((K, M))
    for kind in ("summa", "block", "auto"):
        Op = pmtt.MPIMatrixMult(A, M, kind=kind, dtype=np.float64,
                                device=CPU)
        jop = pmt.MPIMatrixMult(A, M, kind=kind, dtype=np.float64,
                                mesh=mesh1)
        Y = Op.matvec(_tvec(X.ravel())).asarray().reshape(N, M)
        close(Y, A @ X)
        close(Y.ravel(), jop.matvec(_jvec(mesh1, X.ravel())).asarray())
        Xadj = Op.rmatvec(_tvec(Y.ravel())).asarray().reshape(K, M)
        close(Xadj, A.T @ (A @ X))


def test_convert_and_tensor_input(rng, mesh1):
    """``convert.matrixmult_from_numpy`` carries the JAX operator's matrix
    and grid; a tensor ``A`` stays on its device and is not copied at a
    world of one."""
    A = rng.standard_normal((10, 7))
    jop = pmt.MPIMatrixMult(A, 3, kind="summa", mesh=mesh1)
    top = pmtt.convert.matrixmult_from_numpy(np.asarray(jop.A), jop.M,
                                             "summa", grid=jop.grid,
                                             device=CPU)
    assert top.grid == jop.grid and top.dtype == torch.float64
    x = rng.standard_normal(21)
    close(top.matvec(_tvec(x)).asarray(),
          jop.matvec(_jvec(mesh1, x)).asarray())
    At = torch.from_numpy(A)
    op = pmtt.MPIMatrixMult(At, 3, kind="summa")
    assert op.A.data_ptr() == At.data_ptr()
    f32 = pmtt.convert.matrixmult_from_numpy(A, 3, "block",
                                             dtype=torch.float32,
                                             device=CPU)
    assert f32.A.dtype == torch.float32 and f32.dtype == torch.float32
    if not torch.cuda.is_available():  # a numpy A goes to "cuda" by default
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pmtt.MPIMatrixMult(A, 3)


def test_positional_order(rng):
    """``MPIMatrixMult(A, M, saveAt, mesh, kind, dtype, grid,
    compute_dtype, schedule, overlap, hierarchical)``, the JAX package's
    order; ``device`` keyword-only; a mesh that is not the process group
    is refused."""
    here = pmtt.parallel.make_mesh(CPU)
    other = pmtt.parallel.Mesh(None, 0, 2, here.device)
    A = rng.standard_normal((8, 6)).astype(np.float32)
    pos = pmtt.MPIMatrixMult(A, 3, False, here, "summa", torch.float32,
                             (1, 1), torch.bfloat16, "stat_a", True, "on",
                             device=CPU)
    kw = pmtt.MPIMatrixMult(A, M=3, saveAt=False, mesh=here, kind="summa",
                            dtype=torch.float32, grid=(1, 1),
                            compute_dtype=torch.bfloat16, schedule="stat_a",
                            overlap=True, hierarchical="on", device=CPU)
    for op in (pos, kw):
        assert (op.M, op.schedule, op.grid, op.A.dtype, op.overlap,
                op.hierarchical) == (3, "stat_a", (1, 1), torch.bfloat16,
                                     True, "on")
    x = _tvec(rng.standard_normal(18).astype(np.float32))
    assert torch.equal(pos.matvec(x).array, kw.matvec(x).array)
    blk = pmtt.MPIMatrixMult(A, 3, True, None, "block", device=CPU)
    assert blk.At is not None
    with pytest.raises(ValueError, match="does not match the process"):
        pmtt.MPIMatrixMult(A, 3, False, other, device=CPU)
    with pytest.raises(TypeError):
        pmtt.MPIMatrixMult(A, 3, False, None, "block", None, None, None,
                           "auto", None, None, CPU)
