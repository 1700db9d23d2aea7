"""The port's MPIVStack, MPIHStack and the local operators of slice 5
(Diagonal, Zero, Transpose, Roll, Flip, Pad, VStack, HStack, BlockDiag)
held against the JAX package: the same numpy blocks and vectors through
both.

Tolerances: float64 throughout. Single applies at rtol 1e-12 of the
largest entry (GEMMs and sums in another order; nothing iterates). CGLS
on a stack at rtol 1e-9 on x and the cost history (20 iterations of a
well-conditioned system). bf16 storage in f32 arithmetic at rtol 1e-6:
both packages widen the same bf16 blocks exactly and sum in f32 in
different orders.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pylops_mpi_tpu as pmt
import pylops_mpi_tpu_torch as pmtt
from pylops_mpi_tpu.ops import local as jl
from pylops_mpi_tpu_torch.ops import local as tl

RTOL = 1e-12
NBLK = 8
CPU = "cpu"


def close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * np.max(np.abs(want)))


def _bcast(x):
    return (pmt.DistributedArray.to_dist(x, partition=pmt.Partition.BROADCAST),
            pmtt.DistributedArray.to_dist(
                x, partition=pmtt.Partition.BROADCAST, device=CPU))


def _scatter(x):
    return (pmt.DistributedArray.to_dist(x),
            pmtt.DistributedArray.to_dist(x, device=CPU))


def _rows(rng, kind):
    """(JAX rows, port rows) of a stack of ``kind``."""
    if kind in ("matrix", "matrix_adjoint", "complex"):
        blocks = [rng.standard_normal((6, 5)) for _ in range(NBLK)]
        if kind == "complex":
            blocks = [b + 1j * rng.standard_normal(b.shape) for b in blocks]
        j = [jl.MatrixMult(b) for b in blocks]
        t = [tl.MatrixMult(b, device=CPU) for b in blocks]
        if kind == "matrix_adjoint":
            return [m.H for m in j], [m.H for m in t]
        return j, t
    # heterogeneous: matrices of several heights, an adjoint, a scaled
    # second derivative, a diagonal
    dims = (3, 5)
    blocks = [rng.standard_normal((s, 15)) for s in (4, 7)]
    adj = rng.standard_normal((15, 6))
    diag = rng.standard_normal(15)
    j = [jl.MatrixMult(blocks[0]), jl.MatrixMult(blocks[1]),
         jl.MatrixMult(adj).H,
         2.0 * jl.SecondDerivative(dims, axis=1, dtype=np.float64),
         jl.Diagonal(jnp.asarray(diag))]
    t = [tl.MatrixMult(blocks[0], device=CPU),
         tl.MatrixMult(blocks[1], device=CPU),
         tl.MatrixMult(adj, device=CPU).H,
         2.0 * tl.SecondDerivative(dims, axis=1, dtype=torch.float64),
         tl.Diagonal(diag, device=CPU)]
    return j, t


def _vec(rng, n, cmplx, *tail):
    x = rng.standard_normal((n,) + tail)
    return x + 1j * rng.standard_normal((n,) + tail) if cmplx else x


KINDS = ["matrix", "matrix_adjoint", "complex", "heterogeneous"]


@pytest.mark.parametrize("kind", KINDS)
def test_vstack_matches_jax(rng, kind):
    """Forward (BROADCAST model → SCATTER data) and adjoint (→ BROADCAST)
    against the JAX package, and the dot test."""
    jrows, trows = _rows(rng, kind)
    jop, top = pmt.MPIVStack(jrows), pmtt.MPIVStack(trows)
    assert top.shape == jop.shape
    assert (top._batched is not None) == (kind != "heterogeneous")
    assert top._batched_adj == (kind == "matrix_adjoint")
    cmplx = kind == "complex"
    jx, tx = _bcast(_vec(rng, jop.shape[1], cmplx))
    ty = top.matvec(tx)
    assert ty.partition == pmtt.Partition.SCATTER
    assert ty.local_shapes == ((top.shape[0],),)
    close(ty.asarray(), jop.matvec(jx).asarray())
    jy, ty = _scatter(_vec(rng, jop.shape[0], cmplx))
    tz = top.rmatvec(ty)
    assert tz.partition == pmtt.Partition.BROADCAST
    close(tz.asarray(), jop.rmatvec(jy).asarray())
    assert pmtt.dottest(top, complexflag=3 if cmplx else 0, rtol=1e-10,
                        device=CPU)


@pytest.mark.parametrize("kind", KINDS)
def test_hstack_matches_jax(rng, kind):
    """The adjoint of a VStack of adjoints: forward SCATTER → BROADCAST,
    adjoint BROADCAST → SCATTER."""
    jrows, trows = _rows(rng, kind)
    jop = pmt.MPIHStack([r.H for r in jrows])
    top = pmtt.MPIHStack([r.H for r in trows])
    assert top.shape == jop.shape
    cmplx = kind == "complex"
    jx, tx = _scatter(_vec(rng, jop.shape[1], cmplx))
    ty = top.matvec(tx)
    assert ty.partition == pmtt.Partition.BROADCAST
    close(ty.asarray(), jop.matvec(jx).asarray())
    jy, ty = _bcast(_vec(rng, jop.shape[0], cmplx))
    close(top.rmatvec(ty).asarray(), jop.rmatvec(jy).asarray())
    assert pmtt.dottest(top, complexflag=3 if cmplx else 0, rtol=1e-10,
                        device=CPU)


@pytest.mark.parametrize("kind", KINDS)
def test_block_vectors_match_jax(rng, kind):
    """(N, K) vectors: one widened product for stacked matrices, the
    column loop for other rows; VStack and HStack both ways."""
    jrows, trows = _rows(rng, kind)
    cmplx = kind == "complex"
    for jop, top in ((pmt.MPIVStack(jrows), pmtt.MPIVStack(trows)),
                     (pmt.MPIHStack([r.H for r in jrows]),
                      pmtt.MPIHStack([r.H for r in trows]))):
        X = _vec(rng, jop.shape[1], cmplx, 3)
        jX, tX = _bcast(X)
        tY = top.matvec(tX)
        assert tY.global_shape == (top.shape[0], 3)
        close(tY.asarray(), jop.matvec(jX).asarray())
        Y = _vec(rng, jop.shape[0], cmplx, 3)
        jY, tY = _scatter(Y)
        close(top.rmatvec(tY).asarray(), jop.rmatvec(jY).asarray())


@pytest.mark.parametrize("adjoint", [False, True])
def test_bf16_storage_matches_jax(rng, adjoint):
    """compute_dtype=bfloat16 stores the stack narrow and widens it for
    the product; vectors stay f32."""
    blocks = [rng.standard_normal((16, 12)).astype(np.float32)
              for _ in range(NBLK)]
    jrows = [jl.MatrixMult(b) for b in blocks]
    jop = pmt.MPIVStack([r.H for r in jrows] if adjoint else jrows,
                        compute_dtype=jnp.bfloat16)
    top = pmtt.convert.vstack_from_numpy(blocks, adjoint=adjoint,
                                         compute_dtype=torch.bfloat16,
                                         device=CPU)
    assert top._batched.dtype == torch.bfloat16
    assert top._batched_adj == adjoint and top.dtype == torch.float32
    x = rng.standard_normal(jop.shape[1]).astype(np.float32)
    jx, tx = _bcast(x)
    ty = top.matvec(tx)
    assert ty.dtype == torch.float32
    close(ty.asarray(), jop.matvec(jx).asarray(), 1e-6)
    y = rng.standard_normal(jop.shape[0]).astype(np.float32)
    jy, ty = _scatter(y)
    close(top.rmatvec(ty).asarray(), jop.rmatvec(jy).asarray(), 1e-6)
    hop = pmtt.convert.hstack_from_numpy(blocks, device=CPU,
                                         compute_dtype=torch.bfloat16)
    assert hop.vstack._batched.dtype == torch.bfloat16
    jh, th = _scatter(rng.standard_normal(hop.shape[1]).astype(np.float32))
    close(hop.matvec(th).asarray(),
          pmt.MPIHStack(jrows, compute_dtype=jnp.bfloat16).matvec(jh)
          .asarray(), 1e-6)


def test_complex_guard_and_deferred_keywords(rng):
    blocks = [rng.standard_normal((4, 3)) + 1j for _ in range(NBLK)]
    with pytest.raises(ValueError, match="imaginary"):
        pmtt.convert.vstack_from_numpy(blocks, compute_dtype=torch.bfloat16,
                                       device=CPU)
    rows = [tl.MatrixMult(b, device=CPU) for b in blocks]
    # mask= has one color per rank (one rank here), stamped on the outputs
    with pytest.raises(ValueError, match="mask must have 1 entries"):
        pmtt.MPIVStack(rows, mask=[0] * NBLK)
    with pytest.raises(ValueError, match="mask must have 1 entries"):
        pmtt.MPIHStack(rows, mask=[0] * NBLK)
    xm = pmtt.DistributedArray.to_dist(_vec(rng, 3, True), device=CPU,
                                       partition=pmtt.Partition.BROADCAST)
    vm = pmtt.MPIVStack(rows, mask=[5])
    ym = vm.matvec(xm)
    assert ym.mask == (5,) and vm.rmatvec(ym).mask == (5,)
    x4 = pmtt.DistributedArray.to_dist(_vec(rng, 4, True), device=CPU,
                                       partition=pmtt.Partition.BROADCAST)
    assert pmtt.MPIHStack(rows, mask=[5]).rmatvec(x4).mask == (5,)
    with pytest.raises(ValueError, match="column size mismatch"):
        pmtt.MPIVStack([tl.MatrixMult(np.ones((2, 3)), device=CPU),
                        tl.MatrixMult(np.ones((2, 4)), device=CPU)])
    # overlap / hierarchical select multi-rank reductions (the ring form
    # of the adjoint, tests/test_torch_overlap.py): in a world of one the
    # bulk product runs either way
    x = pmtt.DistributedArray.to_dist(_vec(rng, 3, True), device=CPU,
                                      partition=pmtt.Partition.BROADCAST)
    ref = pmtt.MPIVStack(rows)
    for kw in (dict(overlap="on"), dict(hierarchical="on"),
               dict(overlap="off", hierarchical="off")):
        op = pmtt.MPIVStack(rows, **kw)
        assert torch.equal(op.matvec(x).array, ref.matvec(x).array)


def test_cgls_on_vstack_matches_jax(rng):
    """CGLS on the overdetermined stack from a BROADCAST zero model: x
    and the cost history against the JAX package (20 iterations)."""
    blocks = [4.0 * np.eye(12) + rng.standard_normal((12, 12)) / 4
              for _ in range(NBLK)]
    jop = pmt.MPIVStack([jl.MatrixMult(b) for b in blocks])
    top = pmtt.convert.vstack_from_numpy(blocks, device=CPU)
    xt = rng.standard_normal(12)
    y = jop.matvec(pmt.DistributedArray.to_dist(
        xt, partition=pmt.Partition.BROADCAST)).asarray()
    jx0, tx0 = _bcast(np.zeros(12))
    jy, ty = _scatter(y)
    jout = pmt.cgls(jop, jy, x0=jx0, niter=20, tol=0.0)
    tout = pmtt.cgls(top, ty, x0=tx0, niter=20, tol=0.0)
    assert tout[2] == int(jout[2])
    close(tout[0].asarray(), jout[0].asarray(), 1e-9)
    close(tout[5].numpy(), np.asarray(jout[5]), 1e-9)
    np.testing.assert_allclose(tout[0].asarray(), xt, rtol=1e-8)


def test_plot_stacking_example():
    """examples/plot_stacking.py through both packages: VStack of scaled
    second derivatives, HStack, BlockDiag, and their dot tests."""
    Ny, Nx = 11, 22
    res = {}
    for pkg, L, kw in ((pmt, jl, {}), (pmtt, tl, dict(device=CPU))):
        D2v = L.SecondDerivative((Ny, Nx), axis=0, dtype=np.float64)
        D2h = L.SecondDerivative((Ny, Nx), axis=1, dtype=np.float64)
        V = pkg.MPIVStack([(i // 2 + 1) * (D2v if i % 2 == 0 else D2h)
                           for i in range(8)])
        x = pkg.DistributedArray.to_dist(np.ones(Ny * Nx),
                                         partition=pkg.Partition.BROADCAST,
                                         **kw)
        yv = V.matvec(x)
        H = pkg.MPIHStack([D2v, D2h] * 4)
        xh = pkg.DistributedArray.to_dist(np.ones(8 * Ny * Nx), **kw)
        yh = H.matvec(xh)
        rng = np.random.default_rng(0)
        B = pkg.MPIBlockDiag([L.MatrixMult(rng.standard_normal((6, 5)), **kw)
                              for _ in range(8)])
        xb = pkg.DistributedArray.to_dist(np.ones(8 * 5), **kw)
        yb = B.matvec(xb)
        for Op, v, w in ((V, x, yv), (B, xb, yb)):
            assert pkg.dottest(Op, v, w.copy())
        assert yv.global_shape == (8 * Ny * Nx,) and yh.global_shape == (
            Ny * Nx,)
        assert yh.partition.name == "BROADCAST"
        res[pkg] = (yv.asarray(), yh.asarray(), yb.asarray())
    for t, j in zip(res[pmtt], res[pmt]):
        close(t, j)


def _local_pairs(rng):
    """(name, JAX op, port op) for every local operator of this slice."""
    dims = (3, 4, 5)
    diag = rng.standard_normal(7) + 1j * rng.standard_normal(7)
    mats = [rng.standard_normal((4, 6)), rng.standard_normal((3, 6)),
            rng.standard_normal((4, 5))]
    pad = ((1, 2), (0, 3), (2, 0))
    return [
        ("diagonal", jl.Diagonal(jnp.asarray(diag)),
         tl.Diagonal(diag, device=CPU)),
        ("zero", jl.Zero(5, 7, dtype=np.float64),
         tl.Zero(5, 7, dtype=torch.float64)),
        ("transpose", jl.Transpose(dims, (2, 0, 1), dtype=np.float64),
         tl.Transpose(dims, (2, 0, 1), dtype=torch.float64)),
        ("roll", jl.Roll(9, shift=3, dtype=np.float64),
         tl.Roll(9, shift=3, dtype=torch.float64)),
        ("flip", jl.Flip(9, dtype=np.float64),
         tl.Flip(9, dtype=torch.float64)),
        ("pad", jl.Pad(dims, pad, dtype=np.float64),
         tl.Pad(dims, pad, dtype=torch.float64)),
        ("pad1d", jl.Pad(6, (2, 1), dtype=np.float64),
         tl.Pad(6, (2, 1), dtype=torch.float64)),
        ("vstack", jl.VStack([jl.MatrixMult(mats[0]),
                              jl.MatrixMult(mats[1])]),
         tl.VStack([tl.MatrixMult(mats[0], device=CPU),
                    tl.MatrixMult(mats[1], device=CPU)])),
        ("hstack", jl.HStack([jl.MatrixMult(mats[0]),
                              jl.MatrixMult(mats[2])]),
         tl.HStack([tl.MatrixMult(mats[0], device=CPU),
                    tl.MatrixMult(mats[2], device=CPU)])),
        ("blockdiag", jl.BlockDiag([jl.MatrixMult(mats[1]),
                                    jl.Flip(4, dtype=np.float64)]),
         tl.BlockDiag([tl.MatrixMult(mats[1], device=CPU),
                       tl.Flip(4, dtype=torch.float64)])),
    ]


@pytest.mark.parametrize("name", [p[0] for p in
                                  _local_pairs(np.random.default_rng(0))])
def test_local_operators_match_jax(rng, name):
    """Forward and adjoint against the JAX package's local operator, and
    the dot test ``<A u, v> = <u, Aᴴ v>``."""
    _, jop, top = next(p for p in _local_pairs(rng) if p[0] == name)
    assert top.shape == jop.shape and top.dims == jop.dims \
        and top.dimsd == jop.dimsd
    cmplx = name == "diagonal"
    u = _vec(rng, top.shape[1], cmplx)
    v = _vec(rng, top.shape[0], cmplx)
    tu = top.matvec(torch.from_numpy(u)).numpy()
    tv = top.rmatvec(torch.from_numpy(v)).numpy()
    if name == "zero":
        assert not tu.any() and not tv.any()
        assert tu.shape == (5,) and tv.shape == (7,)
    else:
        close(tu, np.asarray(jop.matvec(jnp.asarray(u))))
        close(tv, np.asarray(jop.rmatvec(jnp.asarray(v))))
    np.testing.assert_allclose(np.vdot(v, tu), np.vdot(tv, u), rtol=1e-12,
                               atol=1e-12)
