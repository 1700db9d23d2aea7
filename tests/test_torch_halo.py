"""The port's halo_block_split, MPIHalo, the local
NonStationaryConvolve1D and MPINonStationaryConvolve1D held against the
JAX package: the same numpy fields and filters through both.

The port has one worker, so MPIHalo is held against the JAX package on
a one-device mesh (the same Cartesian layout), and the non-stationary
convolution factory against the JAX factory on the 8-device mesh (the
global operator is the same across layouts).

Tolerances: float64 throughout. The halo's pads and crops are copies
and are compared exactly. Convolutions at rtol 1e-12 of the largest
entry (the port's banded product sums the taps in another order than
the JAX package's shifted passes); the interpolated filter bank at
rtol 1e-15 (one linear blend per entry).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pylops_mpi_tpu as pmt
import pylops_mpi_tpu_torch as pmtt
from pylops_mpi_tpu.models import ricker
from pylops_mpi_tpu.ops import local as jl
from pylops_mpi_tpu.ops.halo import halo_block_split as jsplit
from pylops_mpi_tpu_torch.ops import local as tl

RTOL = 1e-12
CPU = "cpu"


def close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * np.max(np.abs(want)))


@pytest.fixture(scope="module")
def mesh1():
    return pmt.make_mesh(1)


def _pair(x, mesh=None):
    return (pmt.DistributedArray.to_dist(x, mesh=mesh),
            pmtt.DistributedArray.to_dist(x, device=CPU))


@pytest.mark.parametrize("shape,grid", [
    ((10,), (3,)), ((7, 9), (2, 4)), ((5, 6, 11), (1, 2, 3)),
    ((16, 4), None)])
def test_halo_block_split_matches_jax(shape, grid):
    n = int(np.prod(grid)) if grid else 4
    for r in range(n):
        if grid is None:
            assert pmtt.halo_block_split(shape, r, n_shards=n) == jsplit(
                shape, r, n_shards=n)
        else:
            assert pmtt.halo_block_split(shape, r, grid) == jsplit(
                shape, r, grid)
    for bad in (-1, n):
        with pytest.raises(ValueError, match="outside grid"):
            pmtt.halo_block_split(shape, bad, grid or (1,) * (len(shape) - 1)
                                  + (n,))
    with pytest.raises(ValueError, match="required"):
        pmtt.halo_block_split(shape, 0)


HALOS = {  # name -> halo for 1-D, 2-D and 3-D dims
    "scalar": (2, 2, 1),
    "per_axis": ((2,), (1, 2), (1, 0, 2)),
    "minus_plus": ((1, 3), (0, 2, 3, 1), (1, 0, 2, 2, 0, 1)),
}
DIMS = [(12,), (6, 7), (4, 5, 3)]


def _halo_oracle(x, dims, halo):
    """numpy's pad of the field by (minus, plus) per axis: what one
    worker's haloed block holds."""
    return np.pad(x.reshape(dims), [(halo[2 * a], halo[2 * a + 1])
                                    for a in range(len(dims))]).ravel()


@pytest.mark.parametrize("kind", sorted(HALOS))
@pytest.mark.parametrize("nd", [0, 1, 2])
def test_halo_matches_jax(rng, mesh1, kind, nd):
    """The per-rank geometry tables against the JAX package's on one
    device; forward (pad with the neighbours' data, zeros at the
    domain's edges) and adjoint (crop) against the JAX package's applies
    for one halo kind per dimension (each costs seconds of JAX compile)
    and against numpy's pad and crop for all."""
    dims, halo = DIMS[nd], HALOS[kind][nd]
    jop = pmt.MPIHalo(dims, halo, mesh=mesh1, dtype=np.float64)
    top = pmtt.MPIHalo(dims, halo, dtype=np.float64)
    assert top.shape == jop.shape and top.dims == jop.dims
    assert top.proc_grid_shape == jop.proc_grid_shape == (1,) * len(dims)
    for attr in ("block_slices", "halos", "local_dims_all", "extents",
                 "local_dim_sizes", "local_extent_sizes"):
        assert list(getattr(top, attr)) == list(getattr(jop, attr)), attr
    x = rng.standard_normal(int(np.prod(dims)))
    jx, tx = _pair(x, mesh1)
    ty = top.matvec(tx)
    assert ty.partition == pmtt.Partition.SCATTER
    assert ty.local_shapes == top.local_extent_sizes
    np.testing.assert_array_equal(ty.asarray(),
                                  _halo_oracle(x, dims, top.halos[0]))
    if kind == "scalar":  # trimmed at the edges: the identity
        np.testing.assert_array_equal(ty.asarray(), x)
    yv = rng.standard_normal(top.shape[0])
    jy, ty = _pair(yv, mesh1)
    tz = top.rmatvec(ty)
    ext, h = top.extents[0], top.halos[0]
    np.testing.assert_array_equal(tz.asarray(), yv.reshape(ext)[tuple(
        slice(h[2 * a], h[2 * a] + d) for a, d in enumerate(dims))].ravel())
    np.testing.assert_array_equal(top.rmatvec(top.matvec(tx)).asarray(), x)
    if sorted(HALOS).index(kind) == nd:
        np.testing.assert_array_equal(top.matvec(tx).asarray(),
                                      jop.matvec(jx).asarray())
        np.testing.assert_array_equal(tz.asarray(), jop.rmatvec(jy).asarray())


def test_halo_checks(mesh1):
    with pytest.raises(ValueError, match="does not match mesh size 1"):
        pmtt.MPIHalo((8, 4), 1, proc_grid_shape=(2, 1))
    with pytest.raises(ValueError, match="does not match mesh size 1"):
        pmt.MPIHalo((8, 4), 1, proc_grid_shape=(2, 1), mesh=mesh1)
    with pytest.raises(ValueError, match="Invalid halo length"):
        pmtt.MPIHalo((8, 4), (1, 2, 3))
    with pytest.raises(ValueError, match="non-negative"):
        pmtt.MPIHalo((8, 4), (1, -1))
    op = pmtt.MPIHalo((8, 4), (1, 1))
    with pytest.raises(ValueError, match="partition"):
        op.matvec(pmtt.DistributedArray.to_dist(
            np.ones(32), partition=pmtt.Partition.BROADCAST, device=CPU))
    with pytest.raises(ValueError, match="partition"):
        op.rmatvec(pmtt.DistributedArray.to_dist(
            np.ones(op.shape[0]), partition=pmtt.Partition.BROADCAST,
            device=CPU))


def _sandwich(pkg, L, dims, halo, **kw):
    H = pkg.MPIHalo(dims, halo, dtype=np.float64, **kw)
    D = L.FirstDerivative(H.extents[0], axis=0, kind="forward",
                          dtype=np.float64 if pkg is pmt else torch.float64)
    return H.H @ pkg.MPIBlockDiag([D], **kw) @ H


def test_halo_sandwich_matches_jax(rng, mesh1):
    """``HOp.H @ MPIBlockDiag([FirstDerivative(extent)]) @ HOp``
    (examples/plot_halo.py's construction) against the JAX package's
    sandwich on one device, for (minus, plus) halos."""
    dims, halo = (9, 6), (2, 1, 0, 3)
    jop = _sandwich(pmt, jl, dims, halo, mesh=mesh1)
    top = _sandwich(pmtt, tl, dims, halo)
    x = rng.standard_normal(int(np.prod(dims)))
    jx, tx = _pair(x, mesh1)
    close(top.matvec(tx).asarray(), jop.matvec(jx).asarray())
    close(top.rmatvec(tx).asarray(), jop.rmatvec(jx).asarray())


@pytest.mark.parametrize("halo", [1, (1, 0), (2, 1, 0, 3)])
def test_halo_sandwich_first_derivative(rng, halo):
    """The sandwich is the derivative of the zero-filled haloed field,
    cropped: with the identity (scalar) halo the serial derivative."""
    dims = (9, 6)
    top = _sandwich(pmtt, tl, dims, halo)
    H = top.args[1]
    D = tl.FirstDerivative(H.extents[0], axis=0, kind="forward",
                           dtype=torch.float64)
    x = rng.standard_normal(int(np.prod(dims)))
    tx = pmtt.DistributedArray.to_dist(x, device=CPU)
    want = D.matvec(torch.from_numpy(_halo_oracle(x, dims, H.halos[0])))
    close(top.matvec(tx).asarray(),
          H.rmatvec(pmtt.DistributedArray.to_dist(want)).asarray())
    if halo == 1:
        serial = tl.FirstDerivative(dims, axis=0, kind="forward",
                                    dtype=torch.float64)
        close(top.matvec(tx).asarray(),
              serial.matvec(torch.from_numpy(x)).numpy())
    assert pmtt.dottest(top.args[0].args[1], rtol=1e-12, device=CPU)


def _filters(rng, nfilt, nh):
    return rng.standard_normal((nfilt, nh))


def test_local_nonstatconv_oracle(rng):
    """tests/test_halo.py:166's brute-force spreading oracle, and the
    JAX package's local operator."""
    n, nh = 16, 5
    hs = _filters(rng, 4, nh)
    ih = np.array([2, 6, 10, 14])
    op = tl.NonStationaryConvolve1D((n,), hs, ih, dtype=torch.float64,
                                    device=CPU)
    jop = jl.NonStationaryConvolve1D((n,), hs, ih, dtype=np.float64)
    close(op.Hbank.numpy(), np.asarray(jop.Hbank), 1e-15)
    x = rng.standard_normal(n)
    y = op.matvec(torch.from_numpy(x)).numpy()
    expected = np.zeros(n)
    Hmat = op.Hbank.numpy()
    for i in range(n):
        for j in range(nh):
            k = i - nh // 2 + j
            if 0 <= k < n:
                expected[k] += Hmat[i, j] * x[i]
    np.testing.assert_allclose(y, expected, rtol=1e-12)
    close(y, np.asarray(jop.matvec(jnp.asarray(x))))
    u, v = rng.standard_normal(n), rng.standard_normal(n)
    np.testing.assert_allclose(
        np.vdot(op.matvec(torch.from_numpy(u)).numpy(), v),
        np.vdot(u, op.rmatvec(torch.from_numpy(v)).numpy()), rtol=1e-10)


@pytest.mark.parametrize("dims,axis,nh,ih", [
    ((100,), 0, 7, np.arange(5, 95, 10)),        # tiles of 64, ragged end
    ((130, 3), 0, 9, np.arange(20, 120, 25)),    # nearest filter at ends
    ((4, 37), 1, 5, np.array([3, 9, 15, 21])),   # a trailing axis
    ((3, 20, 2), 1, 11, np.array([10])),         # one filter
    ((5,), 0, 9, np.array([1, 3])),              # filter wider than n
])
def test_local_nonstatconv_matches_jax(rng, dims, axis, nh, ih):
    hs = _filters(rng, len(ih), nh) + 1j * _filters(rng, len(ih), nh)
    op = tl.NonStationaryConvolve1D(dims, hs, ih, axis=axis, device=CPU)
    jop = jl.NonStationaryConvolve1D(dims, hs, ih, axis=axis)
    assert op.dtype == torch.complex128
    close(op.Hbank.numpy(), np.asarray(jop.Hbank), 1e-15)
    x = rng.standard_normal(op.shape[1]) + 1j * rng.standard_normal(
        op.shape[1])
    close(op.matvec(torch.from_numpy(x)).numpy(),
          np.asarray(jop.matvec(jnp.asarray(x))))
    close(op.rmatvec(torch.from_numpy(x)).numpy(),
          np.asarray(jop.rmatvec(jnp.asarray(x))))


def test_nonstatconv_checks():
    hs = np.ones((3, 5))
    with pytest.raises(ValueError, match="odd length"):
        pmtt.MPINonStationaryConvolve1D(16, np.ones((3, 4)), [1, 5, 9],
                                        device=CPU)
    with pytest.raises(ValueError, match="regularly sampled"):
        pmtt.MPINonStationaryConvolve1D(16, hs, [1, 5, 10], device=CPU)
    with pytest.raises(ValueError, match="larger than 0"):
        pmtt.MPINonStationaryConvolve1D(16, hs, [4, 10, 16], device=CPU)
    with pytest.raises(NotImplementedError, match="axis == 0"):
        pmtt.MPINonStationaryConvolve1D((4, 16), hs, [1, 5, 9], axis=1,
                                        device=CPU)
    with pytest.raises(ValueError, match="odd length"):
        tl.NonStationaryConvolve1D(16, np.ones((3, 4)), [1, 5, 9],
                                   device=CPU)


def _nonstat_case(rng, case):
    if case == "example":  # examples/plot_nonstatconv.py
        t = np.arange(17) * 0.004
        hs = np.stack([ricker(t[:9], f0=f)[0]
                       for f in np.linspace(10.0, 40.0, 17)])
        return 256, hs, np.linspace(8, 248, 17).astype(int)
    if case == "nd":
        return (64, 5), _filters(rng, 8, 5), np.arange(4, 64, 8)
    # nh 7 at spacing 4: the case where the JAX package widened the
    # reference's one-filter window
    return 64, _filters(rng, 16, 7), np.arange(2, 64, 4)


def test_distributed_nonstatconv_matches_jax(rng):
    """examples/plot_nonstatconv.py: the port at one worker against the
    JAX factory on the 8-device mesh, forward and adjoint."""
    dims, hs, ih = _nonstat_case(rng, "example")
    jop = pmt.MPINonStationaryConvolve1D(dims, hs, ih, dtype=np.float64)
    top = pmtt.MPINonStationaryConvolve1D(dims, hs, ih, dtype=np.float64,
                                          device=CPU)
    assert top.shape == jop.shape
    x = np.zeros(dims)
    x[np.arange(16, dims, 32)] = 1.0  # the example's spike train
    for fn, v in (("matvec", x), ("rmatvec", rng.standard_normal(dims))):
        jv, tv = _pair(v)
        ty = getattr(top, fn)(tv)
        assert ty.partition == pmtt.Partition.SCATTER
        close(ty.asarray(), getattr(jop, fn)(jv).asarray())


@pytest.mark.parametrize("case", ["example", "nd", "wide_halo"])
def test_distributed_nonstatconv_is_the_serial_operator(rng, case):
    """At one worker the factory is the JAX package's serial operator
    (the oracle of tests/test_halo.py's distributed test), and passes
    the dot test."""
    dims, hs, ih = _nonstat_case(rng, case)
    top = pmtt.MPINonStationaryConvolve1D(dims, hs, ih, axis=0,
                                          dtype=np.float64, device=CPU)
    serial = jl.NonStationaryConvolve1D(dims, hs, ih, axis=0,
                                        dtype=np.float64)
    n = int(np.prod(dims))
    for fn in ("matvec", "rmatvec"):
        x = rng.standard_normal(n)
        close(getattr(top, fn)(pmtt.DistributedArray.to_dist(
            x, device=CPU)).asarray(),
            np.asarray(getattr(serial, fn)(jnp.asarray(x))))
    assert pmtt.dottest(top, rtol=1e-10, device=CPU)


@pytest.mark.cuda
def test_nonstatconv_on_card(rng):
    """On the card: the banded batched product against the CPU's in
    f64, and in f32 against the JAX package's shifted-pass formulation
    written in torch (rtol 1e-6 of the largest entry)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card, not here)")
    dims, hs, ih = (300, 7), _filters(rng, 8, 9), np.arange(10, 290, 35)
    x = rng.standard_normal(int(np.prod(dims)))
    outs = []
    for dev in ("cuda", CPU):
        op = tl.NonStationaryConvolve1D(dims, hs, ih, axis=0,
                                        dtype=torch.float64, device=dev)
        xt = torch.from_numpy(x).to(dev)
        outs.append((op.matvec(xt).cpu().numpy(),
                     op.rmatvec(xt).cpu().numpy()))
    for got, want in zip(*outs):
        close(got, want)
    op = tl.NonStationaryConvolve1D(dims, hs, ih, axis=0,
                                    dtype=torch.float32, device="cuda")
    v = torch.from_numpy(x).float().cuda().view(dims)
    n, nh = op.Hbank.shape
    shifted = torch.zeros((n + nh - 1, dims[1]), device="cuda")
    for j in range(nh):
        shifted[j:j + n] += op.Hbank[:, j:j + 1] * v
    close(op.matvec(v.reshape(-1)).cpu().numpy(),
          shifted[nh // 2:nh // 2 + n].reshape(-1).cpu().numpy(), 1e-6)
