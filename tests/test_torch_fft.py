"""The port's pencil FFTs (``MPIFFTND``, ``MPIFFT2D``) and distributed
fftshifts at a world of one rank, held against the JAX package on a
one-device mesh: complex and real transforms, ``norm`` ``"none"`` and
``"1/n"``, ``nffts`` padding, per-axis shifts, the generic path
(``axes[-1] == 0``, 1-D), real dtypes that take ``.real``, the sample
frequencies ``fs``, the norm errors, the adjoint identities,
``fftshift_nd``/``ifftshift_nd``, the flow of ``examples/plot_ffts.py``
and the constructors' positional order; and that no module of the port,
nor ``chip_smoke.py``, imports JAX or the JAX package.

Tolerances: rtol 1e-12 of the largest reference entry in f64 and
complex128 (the packages' FFTs sum in different orders); 1e-5 in
complex64.
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import pylops_mpi_tpu as pmt
import pylops_mpi_tpu_torch as pmtt

CPU = "cpu"
ROOT = Path(__file__).resolve().parent.parent

CONFIGS = [
    dict(dims=(16, 12, 9), axes=(0, 1)),
    dict(dims=(16, 12, 9), axes=(0, 1, 2), norm="1/n"),
    dict(dims=(16, 12, 9), axes=(0, 1, 2), real=True, dtype="float64"),
    dict(dims=(16, 12), axes=(0, 1), real=True, dtype="float64",
         fftshift_after=(True, False)),
    dict(dims=(15, 10), axes=(0, 1), nffts=(20, 13), real=True,
         dtype="float64", ifftshift_before=True, norm="1/N"),
    dict(dims=(9, 8, 7), axes=(2, 0), nffts=(12, 11),
         ifftshift_before=(True, False), fftshift_after=(False, True)),
    dict(dims=(7, 10), axes=(1, 0), real=True, dtype="float64"),
    dict(dims=(33,), axes=(0,), real=True, dtype="float64", nffts=(40,)),
    dict(dims=(32,), axes=(0,), fftshift_after=True, sampling=0.5),
    dict(dims=(8, 6, 5), axes=(1,), ifftshift_before=True,
         dtype="float64"),
    dict(dims=(6, 5, 4), axes=(0, 2), dtype="complex64"),
]


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


def _ops(mesh1, kw):
    jcls, tcls = ((pmt.MPIFFT2D, pmtt.MPIFFT2D) if len(kw["dims"]) == 2
                  else (pmt.MPIFFTND, pmtt.MPIFFTND))
    return jcls(mesh=mesh1, **kw), tcls(**kw)


def _model(rng, kw, n):
    x = rng.standard_normal(n)
    if np.dtype(kw.get("dtype", "complex128")).kind == "c":
        x = x + 1j * rng.standard_normal(n)
    return x.astype(np.result_type(kw.get("dtype", "complex128")))


def _tol(kw):
    return 1e-5 if kw.get("dtype") == "complex64" else 1e-12


@pytest.mark.parametrize("kw", CONFIGS, ids=[str(i) for i in
                                             range(len(CONFIGS))])
def test_matches_jax(rng, mesh1, kw):
    jop, top = _ops(mesh1, kw)
    assert top.shape == jop.shape
    assert (top.dims, top.dimsd) == (jop.dims, jop.dimsd)
    assert (top._in_axis, top._out_axis) == (jop._in_axis, jop._out_axis)
    assert top.model_local_shapes == jop.model_local_shapes
    assert top.data_local_shapes == jop.data_local_shapes
    assert str(top.cdtype).split(".")[1] == str(np.dtype(jop.cdtype))
    assert str(top.rdtype).split(".")[1] == str(np.dtype(jop.rdtype))
    assert top.clinear == jop.clinear
    assert top.nffts == jop.nffts and top.norm == jop.norm
    for a, b in zip(top.fs, jop.fs):
        np.testing.assert_array_equal(a, b)
    x = _model(rng, kw, top.shape[1])
    y = top.matvec(pmtt.DistributedArray.to_dist(x, device=CPU))
    yj = jop.matvec(pmt.DistributedArray.to_dist(x, mesh=mesh1))
    close(y.asarray(), yj.asarray(), _tol(kw))
    assert y.local_shapes == yj.local_shapes
    assert str(y.dtype).split(".")[1] == str(yj.dtype)
    v = rng.standard_normal(top.shape[0]) \
        + 1j * rng.standard_normal(top.shape[0])
    v = v.astype(np.dtype(jop.cdtype))
    xa = top.rmatvec(pmtt.DistributedArray.to_dist(v, device=CPU))
    xj = jop.rmatvec(pmt.DistributedArray.to_dist(v, mesh=mesh1))
    close(xa.asarray(), xj.asarray(), _tol(kw))
    assert xa.local_shapes == xj.local_shapes
    assert str(xa.dtype).split(".")[1] == str(xj.dtype)


@pytest.mark.parametrize("kw", CONFIGS, ids=[str(i) for i in
                                             range(len(CONFIGS))])
def test_adjoint_identity(rng, mesh1, kw):
    """``<Op x, v> = <x, Opᴴ v>``: for a real model its real part (the
    imaginary part of the data side has no counterpart), else in full."""
    _, top = _ops(mesh1, kw)
    x = _model(rng, kw, top.shape[1])
    v = rng.standard_normal(top.shape[0]) \
        + 1j * rng.standard_normal(top.shape[0])
    y = top.matvec(pmtt.DistributedArray.to_dist(x, device=CPU)).asarray()
    xa = top.rmatvec(pmtt.DistributedArray.to_dist(
        v.astype(np.result_type(v, y)), device=CPU)).asarray()
    lhs, rhs = np.vdot(y, v), np.vdot(x, xa)
    if top.clinear:
        np.testing.assert_allclose(lhs, rhs, rtol=_tol(kw) * 10)
    else:
        np.testing.assert_allclose(lhs.real, rhs.real, rtol=_tol(kw) * 10)


def test_dottest_and_round_trip(rng):
    """``dottest`` on complex transforms; ``rmatvec(matvec(x)) / N``
    recovers ``x`` for ``norm="none"``."""
    for kw in (dict(dims=(8, 6, 5), axes=(0, 1, 2)),
               dict(dims=(9, 4), axes=(1, 0)),
               dict(dims=(20,), axes=(0,), nffts=(20,))):
        op = pmtt.MPIFFTND(**kw)
        assert pmtt.dottest(op, complexflag=3, rtol=1e-12, device=CPU)
        x = rng.standard_normal(op.shape[1]) \
            + 1j * rng.standard_normal(op.shape[1])
        xd = pmtt.DistributedArray.to_dist(x, device=CPU)
        close(op.rmatvec(op.matvec(xd)).asarray() / op._scale, x)


def test_norm_errors_and_options(mesh1):
    with pytest.raises(ValueError, match='use "none"'):
        pmtt.MPIFFTND((4, 4), axes=(0, 1), norm="backward")
    with pytest.raises(ValueError, match='use "1/n"'):
        pmtt.MPIFFTND((4, 4), axes=(0, 1), norm="forward")
    with pytest.raises(ValueError, match="norm must be"):
        pmtt.MPIFFTND((4, 4), axes=(0, 1), norm="ortho")
    with pytest.raises(ValueError, match="exactly two axes"):
        pmtt.MPIFFT2D((4, 4, 4), axes=(0, 1, 2))
    with pytest.raises(ValueError, match="comm_chunks=0"):
        pmtt.MPIFFTND((4, 4), axes=(0, 1), comm_chunks=0)
    with pytest.raises(ValueError, match="expected 2 values"):
        pmtt.MPIFFTND((4, 4), axes=(0, 1), nffts=(4, 4, 4))
    op = pmtt.MPIFFTND((4, 4), axes=(0, 1))
    with pytest.raises(NotImplementedError, match="§A.5"):
        op.matvec_planes(None)
    with pytest.raises(NotImplementedError, match="§A.5"):
        op.rmatvec_planes(None)
    x = pmtt.DistributedArray.to_dist(np.ones(16), device=CPU,
                                      partition=pmtt.Partition.BROADCAST)
    with pytest.raises(ValueError, match="partition=Partition.SCATTER"):
        op.matvec(x)


@pytest.mark.parametrize("axes", [None, (0,), (1, 2)])
@pytest.mark.parametrize("inverse", [False, True])
def test_fft_helper_matches_jax(rng, mesh1, axes, inverse):
    from pylops_mpi_tpu.utils import fft_helper as jh
    g = rng.standard_normal((7, 6, 5))
    jx = pmt.DistributedArray.to_dist(g, mesh=mesh1, axis=1)
    tx = pmtt.DistributedArray.to_dist(g, device=CPU, axis=1)
    fn = "ifftshift_nd" if inverse else "fftshift_nd"
    got = getattr(pmtt.utils, fn)(tx, axes=axes)
    want = getattr(jh, fn)(jx, axes=axes)
    np.testing.assert_array_equal(got.asarray(), want.asarray())
    assert (got.axis, got.local_shapes) == (1, tx.local_shapes)
    shift = np.fft.ifftshift if inverse else np.fft.fftshift
    np.testing.assert_array_equal(got.asarray(), shift(g, axes=axes))


def test_plot_ffts_flow(mesh1):
    """examples/plot_ffts.py: a complex FFT over two axes of a cube, its
    round trip, the real 2-D transform, and the dot test."""
    dims = (16, 12, 9)
    rng = np.random.default_rng(7)
    x = rng.standard_normal(dims) + 1j * rng.standard_normal(dims)
    Fop = pmtt.MPIFFTND(dims, axes=(0, 1), dtype=np.complex128)
    xd = pmtt.DistributedArray.to_dist(x.ravel(), device=CPU)
    y = Fop.matvec(xd)
    close(y.asarray().reshape(dims), np.fft.fftn(x, axes=(0, 1)))
    xb = Fop.rmatvec(y)
    close(xb.asarray().reshape(dims) / (dims[0] * dims[1]), x)
    Frop = pmtt.MPIFFT2D((16, 12), real=True, dtype=np.float64)
    xr = rng.standard_normal((16, 12))
    yr = Frop.matvec(pmtt.DistributedArray.to_dist(xr.ravel(), device=CPU))
    assert yr.global_shape == (16 * 7,)
    jr = pmt.MPIFFT2D((16, 12), real=True, dtype=np.float64, mesh=mesh1)
    close(yr.asarray(), jr.matvec(pmt.DistributedArray.to_dist(
        xr.ravel(), mesh=mesh1)).asarray())
    assert pmtt.dottest(Fop, xd, y.copy(), rtol=1e-12)


def test_positional_order():
    """``MPIFFTND(dims, axes, nffts, sampling, norm, real,
    ifftshift_before, fftshift_after, mesh, dtype, overlap, comm_chunks,
    hierarchical)``, the JAX package's order (``MPIFFT2D`` alike); a mesh
    that is not the process group is refused."""
    here = pmtt.parallel.make_mesh(CPU)
    other = pmtt.parallel.Mesh(None, 0, 2, here.device)
    args = ((6, 8), (0, 1), (8, 10), (0.5, 2.0), "1/n", True, (True, False),
            (False, True), here, "float32", True, 2, "on")
    for cls in (pmtt.MPIFFTND, pmtt.MPIFFT2D):
        pos = cls(*args)
        kw = cls(dims=(6, 8), axes=(0, 1), nffts=(8, 10),
                 sampling=(0.5, 2.0), norm="1/n", real=True,
                 ifftshift_before=(True, False),
                 fftshift_after=(False, True), mesh=here, dtype="float32",
                 overlap=True, comm_chunks=2, hierarchical="on")
        for op in (pos, kw):
            assert (op.nffts, op.sampling, op.norm, op.real) == \
                ((8, 10), (0.5, 2.0), "1/n", True)
            assert list(op.ifftshift_before) == [True, False]
            assert list(op.fftshift_after) == [False, True]
            assert (op.cdtype, op.rdtype) == (torch.complex64,
                                              torch.float32)
            assert (op.overlap, op.comm_chunks, op.hierarchical) == \
                (True, 2, "on")
        x = pmtt.DistributedArray.to_dist(
            np.arange(48, dtype=np.float32), device=CPU)
        assert torch.equal(pos.matvec(x).array, kw.matvec(x).array)
        with pytest.raises(ValueError, match="does not match the process"):
            cls(*args[:8], other)


def test_port_imports_no_jax():
    """Importing every module of the port pulls in neither JAX nor the
    JAX package, and ``chip_smoke.py`` imports neither."""
    code = (
        "import importlib, pkgutil, sys, pylops_mpi_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'pylops_mpi_tpu')]\n"
        "assert not bad, bad\n"
        "assert 'pylops_mpi_tpu_torch.ops.fft' in sys.modules\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    assert not {n for n in names
                if n.split(".")[0] in ("jax", "jaxlib", "pylops_mpi_tpu")}
