"""The port's derivative operators held against the JAX package's: the
same numpy vectors through ``pylops_mpi_tpu`` (on the 8-device test
mesh, where the dims below are large enough for its explicit halo path)
and through ``pylops_mpi_tpu_torch`` (one device, the tap kernel's plain
version on the CPU).

Tolerance: float64, rtol 1e-12 of the largest entry (the two packages
sum the taps in different orders; nothing else differs). Each operator
also passes the port's own dottest.
"""

import numpy as np
import pytest
import torch

import pylops_mpi_tpu as pmt
import pylops_mpi_tpu_torch as pmtt
from pylops_mpi_tpu.ops import local as jlocal
from pylops_mpi_tpu_torch.ops import local as tlocal
from pylops_mpi_tpu_torch.ops import stencil_kernels as sk

RTOL = 1e-12
DIMS = [(64, 12), (40, 6, 5)]

# (name, kwargs): every kind, order and edge of the first derivative,
# every kind and edge of the second. ``edge`` changes only the centered
# stencils (the forward and backward specs have no edge rows), so the
# one-sided kinds run with edge=False against the JAX package and
# test_edge_ignored_by_one_sided_kinds covers edge=True.
FIRST = [(f"{k}-o{o}-e{int(e)}", dict(kind=k, order=o, edge=e))
         for k in ("forward", "backward", "centered")
         for o in ((3, 5) if k == "centered" else (3,))
         for e in ((False, True) if k == "centered" else (False,))]
SECOND = [(f"{k}-e{int(e)}", dict(kind=k, edge=e))
          for k in ("forward", "backward", "centered")
          for e in ((False, True) if k == "centered" else (False,))]
# each case runs on one of the dims, alternating, so that both the 2-D
# and the 3-D layout meet every kind (each JAX apply compiles a
# shard_map program: running every case on both would double the file's
# time for no new path)
FIRST_CASES = [(n, kw, DIMS[i % 2]) for i, (n, kw) in enumerate(FIRST)]
SECOND_CASES = [(n, kw, DIMS[(i + 1) % 2]) for i, (n, kw) in enumerate(SECOND)]


def close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * np.max(np.abs(want)))


def _ops(kind, dims, kw):
    if kind == "first":
        return (pmt.MPIFirstDerivative(dims, sampling=0.7, **kw),
                pmtt.MPIFirstDerivative(dims, sampling=0.7, **kw))
    if kind == "second":
        return (pmt.MPISecondDerivative(dims, sampling=0.7, **kw),
                pmtt.MPISecondDerivative(dims, sampling=0.7, **kw))
    if kind == "gradient":
        s = (0.5, 2.0, 1.5)[:len(dims)]
        return (pmt.MPIGradient(dims, sampling=s, **kw),
                pmtt.MPIGradient(dims, sampling=s, **kw))
    return (pmt.MPILaplacian(dims, axes=(0, 1), weights=(1, 2),
                             sampling=(1, 0.5), **kw),
            pmtt.MPILaplacian(dims, axes=(0, 1), weights=(1, 2),
                              sampling=(1, 0.5), **kw))


def _data(y):
    """The numpy components of a JAX (possibly stacked) data vector."""
    if isinstance(y, pmt.StackedDistributedArray):
        return [_data(d) for d in y.distarrays]
    return y.asarray()


def _check(jop, top, rng, dims):
    x = rng.standard_normal(int(np.prod(dims)))
    jy = jop.matvec(pmt.DistributedArray.to_dist(x))
    ty = top.matvec(pmtt.DistributedArray.to_dist(x, device="cpu"))
    close(ty.asarray(), jy.asarray())
    # the adjoint on a random data vector of the operator's structure
    comps = _data(jy)
    rand = (lambda c: [rand(e) for e in c] if isinstance(c, list)
            else rng.standard_normal(c.shape))
    v = rand(comps)
    if isinstance(jy, pmt.StackedDistributedArray):
        jv = pmt.StackedDistributedArray(
            [pmt.DistributedArray.to_dist(c) for c in v])
        tv = pmtt.convert.stacked_from_numpy(v, device="cpu")
    else:
        jv = pmt.DistributedArray.to_dist(v)
        tv = pmtt.DistributedArray.to_dist(v, device="cpu")
    close(top.rmatvec(tv).asarray(), jop.rmatvec(jv).asarray())
    assert pmtt.dottest(top, rtol=1e-10, device="cpu")


@pytest.mark.parametrize("name,kw,dims", FIRST_CASES)
def test_first_derivative(rng, name, kw, dims):
    _check(*_ops("first", dims, kw), rng, dims)


@pytest.mark.parametrize("name,kw,dims", SECOND_CASES)
def test_second_derivative(rng, name, kw, dims):
    _check(*_ops("second", dims, kw), rng, dims)


@pytest.mark.parametrize("edge,dims", [(False, DIMS[0]), (True, DIMS[1])])
def test_gradient(rng, edge, dims):
    _check(*_ops("gradient", dims, dict(edge=edge)), rng, dims)


@pytest.mark.parametrize("dims", DIMS)
def test_laplacian(rng, dims):
    _check(*_ops("laplacian", dims, {}), rng, dims)


@pytest.mark.parametrize("kind", ["forward", "backward"])
@pytest.mark.parametrize("second", [False, True])
def test_edge_ignored_by_one_sided_kinds(rng, kind, second):
    dims = DIMS[1]
    cls = pmtt.MPISecondDerivative if second else pmtt.MPIFirstDerivative
    x = pmtt.DistributedArray.to_dist(rng.standard_normal(1200), device="cpu")
    a, b = cls(dims, kind=kind, edge=False), cls(dims, kind=kind, edge=True)
    assert torch.equal(a.matvec(x).array, b.matvec(x).array)
    assert torch.equal(a.rmatvec(x).array, b.rmatvec(x).array)


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("name,kw", FIRST + [("second-" + n, dict(kw, second=1))
                                             for n, kw in SECOND])
def test_local_stencils_every_axis(rng, axis, name, kw):
    """The local operators (the fallback and non-axis-0 path) match the
    JAX package's along every axis."""
    kw = dict(kw)
    dims = (9, 7, 6)
    if kw.pop("second", 0):
        jop = jlocal.SecondDerivative(dims, axis=axis, sampling=1.3, **kw)
        top = tlocal.SecondDerivative(dims, axis=axis, sampling=1.3, **kw)
    else:
        jop = jlocal.FirstDerivative(dims, axis=axis, sampling=1.3, **kw)
        top = tlocal.FirstDerivative(dims, axis=axis, sampling=1.3, **kw)
    x = rng.standard_normal(int(np.prod(dims)))
    close(top.matvec(torch.from_numpy(x)).numpy(), jop.matvec(x))
    close(top.rmatvec(torch.from_numpy(x)).numpy(), jop.rmatvec(x))


def test_local_laplacian(rng):
    dims = (8, 5)
    jop = jlocal.Laplacian(dims, axes=(0, 1), weights=(2, -1),
                           sampling=(0.5, 1.0))
    top = tlocal.Laplacian(dims, axes=(0, 1), weights=(2, -1),
                           sampling=(0.5, 1.0))
    x = rng.standard_normal(40)
    close(top.matvec(torch.from_numpy(x)).numpy(), jop.matvec(x))
    close(top.rmatvec(torch.from_numpy(x)).numpy(), jop.rmatvec(x))


@pytest.fixture
def taps_calls(monkeypatch):
    """Counts calls of stencil_kernels.stencil_taps (the kernel's
    wrapper) made by the operators."""
    calls = []
    real = sk.stencil_taps

    def counting(*a, **k):
        calls.append(a[2])
        return real(*a, **k)

    monkeypatch.setattr(sk, "stencil_taps", counting)
    return calls


def test_axis0_stencils_go_through_the_kernel(rng, taps_calls):
    dims = (64, 12)
    x = pmtt.DistributedArray.to_dist(rng.standard_normal(768), device="cpu")
    for kind, kw in [("first", dict(kw)) for _, kw in FIRST] \
            + [("second", dict(kw)) for _, kw in SECOND]:
        _, top = _ops(kind, dims, kw)
        del taps_calls[:]
        top.matvec(x)
        top.rmatvec(x)
        assert len(taps_calls) == 2, (kind, kw)  # one per apply
    # the gradient: its axis-0 component only, once per apply
    _, grad = _ops("gradient", dims, {})
    del taps_calls[:]
    grad.rmatvec(grad.matvec(x))
    assert len(taps_calls) == 2
    # the Laplacian keeps the local formulation
    _, lap = _ops("laplacian", dims, {})
    del taps_calls[:]
    lap.rmatvec(lap.matvec(x))
    assert taps_calls == []


@pytest.mark.parametrize("case", ["short", "complex", "axis1", "broadcast"])
def test_dispatch_by_shape_and_dtype(rng, taps_calls, case):
    """Fields shorter than the stencil's span, non-floating dtypes and
    non-axis-0 stencils take the local operator; a BROADCAST input is
    converted and takes the kernel. Results match the JAX package."""
    dims = {"short": (2, 5)}.get(case, (16, 5))
    kw = dict(kind="centered", edge=True)
    jop, top = _ops("first", dims, kw)
    x = rng.standard_normal(int(np.prod(dims)))
    if case == "complex":
        x = x + 1j * rng.standard_normal(x.shape)
    part = pmtt.Partition.BROADCAST if case == "broadcast" else \
        pmtt.Partition.SCATTER
    if case == "axis1":
        jop = pmt.ops.derivatives._AxisFirstDerivative(dims, 1, 1.0,
                                                       "centered", True)
        top = pmtt.ops.derivatives._AxisFirstDerivative(dims, 1, 1.0,
                                                        "centered", True)
    ty = top.matvec(pmtt.DistributedArray.to_dist(x, partition=part,
                                                  device="cpu"))
    assert ty.partition == pmtt.Partition.SCATTER
    assert len(taps_calls) == (1 if case == "broadcast" else 0)
    if case != "short":  # the JAX operators refuse a 2-row edge stencil
        close(ty.asarray(),
              jop.matvec(pmt.DistributedArray.to_dist(x)).asarray())


def test_gradient_output_is_stacked_per_axis(rng):
    dims = (16, 6, 4)
    g = pmtt.MPIGradient(dims, dtype=torch.float64)
    y = g.matvec(pmtt.DistributedArray.to_dist(
        rng.standard_normal(16 * 24), device="cpu"))
    assert isinstance(y, pmtt.StackedDistributedArray) and y.narrays == 3
    assert all(d.global_shape == (16 * 24,) for d in y.distarrays)
    assert g.shape == (3 * 16 * 24, 16 * 24)
    with pytest.raises(ValueError, match="sampling"):
        pmtt.MPIGradient(dims, sampling=(1.0, 2.0))
    with pytest.raises(NotImplementedError):
        pmtt.MPIFirstDerivative(dims, kind="upwind")
