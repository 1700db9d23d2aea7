"""``MPIHalo`` across ranks, held against the JAX package on a mesh of
the same size: a 1-D grid with a scalar halo, 2-D grids with scalar,
per-axis tuple and (minus, plus) pair halos (a 2x2 grid at four ranks,
where the corners travel through the second axis's exchange), ragged
blocks, the layout errors, and ``examples/plot_halo.py``'s flow (the
crop recovering the field, the sandwich ``Hop.H @ MPIBlockDiag @ Hop``
and its dot test); the positional order of the constructor.

Each world size spawns one gloo world (``run_world`` of
``test_torch_process_group.py``) that runs every case; the JAX
reference runs in this process meanwhile (each of its halo applies
compiles a shard_map kernel, 1-3 s on the CPU mesh, so every apply
below is one that the port is held to). Tolerance: rtol 1e-12 in f64
(the halo moves values and adds nothing, so the outputs are equal).

Gradients: of ``0.5‖H x − w‖²`` with respect to x through the
``2d_tuple`` halo (on the 2x2 grid at four ranks, where a corner's
cotangent travels back through both axes' exchanges), by autograd
straight through ``matvec`` (``cart_halo_extend``'s rule, one adjoint
call for each exchanging axis), against ``jax.grad`` through the JAX
operator, each rank's shard at rtol 1e-10.
"""

import numpy as np
import pytest

from test_torch_process_group import WORLDS, close, jax_mesh, run_world


def _cases(n):
    """name -> (dims, halo, proc_grid_shape, adjoint held too)."""
    sq = (2, 2) if n == 4 else None
    return {
        "1d_scalar": ((32,), 1, (n,), True),          # plot_halo, 1-D
        "2d_tuple": ((10, 7), (1, 2), sq or (n, 1), True),
        "2d_pairs": ((9, 8), (1, 0, 2, 1), sq or (1, n), True),
        "2d_scalar": ((16, 12), 1, sq or (n, 1), False),  # plot_halo, 2-D
    }


GRAD = "2d_tuple"


def _grad_target(H):
    """The data ``w`` of the gradient case's loss, sized from ``H``."""
    return np.random.default_rng(12).standard_normal(H.shape[0])


def _data(n):
    rng = np.random.default_rng(11)
    return {k: rng.standard_normal(int(np.prod(v[0])))
            for k, v in _cases(n).items()}


def _exchanging_axes(dims, halo, grid):
    """Axes along which the forward exchanges (grid > 1, nonzero base
    halo): one ``cart_halo_extend`` call each."""
    nd = len(dims)
    if isinstance(halo, int):
        h = (halo,) * 2 * nd
    elif len(halo) == nd:
        h = sum(((v, v) for v in halo), ())
    else:
        h = tuple(halo)
    return sum(1 for ax in range(nd) if grid[ax] > 1 and (h[2 * ax]
                                                          or h[2 * ax + 1]))


# --------------------------------------------------------------- ranks

def _halo_rank(d):
    import torch
    import pylops_mpi_tpu_torch as pmtt
    from pylops_mpi_tpu_torch import DistributedArray as D
    from pylops_mpi_tpu_torch.ops.local import FirstDerivative
    from pylops_mpi_tpu_torch.parallel import collectives as co
    n = pmtt.parallel.world_size()
    out = {}
    for name, (dims, halo, grid, _) in _cases(n).items():
        # the JAX package's positional order: dims, halo, grid, mesh, dtype
        H = pmtt.MPIHalo(dims, halo, grid, None, np.float64)
        x = D.to_dist(d[name], local_shapes=H.local_dim_sizes, device="cpu")
        co.reset_counts()
        y = H.matvec(x)
        calls = dict(co.counts)
        back = H.rmatvec(y)
        out[name] = dict(y=y.array.numpy(), xa=back.array.numpy(),
                         calls=calls, recovers=np.array_equal(
                             back.array.numpy(), x.array.numpy()),
                         lsh=(H.local_dim_sizes, H.local_extent_sizes))
        if n > 1 and name == "2d_pairs":
            # the default split (the block split only at two ranks) and a
            # BROADCAST input: the JAX package's errors
            errs = []
            for fn, v in ((H.matvec, D.to_dist(d[name], device="cpu")),
                          (H.rmatvec, D.to_dist(np.zeros(H.shape[0]),
                                                device="cpu")),
                          (H.matvec, D.to_dist(
                              d[name], partition=pmtt.Partition.BROADCAST,
                              device="cpu"))):
                try:
                    fn(v)
                    errs.append(None)
                except ValueError as e:
                    errs.append(str(e))
            out[name]["errors"] = errs
    # examples/plot_halo.py's sandwich of local forward derivatives
    H = pmtt.MPIHalo(32, 1, dtype=np.float64)
    xd = D.to_dist(np.arange(32.0), local_shapes=H.local_dim_sizes,
                   device="cpu")
    Sand = H.H @ pmtt.MPIBlockDiag(
        [FirstDerivative(e[0], kind="forward", dtype=torch.float64)
         for e in H.extents]) @ H
    y = Sand.matvec(xd)
    out["sandwich"] = dict(y=y.array.numpy(), dot=pmtt.dottest(
        Sand, xd, y.copy(), rtol=1e-12))
    # the gradient of 0.5‖H x − w‖² through the exchanges' rule
    dims, halo, grid, _ = _cases(n)[GRAD]
    H = pmtt.MPIHalo(dims, halo, grid, None, np.float64)
    x = D.to_dist(d[GRAD], local_shapes=H.local_dim_sizes, device="cpu")
    w = D.to_dist(_grad_target(H), local_shapes=H.local_extent_sizes,
                  device="cpu")
    x.array.requires_grad_(True)
    co.reset_counts()
    r = H.matvec(x) - w
    (g,) = torch.autograd.grad(0.5 * r.dot(r), x.array)
    out["grad"] = dict(grad=g.numpy(), calls=dict(co.counts))
    return out


def _reference(n, d):
    import pylops_mpi_tpu as pmt
    from pylops_mpi_tpu.ops.local import FirstDerivative
    mesh = jax_mesh(n)
    J = pmt.DistributedArray
    ref = {}
    for name, (dims, halo, grid, adj) in _cases(n).items():
        H = pmt.MPIHalo(dims, halo, proc_grid_shape=grid, mesh=mesh,
                        dtype=np.float64)
        y = H.matvec(J.to_dist(d[name], mesh=mesh,
                               local_shapes=H.local_dim_sizes))
        ref[name] = dict(y=y.local_arrays(),
                         xa=H.rmatvec(y).local_arrays() if adj else None,
                         lsh=(H.local_dim_sizes, H.local_extent_sizes))
        if n > 1 and name == "2d_pairs":
            errs = []
            for fn, v in ((H.matvec, J.to_dist(d[name], mesh=mesh)),
                          (H.rmatvec, J.to_dist(np.zeros(H.shape[0]),
                                                mesh=mesh)),
                          (H.matvec, J.to_dist(
                              d[name], mesh=mesh,
                              partition=pmt.Partition.BROADCAST))):
                try:
                    fn(v)
                    errs.append(None)
                except ValueError as e:
                    errs.append(str(e))
            ref["errors"] = errs
    H = pmt.MPIHalo(32, 1, mesh=mesh, dtype=np.float64)
    Sand = H.H @ pmt.MPIBlockDiag(
        [FirstDerivative(int(e[0]), kind="forward", dtype=np.float64)
         for e in H.extents], mesh=mesh) @ H
    ref["sandwich"] = Sand.matvec(J.to_dist(
        np.arange(32.0), mesh=mesh, local_shapes=H.local_dim_sizes)
    ).local_arrays()
    ref["grad"] = _grad_reference(n, d, mesh) if n > 1 else None
    return ref


def _grad_reference(n, d, mesh):
    """``jax.grad`` of the gradient case's loss, as each rank's shard."""
    import jax
    import pylops_mpi_tpu as pmt
    J = pmt.DistributedArray
    dims, halo, grid, _ = _cases(n)[GRAD]
    H = pmt.MPIHalo(dims, halo, proc_grid_shape=grid, mesh=mesh,
                    dtype=np.float64)
    x = J.to_dist(d[GRAD], mesh=mesh, local_shapes=H.local_dim_sizes)
    w = J.to_dist(_grad_target(H), mesh=mesh,
                  local_shapes=H.local_extent_sizes)

    def loss(a):
        r = H.matvec(J._wrap(a, x)) - w
        return 0.5 * r.dot(r)
    return J._wrap(jax.jit(jax.grad(loss))(x._arr), x).local_arrays()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = {}
    for n in WORLDS:
        d = _data(n)
        out[n] = (d, *run_world(_halo_rank, n, tmp_path_factory.mktemp("w"),
                                d, during=lambda: _reference(n, d)))
    return out


@pytest.mark.parametrize("name", ["1d_scalar", "2d_tuple", "2d_pairs",
                                  "2d_scalar"])
def test_halo(worlds, name):
    for n, (d, res, ref) in worlds.items():
        dims, halo, grid, adj = _cases(n)[name]
        w = ref[name]
        for r, o in enumerate(res):
            v = o[name]
            assert v["lsh"] == w["lsh"]
            close(v["y"], w["y"][r])
            if adj:
                close(v["xa"], w["xa"][r])
            assert v["recovers"]  # the crop is the forward's left inverse
            k = _exchanging_axes(dims, halo, grid) if n > 1 else 0
            assert v["calls"] == ({"cart_halo_extend": k} if k else {})


def test_halo_layout_errors(worlds):
    """The JAX package's errors for a split that is not the block
    decomposition and for a BROADCAST input."""
    for n, (d, res, ref) in worlds.items():
        if n == 1:
            continue
        for o in res:
            assert o["2d_pairs"]["errors"] == ref["errors"]
            assert ref["errors"][2] and (n == 2 or all(ref["errors"]))


def test_example_plot_halo_sandwich(worlds):
    for n, (d, res, ref) in worlds.items():
        for r, o in enumerate(res):
            close(o["sandwich"]["y"], ref["sandwich"][r])
            assert o["sandwich"]["dot"]
            assert o["1d_scalar"]["recovers"] and o["2d_scalar"]["recovers"]


def test_gradient_matches_jax(worlds):
    """Each rank's gradient is its shard of ``jax.grad``'s; the backward
    sent the ghosts' cotangents home once for each exchanging axis."""
    for n, (d, res, ref) in worlds.items():
        if n == 1:
            continue
        dims, halo, grid, _ = _cases(n)[GRAD]
        k = _exchanging_axes(dims, halo, grid)
        for r, o in enumerate(res):
            close(o["grad"]["grad"], ref["grad"][r], 1e-10)
            calls = o["grad"]["calls"]
            assert calls["cart_halo_extend"] == \
                calls["cart_halo_extend_adjoint"] == k
        if n == 4:
            assert grid == (2, 2) and k == 2


def test_halo_positional_order():
    """``MPIHalo(dims, halo, proc_grid_shape, mesh, dtype, overlap,
    hierarchical)``, the JAX package's order; a mesh that is not the
    process group is refused."""
    import torch
    import pylops_mpi_tpu_torch as pmtt
    here = pmtt.parallel.make_mesh("cpu")
    pos = pmtt.MPIHalo((6, 4), (1, 2), (1, 1), here, np.float32, "on", "off")
    kw = pmtt.MPIHalo(dims=(6, 4), halo=(1, 2), proc_grid_shape=(1, 1),
                      mesh=here, dtype=np.float32, overlap="on",
                      hierarchical="off")
    for op in (pos, kw):
        assert op.dtype == torch.float32 and op.halos == [(1, 1, 2, 2)]
        assert op.shape == (8 * 8, 24)
    with pytest.raises(ValueError, match="does not match the process"):
        pmtt.MPIHalo((6, 4), 1, None, pmtt.parallel.Mesh(None, 0, 2,
                                                         here.device))
