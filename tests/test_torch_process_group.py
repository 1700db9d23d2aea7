"""The port's process group on the CPU: gloo worlds of 1 to 4 ranks.

Each test spawns one world per world size with ``torch.multiprocessing``
(a ``FileStore`` under ``tmp_path`` rendezvous the ranks, so no TCP port
is taken) and runs all of its cases in it. The rank-side functions touch
only numpy, torch and the port; the JAX package is imported in the test
body only, in this process, where the results are held against it on a
mesh of the same size (its 8-device CPU mesh cut to ``n`` devices, f64).

Tolerances: rtol 1e-12 (relative to the largest entry of the reference)
for shards, gathers, dot and norm. Sizes are ragged on purpose: 10 rows
over 3 and 4 ranks.

``run_world`` and ``close`` are shared with the other multi-rank test
files (``test_torch_dist_operators.py``, ``test_torch_dist_solvers.py``).
"""

import pickle
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

WORLDS = [1, 2, 3, 4]
TIMEOUT = 120  # seconds a world may take before the test fails


def _entry(r, fn, n, store_path, out_dir, args):
    import torch.distributed as dist
    import pylops_mpi_tpu_torch as pmtt
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, n)
    pmtt.parallel.init(backend="gloo", store=store, rank=r, world_size=n,
                       device="cpu")
    try:
        res = fn(*args)
    finally:
        pmtt.parallel.destroy()
    with open(f"{out_dir}/rank{r}.pkl", "wb") as f:
        pickle.dump(res, f)


def run_world(fn, n, tmp_path, *args, during=None, timeout=TIMEOUT):
    """``fn(*args)`` on each rank of a gloo world of ``n`` processes;
    returns the ranks' results in rank order, and with ``during`` also
    what ``during()`` returned: it runs in this process while the ranks
    work (the JAX reference). A rank that raises, or a world that
    outlives ``timeout`` seconds, fails the test."""
    out = tmp_path / f"world{n}"
    out.mkdir()
    ctx = mp.spawn(_entry, args=(fn, n, str(tmp_path / f"store{n}"),
                                 str(out), args),
                   nprocs=n, join=False)
    ref = during() if during is not None else None
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"a world of {n} ranks did not finish in {timeout} s")
    res = []
    for r in range(n):
        with open(out / f"rank{r}.pkl", "rb") as f:
            res.append(pickle.load(f))
    return res if during is None else (res, ref)


def close(got, want, rtol=1e-12):
    want = np.asarray(want)
    got = np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.max(np.abs(want)) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def jax_mesh(n):
    from pylops_mpi_tpu.parallel.mesh import make_mesh
    return make_mesh(n)


def mask_of(n):
    return [r % 2 for r in range(n)]


def group_index(mask, r):
    return sorted(set(mask)).index(mask[r])


# ------------------------------------------------------------------ mesh

def _collectives_rank():
    import torch.distributed as dist
    import pylops_mpi_tpu_torch as pmtt
    from pylops_mpi_tpu_torch.parallel import collectives as co
    mesh = pmtt.parallel.default_mesh()
    n, r = pmtt.parallel.world_size(), pmtt.parallel.rank()
    co.reset_counts()
    out = dict(size=mesh.size, rank=mesh.rank, device=str(mesh.device),
               backend=mesh.backend, dist_size=dist.get_world_size())
    v = torch.tensor(float(r + 1), dtype=torch.float64)
    out["sum"] = float(co.all_reduce(v.clone()))
    out["max"] = float(co.all_reduce(v.clone(), "max"))
    out["min"] = float(co.all_reduce(v.clone(), "min"))
    out["vec"] = co.all_reduce(torch.arange(3.0) * (r + 1)).numpy()
    # ragged gather: rank r holds r + 1 rows of 2
    sizes = [q + 1 for q in range(n)]
    mine = torch.full((r + 1, 2), float(r))
    out["gather"] = co.all_gather(mine, sizes).numpy()
    out["gather_axis1"] = co.all_gather(mine.T.contiguous(), sizes,
                                        axis=1).numpy()
    # all_to_all: rank r sends q a (q + 1, r + 1) block of r*10 + q
    sends = [torch.full((q + 1, r + 1), 10.0 * r + q) for q in range(n)]
    got = co.all_to_all(sends, [(r + 1, p + 1) for p in range(n)])
    out["a2a"] = [g.numpy() for g in got]
    # the ghost exchange on a block of 3 rows holding 100 r + row
    block = (100.0 * r + torch.arange(3.0)).reshape(3, 1).repeat(1, 2)
    top, bottom = co.halo_exchange(block, 1, 2)
    out["top"] = top.numpy() if isinstance(top, torch.Tensor) else top
    out["bottom"] = bottom.numpy() if isinstance(bottom, torch.Tensor) \
        else bottom
    # a masked sub-group reduces within the rank's color
    g = co.mask_group([q % 2 for q in range(n)])
    out["masked_sum"] = float(co.all_reduce(v.clone(), group=g))
    out["counts"] = dict(co.counts)
    return out


@pytest.mark.parametrize("n", WORLDS)
def test_mesh_and_collectives(n, tmp_path):
    res = run_world(_collectives_rank, n, tmp_path)
    for r, o in enumerate(res):
        assert (o["size"], o["rank"], o["dist_size"]) == (n, r, n)
        assert o["device"] == "cpu" and o["backend"] == "gloo"
        assert o["sum"] == n * (n + 1) / 2
        assert (o["max"], o["min"]) == (n, 1)
        close(o["vec"], np.arange(3.0) * n * (n + 1) / 2)
        want = np.concatenate([np.full((q + 1, 2), float(q))
                               for q in range(n)])
        close(o["gather"], want)
        close(o["gather_axis1"], want.T)
        for p in range(n):
            close(o["a2a"][p], np.full((r + 1, p + 1), 10.0 * p + r))
        if r == 0:
            assert o["top"] == 1
        else:
            close(o["top"], np.full((1, 2), 100.0 * (r - 1) + 2))
        if r == n - 1:
            assert o["bottom"] == 2
        else:
            close(o["bottom"], (100.0 * (r + 1) + np.arange(2.0))[:, None]
                  .repeat(2, 1))
        assert o["masked_sum"] == sum(q + 1 for q in range(n)
                                      if q % 2 == r % 2)
        assert o["counts"] == {"all_reduce": 5, "all_gather": 2,
                               "all_to_all": 1, "halo_exchange": 1}


def test_no_group_is_a_world_of_one():
    import pylops_mpi_tpu_torch as pmtt
    from pylops_mpi_tpu_torch.parallel import collectives as co
    assert not pmtt.parallel.mesh.initialized()
    mesh = pmtt.parallel.make_mesh(device="cpu")
    assert (mesh.group, mesh.rank, mesh.size) == (None, 0, 1)
    co.reset_counts()
    t = torch.tensor(3.0)
    assert co.all_reduce(t) is t
    assert co.halo_exchange(torch.zeros(4, 2), 2, 1) == (2, 1)
    assert not co.counts


def test_partition_helpers_match_jax():
    from pylops_mpi_tpu.parallel import partition as jp
    from pylops_mpi_tpu_torch.parallel import partition as tp
    for sizes in ([3, 3, 2, 2], [5], [4, 0, 1], [2, 2]):
        assert tp.shard_offsets(sizes) == jp.shard_offsets(sizes)
        assert tp.padded_shard_size(sizes) == jp.padded_shard_size(sizes)
        for s_phys in (None, 6):
            a, b = tp.pad_index_map(sizes, s_phys), jp.pad_index_map(sizes,
                                                                      s_phys)
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
            np.testing.assert_array_equal(tp.unpad_index_map(sizes, s_phys),
                                          jp.unpad_index_map(sizes, s_phys))


# ----------------------------------------------------- DistributedArray

def _darray_rank(x, y, z, v, mask):
    import pylops_mpi_tpu_torch as pmtt
    from pylops_mpi_tpu_torch import DistributedArray, Partition
    from pylops_mpi_tpu_torch.parallel import collectives as co
    r = pmtt.parallel.rank()
    dx = DistributedArray.to_dist(x, device="cpu")
    dy = DistributedArray.to_dist(torch.from_numpy(y))
    out = dict(local_shape=dx.local_shape, local_shapes=dx.local_shapes,
               shard=dx.local_arrays()[0], array=dx.array.numpy(),
               gathered=dx.asarray())
    co.reset_counts()
    out["dot"] = dx.dot(dy).item()
    out["dot_calls"] = co.counts["all_reduce"]
    dv = DistributedArray.to_dist(v, device="cpu")
    out["vdot"] = dv.dot(dv * (1 + 2j), vdot=True).item()
    out["norms"] = {str(o): dx.norm(o).item()
                    for o in (None, 1, 2, 3, np.inf, -np.inf, 0)}
    out["norm_axis0"] = dx.norm(axis=0).numpy()
    out["norm_axis1"] = dx.norm(axis=1).numpy()
    out["col_dot"] = dx.col_dot(dy).numpy()
    out["arith"] = (dx * 2.0 - dy + dx / 4.0).array.numpy()
    # an array split otherwise is regathered into this array's split
    other = DistributedArray.to_dist(y, device="cpu", local_shapes=[
        (10 - 3 * (pmtt.parallel.world_size() - 1),) + (3,)] + [(3, 3)] * (
            pmtt.parallel.world_size() - 1))
    out["mixed"] = (dx + other).array.numpy()
    # masked reductions: each rank gets its own group's scalar
    mx = DistributedArray.to_dist(x, device="cpu", mask=mask)
    my = DistributedArray.to_dist(y, device="cpu", mask=mask)
    out["mdot"] = mx.dot(my).item()
    out["mnorm"] = {str(o): mx.norm(o).item() for o in (2, 1, np.inf)}
    c = mx.copy()
    zl = mx.zeros_like()
    out["keeps"] = (c.mask == tuple(mask), zl.mask == tuple(mask),
                    c.local_shapes == mx.local_shapes,
                    float(zl.norm()) == 0.0)
    # BROADCAST arrays reduce nothing
    co.reset_counts()
    b = DistributedArray.to_dist(v.real.copy(), partition=Partition.BROADCAST,
                                 device="cpu")
    out["bdot"] = b.dot(b).item()
    out["bnorm"] = b.norm().item()
    out["b_calls"] = co.counts["all_reduce"]
    # ravel of an axis-1 split, redistribute, ghost cells
    dz = DistributedArray.to_dist(z, axis=1, device="cpu")
    rz = dz.ravel()
    out["ravel"] = (rz.global_shape, rz.local_shapes, rz.array.numpy())
    out["redistribute"] = dz.redistribute(0).array.numpy()
    out["redist_back"] = dz.redistribute(0).redistribute(1).asarray()
    out["ghost"] = dx.add_ghost_cells(1, 2).numpy()
    out["ghost_axis1"] = dz.add_ghost_cells(2, 1).numpy()
    out["getitem"] = dx[0].numpy() if dx.local_shape[0] else None
    return out


@pytest.mark.parametrize("n", WORLDS)
def test_distributedarray(n, tmp_path, rng):
    import pylops_mpi_tpu as pmt
    x = rng.standard_normal((10, 3))
    y = rng.standard_normal((10, 3))
    z = rng.standard_normal((6, 10))
    v = rng.standard_normal(10) + 1j * rng.standard_normal(10)
    mask = mask_of(n)
    def reference():
        mesh = jax_mesh(n)
        J = pmt.DistributedArray
        jx, jy = J.to_dist(x, mesh=mesh), J.to_dist(y, mesh=mesh)
        jv = J.to_dist(v, mesh=mesh)
        jz = J.to_dist(z, mesh=mesh, axis=1)
        mx, my = (J.to_dist(x, mesh=mesh, mask=mask),
                  J.to_dist(y, mesh=mesh, mask=mask))
        jb = J.to_dist(v.real.copy(), mesh=mesh,
                       partition=pmt.Partition.BROADCAST)
        # ghost cells through the JAX package's slice-from-global form
        # (the oracle of its own ring kernel, which compiles for seconds)
        return (jx, jy, jv, jz, mx, my, jb, jz.ravel(),
                jx._ghost_cells_gather(1, 2), jz._ghost_cells_gather(2, 1),
                jz.redistribute(0))

    res, ref = run_world(_darray_rank, n, tmp_path, x, y, z, v, mask,
                         during=reference)
    jx, jy, jv, jz, mx, my, jb, jrz, jghost, jghost1, jred = ref
    for r, o in enumerate(res):
        assert o["local_shapes"] == jx.local_shapes
        assert o["local_shape"] == jx.local_shapes[r]
        close(o["shard"], jx.local_arrays()[r])
        close(o["array"], jx.local_arrays()[r])
        close(o["gathered"], x)
        close(o["dot"], jx.dot(jy))
        assert o["dot_calls"] == 1
        close(o["vdot"], jv.dot(jv * (1 + 2j), vdot=True))
        for k, val in o["norms"].items():
            ordv = None if k == "None" else float(k)
            close(val, jx.norm(ordv))
        close(o["norm_axis0"], jx.norm(axis=0))
        close(o["norm_axis1"], jx.norm(axis=1))
        close(o["col_dot"], jx.col_dot(jy))
        close(o["arith"], (jx * 2.0 - jy + jx / 4.0).local_arrays()[r])
        close(o["mixed"], (x + y)[sum(s[0] for s in jx.local_shapes[:r]):][
            :jx.local_shapes[r][0]])
        gi = group_index(mask, r)
        close(o["mdot"], np.asarray(mx.dot(my))[gi])
        for k, val in o["mnorm"].items():
            close(val, np.asarray(mx.norm(float(k)))[gi])
        assert all(o["keeps"])
        close(o["bdot"], jb.dot(jb))
        close(o["bnorm"], jb.norm())
        assert o["b_calls"] == 0
        gshape, lshapes, arr = o["ravel"]
        assert gshape == jrz.global_shape and lshapes == jrz.local_shapes
        close(arr, jrz.local_arrays()[r])
        close(o["redistribute"], jred.local_arrays()[r])
        close(o["redist_back"], z)
        close(o["ghost"], np.asarray(jghost[r]))
        close(o["ghost_axis1"], np.asarray(jghost1[r]))
        if o["getitem"] is not None:
            close(o["getitem"], jx.local_arrays()[r][0])


# ------------------------------------------------- StackedDistributedArray

def _stacked_rank(a, b, c, d):
    import pylops_mpi_tpu_torch as pmtt
    from pylops_mpi_tpu_torch import (DistributedArray, Partition,
                                      StackedDistributedArray as S)
    from pylops_mpi_tpu_torch.parallel import collectives as co

    def make(scale):
        return S([DistributedArray.to_dist(a * scale, device="cpu"),
                  S([DistributedArray.to_dist(b * scale, device="cpu"),
                     DistributedArray.to_dist(c * scale, axis=1,
                                              device="cpu")]),
                  DistributedArray.to_dist(d * scale, device="cpu",
                                           partition=Partition.BROADCAST)])

    s, t = make(1.0), make(-0.5)
    out = {}
    co.reset_counts()
    out["dot"] = s.dot(t).item()
    out["dot_calls"] = co.counts["all_reduce"]
    co.reset_counts()
    out["norms"] = {str(o): s.norm(o).item()
                    for o in (None, 1, np.inf, -np.inf, 0)}
    out["norm_calls"] = co.counts["all_reduce"]
    out["vdot"] = s.dot(s * 1j, vdot=True).item()
    out["gathered"] = s.asarray()
    u = (s + t) * 2.0 - s
    out["arith"] = u.asarray()
    out["size"] = s.size
    return out


@pytest.mark.parametrize("n", WORLDS)
def test_stacked(n, tmp_path, rng):
    import pylops_mpi_tpu as pmt
    a = rng.standard_normal(10)
    b = rng.standard_normal(7)
    c = rng.standard_normal((3, 5))
    d = rng.standard_normal(4)
    def reference():
        mesh = jax_mesh(n)
        J, S = pmt.DistributedArray, pmt.StackedDistributedArray

        def make(scale):
            return S([J.to_dist(a * scale, mesh=mesh),
                      S([J.to_dist(b * scale, mesh=mesh),
                         J.to_dist(c * scale, mesh=mesh, axis=1)]),
                      J.to_dist(d * scale, mesh=mesh,
                                partition=pmt.Partition.BROADCAST)])

        s, t = make(1.0), make(-0.5)
        return dict(dot=s.dot(t), vdot=s.dot(s * 1j, vdot=True),
                    norms={str(o): s.norm(o)
                           for o in (None, 1, np.inf, -np.inf, 0)},
                    gathered=s.asarray(),
                    arith=((s + t) * 2.0 - s).asarray())

    res, ref = run_world(_stacked_rank, n, tmp_path, a, b, c, d,
                         during=reference)
    for o in res:
        close(o["dot"], ref["dot"])
        assert o["dot_calls"] == 1  # one reduction for every component
        for k, val in o["norms"].items():
            close(val, ref["norms"][k])
        assert o["norm_calls"] == 5
        close(o["vdot"], ref["vdot"])
        close(o["gathered"], ref["gathered"])
        close(o["arith"], ref["arith"])
        assert o["size"] == 10 + 7 + 15 + 4
