"""The stacking operators and the local operator on a SCATTER vector
across ranks, held against the JAX package on a mesh of the same size:
``MPIVStack`` and ``MPIHStack`` with batched and heterogeneous rows,
vectors and ``(N, K)`` blocks, with and without ``mask``, a stack with
more ranks than rows, bf16 storage, ``MPIStackedVStack`` of stacks, dot
tests, CGLS, the ``convert`` chunking of the rows, and
``examples/plot_stacking.py``'s flow; the positional order of the
constructors.

Each world size spawns one gloo world (``run_world`` of
``test_torch_process_group.py``) that runs every case; the JAX
reference runs in this process meanwhile. The cases are tests of their
own, which read the worlds' results from a module fixture.

Tolerance: rtol 1e-12 relative to the largest entry of the reference in
f64 (the adjoint's ``all_reduce`` adds the ranks' partials in another
order than the JAX package's einsum); CGLS (5 iterations) 1e-10; bf16
storage 1e-5 (f32 sums in other orders).
"""

import numpy as np
import pytest
import torch

from test_torch_process_group import (WORLDS, close, group_index, jax_mesh,
                                      mask_of, run_world)

F64 = torch.float64


def _data():
    rng = np.random.default_rng(7)
    hetero = [(3, 4), (5, 4), (2, 4), (6, 4), (4, 4)]
    return dict(
        homog=[rng.standard_normal((5, 4)) for _ in range(6)],
        hetero=[rng.standard_normal(s) for s in hetero],
        few=[rng.standard_normal((3, 4)) for _ in range(3)],
        x=rng.standard_normal(4), X=rng.standard_normal((4, 2)),
        xh=rng.standard_normal(24), Xh=rng.standard_normal((24, 2)),
        yf=rng.standard_normal(5),
        # f32 blocks that bf16 holds exactly: the JAX package stores f32
        # where it does not batch (6 blocks over 4 devices)
        f32=[torch.from_numpy(rng.standard_normal((5, 4))).bfloat16()
             .float().numpy() for _ in range(6)],
        xl=rng.standard_normal(24))


def _hetero_rows(mod, hetero, **kw):
    """MatrixMult rows of the given blocks, one a first derivative."""
    rows = [mod.MatrixMult(b, **kw) for b in hetero]
    rows[4] = mod.FirstDerivative(4, dtype=np.float64)
    return rows


# --------------------------------------------------------------- ranks

def _stack_rank(d):
    import pylops_mpi_tpu_torch as pmtt
    from pylops_mpi_tpu_torch import DistributedArray as D
    from pylops_mpi_tpu_torch.ops import local as tl
    from pylops_mpi_tpu_torch.parallel import collectives as co
    n = pmtt.parallel.world_size()
    bc = pmtt.Partition.BROADCAST
    cpu = dict(device="cpu")
    out = {}

    def vec(a, **kw):
        return D.to_dist(a, device="cpu", **kw)

    # batched rows, from the global blocks through convert
    V = pmtt.convert.vstack_from_numpy(d["homog"], **cpu)
    out["held"] = ([op.A.numpy() for op in V.ops],
                   None if V._batched is None else tuple(V._batched.shape),
                   V.local_shapes_n)
    x = vec(d["x"], partition=bc)
    co.reset_counts()
    y = V.matvec(x)
    fwd_calls = dict(co.counts)
    co.reset_counts()
    xa = V.rmatvec(y)
    out["vstack"] = dict(
        y=y.array.numpy(), xa=xa.asarray(), part=(y.partition.name,
                                                  xa.partition.name),
        calls=(fwd_calls, dict(co.counts)),
        Y=V.matvec(vec(d["X"], partition=bc)).array.numpy(),
        XA=V.rmatvec(V.matvec(vec(d["X"], partition=bc))).asarray(),
        y_scatter_x=V.matvec(vec(d["x"])).array.numpy(),
        xa_bcast_y=V.rmatvec(vec(y.asarray(), partition=bc)).asarray(),
        dot=pmtt.dottest(V, rtol=1e-12, **cpu),
        cgls=pmtt.cgls(V, y, x0=vec(np.zeros(4), partition=bc), niter=5,
                       tol=0.0)[0].asarray())
    # heterogeneous rows, vectors and blocks
    Vh = pmtt.MPIVStack(_hetero_rows(tl, d["hetero"], device="cpu"))
    yh = Vh.matvec(x)
    Yh = Vh.matvec(vec(d["X"], partition=bc))
    out["hetero"] = dict(y=yh.array.numpy(), xa=Vh.rmatvec(yh).asarray(),
                         Y=Yh.array.numpy(), XA=Vh.rmatvec(Yh).asarray(),
                         rows=len(Vh.ops), batched=Vh._batched is not None,
                         dot=pmtt.dottest(Vh, rtol=1e-12, **cpu))
    # masked: both outputs carry the mask; dot/norm of the SCATTER data
    # reduce within the rank's group, the adjoint sums every rank's rows
    mask = [r % 2 for r in range(n)]
    for name, rows in (("masked", d["homog"]), ("masked_hetero",
                                                d["hetero"])):
        Vm = pmtt.convert.vstack_from_numpy(rows[:5] if name ==
                                            "masked_hetero" else rows,
                                            mask=mask, **cpu)
        ym = Vm.matvec(x)
        xm = Vm.rmatvec(ym)
        out[name] = dict(y=ym.array.numpy(), xa=xm.asarray(),
                         masks=(ym.mask, xm.mask), norm=ym.norm().item(),
                         dot=ym.dot(ym).item(), xa_norm=xm.norm().item())
    # more ranks than rows: an empty chunk still takes part
    Vf = pmtt.convert.vstack_from_numpy(d["few"], **cpu)
    yf = Vf.matvec(x)
    out["few"] = dict(y=yf.array.numpy(), xa=Vf.rmatvec(yf).asarray(),
                      rows=len(Vf.ops), lsn=Vf.local_shapes_n,
                      dot=pmtt.dottest(Vf, rtol=1e-12, **cpu))
    # bf16 storage of f32 blocks
    Vb = pmtt.convert.vstack_from_numpy(d["f32"], compute_dtype=torch.bfloat16,
                                        **cpu)
    xb = vec(d["x"].astype(np.float32), partition=bc)
    yb = Vb.matvec(xb)
    out["bf16"] = dict(y=yb.array.numpy(), xa=Vb.rmatvec(yb).asarray(),
                       stack=(tuple(Vb._batched.shape),
                              str(Vb._batched.dtype)))
    # MPIHStack: SCATTER model in its own split or the default one
    H = pmtt.convert.hstack_from_numpy(d["homog"], **cpu)
    xs = vec(d["xh"], local_shapes=H.local_shapes_m)
    yH = H.matvec(xs)
    out["hstack"] = dict(
        y=yH.asarray(), part=yH.partition.name, lsm=H.local_shapes_m,
        y_default=H.matvec(vec(d["xh"])).asarray(),
        xa=H.rmatvec(vec(d["yf"], partition=bc)).array.numpy(),
        Y=H.matvec(vec(d["Xh"], local_shapes=[s + (2,) for s in
                                               H.local_shapes_m])).asarray(),
        dot=pmtt.dottest(H, rtol=1e-12, **cpu),
        cgls=pmtt.cgls(H, vec(d["yf"], partition=bc),
                       x0=vec(np.zeros(24), local_shapes=H.local_shapes_m),
                       niter=5, tol=0.0)[0].asarray())
    Hm = pmtt.convert.hstack_from_numpy(d["homog"], mask=mask, **cpu)
    yHm = Hm.matvec(xs)
    out["hstack_masked"] = dict(y=yHm.asarray(), mask=yHm.mask,
                                xa_mask=Hm.rmatvec(yHm).mask,
                                xa=Hm.rmatvec(yHm).array.numpy())
    # MPIStackedVStack of stacks: one model, two stacked data vectors
    S = pmtt.MPIStackedVStack([V, 2.0 * Vh])
    ys = S.matvec(x)
    out["stacked"] = dict(y=ys.asarray(), xa=S.rmatvec(ys).asarray(),
                          dot=pmtt.dottest(S, vec(d["x"], partition=bc),
                                           rtol=1e-12, **cpu))
    # a local operator on a SCATTER vector: gathered, applied, and this
    # rank's default shard kept, mask included
    L = pmtt.asmpilinearoperator(tl.FirstDerivative((8, 3), dtype=F64))
    xl = vec(d["xl"])
    yl = L.matvec(xl)
    ylm = L.matvec(vec(d["xl"], mask=mask))
    out["local"] = dict(y=yl.array.numpy(), lsh=yl.local_shapes,
                        xa=L.rmatvec(yl).array.numpy(),
                        yb=L.matvec(vec(d["xl"], partition=bc)).asarray(),
                        masked=(ylm.mask, ylm.array.numpy(),
                                ylm.norm().item()),
                        dot=pmtt.dottest(L, rtol=1e-12, **cpu))
    # examples/plot_stacking.py's stacks of local second derivatives
    Ny, Nx = 11, 22
    D2v = tl.SecondDerivative((Ny, Nx), axis=0, dtype=F64)
    D2h = tl.SecondDerivative((Ny, Nx), axis=1, dtype=F64)
    Vp = pmtt.MPIVStack([(i // 2 + 1) * (D2v if i % 2 == 0 else D2h)
                         for i in range(8)])
    xp = vec(np.ones(Ny * Nx), partition=bc)
    yv = Vp.matvec(xp)
    Hp = pmtt.MPIHStack([D2v, D2h] * 4)
    yh = Hp.matvec(vec(np.arange(8 * Ny * Nx, dtype=float)))
    out["plot_stacking"] = dict(
        yv=yv.asarray(), xa=Vp.rmatvec(yv).asarray(), yh=yh.asarray(),
        parts=(yv.partition.name, yh.partition.name),
        dot=pmtt.dottest(Vp, xp, yv.copy(), rtol=1e-12))
    return out


# ------------------------------------------------------------ reference

def _reference(n, d):
    import pylops_mpi_tpu as pmt
    from pylops_mpi_tpu.ops import local as jl
    mesh = jax_mesh(n)
    J = pmt.DistributedArray
    bc = pmt.Partition.BROADCAST
    ref = {}

    def vec(a, **kw):
        return J.to_dist(a, mesh=mesh, **kw)

    def mats(blocks):
        return [jl.MatrixMult(b) for b in blocks]

    x = vec(d["x"], partition=bc)
    X = vec(d["X"], partition=bc)
    V = pmt.MPIVStack(mats(d["homog"]), mesh=mesh)
    y = V.matvec(x)
    Y = V.matvec(X)
    ref["vstack"] = dict(
        y=y.local_arrays(), xa=V.rmatvec(y).asarray(), Y=Y.local_arrays(),
        XA=V.rmatvec(Y).asarray(),
        cgls=pmt.cgls(V, y, x0=vec(np.zeros(4), partition=bc), niter=5,
                      tol=0.0)[0].asarray())
    Vh = pmt.MPIVStack(_hetero_rows(jl, d["hetero"]), mesh=mesh)
    yh = Vh.matvec(x)
    Yh = Vh.matvec(X)
    ref["hetero"] = dict(y=yh.local_arrays(), xa=Vh.rmatvec(yh).asarray(),
                         Y=Yh.local_arrays(), XA=Vh.rmatvec(Yh).asarray())
    mask = mask_of(n)
    for name, rows in (("masked", d["homog"]),
                       ("masked_hetero", d["hetero"][:5])):
        Vm = pmt.MPIVStack(mats(rows), mask=mask, mesh=mesh)
        ym = Vm.matvec(x)
        xm = Vm.rmatvec(ym)
        ref[name] = dict(y=ym.local_arrays(), xa=xm.asarray(),
                         norm=np.asarray(ym.norm()),
                         dot=np.asarray(ym.dot(ym)),
                         xa_norm=np.asarray(xm.norm()))
    Vf = pmt.MPIVStack(mats(d["few"]), mesh=mesh)
    yf = Vf.matvec(x)
    ref["few"] = dict(y=yf.local_arrays(), xa=Vf.rmatvec(yf).asarray())
    Vb = pmt.MPIVStack(mats(d["f32"]), mesh=mesh,
                       compute_dtype=_jnp_bf16())
    yb = Vb.matvec(vec(d["x"].astype(np.float32), partition=bc))
    ref["bf16"] = dict(y=yb.local_arrays(), xa=Vb.rmatvec(yb).asarray())
    H = pmt.MPIHStack(mats(d["homog"]), mesh=mesh)
    xs = vec(d["xh"])
    yH = H.matvec(xs)
    ref["hstack"] = dict(
        y=yH.asarray(), xa=H.rmatvec(vec(d["yf"], partition=bc)),
        Y=H.matvec(vec(d["Xh"])).asarray(),
        cgls=pmt.cgls(H, vec(d["yf"], partition=bc), x0=vec(np.zeros(24)),
                      niter=5, tol=0.0)[0].asarray())
    Hm = pmt.MPIHStack(mats(d["homog"]), mask=mask, mesh=mesh)
    yHm = Hm.matvec(xs)
    ref["hstack_masked"] = dict(y=yHm.asarray(), xa=Hm.rmatvec(yHm))
    S = pmt.MPIStackedVStack([V, 2.0 * Vh])
    ys = S.matvec(x)
    ref["stacked"] = dict(y=ys.asarray(), xa=S.rmatvec(ys).asarray())
    L = pmt.asmpilinearoperator(jl.FirstDerivative((8, 3), dtype=np.float64))
    yl = L.matvec(vec(d["xl"]))
    ylm = L.matvec(vec(d["xl"], mask=mask))
    ref["local"] = dict(y=yl.local_arrays(), xa=L.rmatvec(yl).local_arrays(),
                        yb=L.matvec(vec(d["xl"], partition=bc)).asarray(),
                        masked=(ylm.local_arrays(), np.asarray(ylm.norm())))
    Ny, Nx = 11, 22
    D2v = jl.SecondDerivative((Ny, Nx), axis=0, dtype=np.float64)
    D2h = jl.SecondDerivative((Ny, Nx), axis=1, dtype=np.float64)
    Vp = pmt.MPIVStack([(i // 2 + 1) * (D2v if i % 2 == 0 else D2h)
                        for i in range(8)], mesh=mesh)
    yv = Vp.matvec(vec(np.ones(Ny * Nx), partition=bc))
    Hp = pmt.MPIHStack([D2v, D2h] * 4, mesh=mesh)
    ref["plot_stacking"] = dict(
        yv=yv.asarray(), xa=Vp.rmatvec(yv).asarray(),
        yh=Hp.matvec(vec(np.arange(8 * Ny * Nx, dtype=float))).asarray())
    return ref


def _jnp_bf16():
    import jax.numpy as jnp
    return jnp.bfloat16


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every world's rank results and the JAX reference beside them."""
    d = _data()
    out = {}
    for n in WORLDS:
        res, ref = run_world(_stack_rank, n, tmp_path_factory.mktemp("w"), d,
                             during=lambda: _reference(n, d))
        out[n] = (res, ref)
    return d, out


def _each(worlds):
    d, out = worlds
    for n, (res, ref) in out.items():
        for r, o in enumerate(res):
            yield n, r, o, ref


# ---------------------------------------------------------------- cases

def test_vstack_batched(worlds):
    from pylops_mpi_tpu.ops.blockdiag import _chunk_ops
    d = worlds[0]
    for n, r, o, ref in _each(worlds):
        held, stack, lsn = o["held"]
        chunk = _chunk_ops(d["homog"], n)[r]
        assert len(held) == len(chunk) and stack == (len(chunk), 5, 4)
        for a, b in zip(held, chunk):
            np.testing.assert_array_equal(a, b)
        assert lsn == tuple((5 * len(c),) for c in _chunk_ops(d["homog"], n))
        v, w = o["vstack"], ref["vstack"]
        assert v["part"] == ("SCATTER", "BROADCAST")
        # the forward communicates nothing, the adjoint one all_reduce
        assert v["calls"] == ({}, {} if n == 1 else {"all_reduce": 1})
        close(v["y"], w["y"][r])
        close(v["y_scatter_x"], w["y"][r])
        close(v["xa"], w["xa"])
        close(v["xa_bcast_y"], w["xa"])
        close(v["Y"], w["Y"][r])
        close(v["XA"], w["XA"])
        assert v["dot"]
        close(v["cgls"], w["cgls"], rtol=1e-10)


def test_vstack_heterogeneous(worlds):
    from pylops_mpi_tpu.ops.blockdiag import _chunk_ops
    for n, r, o, ref in _each(worlds):
        v, w = o["hetero"], ref["hetero"]
        # a chunk of one matrix row is a stack of one block
        chunk = _chunk_ops(list(range(5)), n)[r]
        assert v["rows"] == len(chunk)
        assert v["batched"] == (len(chunk) == 1 and chunk[0] < 4)
        close(v["y"], w["y"][r])
        close(v["xa"], w["xa"])
        close(v["Y"], w["Y"][r])
        close(v["XA"], w["XA"])
        assert v["dot"]


def test_vstack_masked(worlds):
    """The JAX package stamps the mask on both outputs; the SCATTER
    data's dot and norm are each group's, and the adjoint sums the rows
    of every group (not the reference's sub-communicator sum)."""
    d = worlds[0]
    for n, r, o, ref in _each(worlds):
        mask = tuple(mask_of(n))
        gi = group_index(mask_of(n), r)
        for name in ("masked", "masked_hetero"):
            v, w = o[name], ref[name]
            assert v["masks"] == (mask, mask)
            close(v["y"], w["y"][r])
            close(v["xa"], w["xa"])
            close(v["norm"], np.atleast_1d(w["norm"])[gi])
            close(v["dot"], np.atleast_1d(w["dot"])[gi])
            close(v["xa_norm"], w["xa_norm"])
        # every block's adjoint is in the sum
        full = sum(b.T @ (b @ d["x"]) for b in d["homog"])
        close(o["masked"]["xa"], full)


def test_vstack_more_ranks_than_rows(worlds):
    for n, r, o, ref in _each(worlds):
        v, w = o["few"], ref["few"]
        rows = len(np.array_split(np.arange(3), n)[r])
        assert v["rows"] == rows and v["lsn"][r] == (3 * rows,)
        close(v["y"], w["y"][r])
        close(v["xa"], w["xa"])
        assert v["dot"]


def test_vstack_bf16_storage(worlds):
    from pylops_mpi_tpu.ops.blockdiag import _chunk_ops
    d = worlds[0]
    for n, r, o, ref in _each(worlds):
        v, w = o["bf16"], ref["bf16"]
        assert v["stack"] == ((len(_chunk_ops(d["f32"], n)[r]), 5, 4),
                              "torch.bfloat16")
        close(v["y"], w["y"][r], rtol=1e-5)
        close(v["xa"], w["xa"], rtol=1e-5)


def test_hstack(worlds):
    for n, r, o, ref in _each(worlds):
        v, w = o["hstack"], ref["hstack"]
        assert v["part"] == "BROADCAST"
        close(v["y"], w["y"])
        close(v["y_default"], w["y"])  # regathered into the rows' split
        close(v["xa"], w["xa"].local_arrays()[r])
        close(v["Y"], w["Y"])
        assert v["dot"]
        close(v["cgls"], w["cgls"], rtol=1e-10)
        m, wm = o["hstack_masked"], ref["hstack_masked"]
        assert m["mask"] == m["xa_mask"] == tuple(mask_of(n))
        close(m["y"], wm["y"])
        close(m["xa"], wm["xa"].local_arrays()[r])


def test_stacked_vstack_of_stacks(worlds):
    for n, r, o, ref in _each(worlds):
        close(o["stacked"]["y"], ref["stacked"]["y"])
        close(o["stacked"]["xa"], ref["stacked"]["xa"])
        assert o["stacked"]["dot"]


def test_local_operator_on_scatter(worlds):
    """The JAX package applies the local operator to the global vector
    and keeps the partition, the mask and the default split."""
    for n, r, o, ref in _each(worlds):
        v, w = o["local"], ref["local"]
        assert v["lsh"] == tuple((len(c),) for c in
                                 np.array_split(np.arange(24), n))
        close(v["y"], w["y"][r])
        close(v["xa"], w["xa"][r])
        close(v["yb"], w["yb"])
        mk, arr, nrm = v["masked"]
        assert mk == tuple(mask_of(n))
        close(arr, w["masked"][0][r])
        close(nrm, np.atleast_1d(w["masked"][1])[group_index(mask_of(n), r)])
        assert v["dot"]


def test_example_plot_stacking(worlds):
    for n, r, o, ref in _each(worlds):
        v, w = o["plot_stacking"], ref["plot_stacking"]
        assert v["parts"] == ("SCATTER", "BROADCAST") and v["dot"]
        for k in ("yv", "xa", "yh"):
            close(v[k], w[k])


# ------------------------------------------------- positional order (pins)

def test_stack_positional_order():
    """``MPIVStack``/``MPIHStack`` take the JAX package's order: (ops,
    mask, mesh, dtype, compute_dtype, overlap, hierarchical); a mesh that
    is not the process group is refused."""
    import pylops_mpi_tpu_torch as pmtt
    from pylops_mpi_tpu_torch.ops.local import MatrixMult
    rng = np.random.default_rng(3)
    rows = [MatrixMult(torch.from_numpy(rng.standard_normal((4, 3))))
            for _ in range(3)]
    here = pmtt.parallel.make_mesh("cpu")
    for cls in (pmtt.MPIVStack, pmtt.MPIHStack):
        pos = cls(rows, [3], here, torch.float64, torch.float32, "on", "off")
        kw = cls(rows, mask=[3], mesh=here, dtype=torch.float64,
                 compute_dtype=torch.float32, overlap="on",
                 hierarchical="off")
        for op in (pos, kw):
            assert op.mask == (3,) and op.dtype == torch.float64
        stack = pos.vstack if cls is pmtt.MPIHStack else pos
        assert stack.compute_dtype == torch.float32
        assert stack._batched.dtype == torch.float32
        with pytest.raises(ValueError, match="does not match the process"):
            cls(rows, None, pmtt.parallel.Mesh(None, 0, 2, here.device))
