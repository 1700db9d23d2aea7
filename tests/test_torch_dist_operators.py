"""The port's operators across ranks, held against the JAX package on a
mesh of the same size: ``MPIBlockDiag`` (with and without ``mask``), the
derivative family, ``MPIGradient``, ``MPILaplacian`` and
``MPIStackedVStack``, with dot tests (the other operators across ranks:
``test_torch_dist_stack.py``, ``test_torch_dist_halo.py``,
``test_torch_dist_fredholm.py``). Gloo worlds of 1 to 4 ranks are
spawned as in ``test_torch_process_group.py``; the rank-side functions
import no JAX.

Also the world-of-one fixes: ``MPIBlockDiag``'s positional argument
order, ``MPIStackedBlockDiag``, ``todense`` and ``diagonal``, and the
``examples/plot_mpilinop.py`` and ``plot_stacked_array.py`` flows.

Tolerance: rtol 1e-12 (relative to the largest entry of the reference)
in f64.
"""

import numpy as np
import pytest
import scipy.linalg
import torch

from test_torch_process_group import (WORLDS, close, group_index, jax_mesh,
                                      mask_of, run_world)


def _blocks(rng, shapes):
    return [rng.standard_normal(s) for s in shapes]


HOMOG = [(6, 5)] * 10           # 10 equal blocks: batched on every rank
HETERO = [(4 + i % 3, 3 + i % 2) for i in range(7)]  # per-block applies


# ------------------------------------------------------------ MPIBlockDiag

def _blockdiag_rank(blocks, hetero, xg, x2, yh, mask):
    import pylops_mpi_tpu_torch as pmtt
    from pylops_mpi_tpu_torch import DistributedArray as D
    from pylops_mpi_tpu_torch.parallel import collectives as co
    from pylops_mpi_tpu_torch.ops import normal_kernels as nk
    out = {}
    Op = pmtt.convert.blockdiag_from_numpy(blocks, device="cpu")
    out["held"] = [op.A.numpy() for op in Op.ops]
    out["batched"] = None if Op._batched is None else tuple(Op._batched.shape)
    out["lsm"], out["lsn"] = Op.local_shapes_m, Op.local_shapes_n
    x = D.to_dist(xg, local_shapes=Op.local_shapes_m, device="cpu")
    co.reset_counts()
    y = Op.matvec(x)
    out["apply_calls"] = sum(co.counts.values())
    out["y"] = y.array.numpy()
    out["xa"] = Op.rmatvec(y).array.numpy()
    calls = []
    real = nk.normal_matvec
    nk.normal_matvec = lambda A, X: (calls.append(A.shape[0]), real(A, X))[1]
    u, q = Op.normal_matvec(x)
    nk.normal_matvec = real
    out["normal"] = (u.array.numpy(), q.array.numpy(), calls)
    # a vector split otherwise is regathered into the blocks' split
    out["y_default_split"] = Op.matvec(D.to_dist(xg, device="cpu")).asarray()
    # a BROADCAST vector: each rank applies its blocks to its rows, and
    # the output is whole on every rank
    yb = Op.matvec(D.to_dist(xg, partition=pmtt.Partition.BROADCAST,
                             device="cpu"))
    out["y_bcast"] = (yb.partition.name, yb.array.numpy())
    xb = D.to_dist(x2, local_shapes=[s + (2,) for s in Op.local_shapes_m],
                   device="cpu")
    out["block"] = Op.matvec(xb).array.numpy()
    out["dottest"] = pmtt.dottest(Op, rtol=1e-12, device="cpu")
    diag = Op.diagonal()
    out["diagonal"] = co.all_gather(
        diag, [5 * len(c) for c in pmtt.ops.blockdiag._chunk_ops(
            blocks, pmtt.parallel.world_size())]).numpy()
    out["dense"] = Op.todense(device="cpu")
    # masked: outputs carry the mask and reduce within the group
    mats = [pmtt.ops.local.MatrixMult(torch.from_numpy(b)) for b in blocks]
    Om = pmtt.MPIBlockDiag(mats, mask, None, None, None, "two_sweep")
    ym = Om.matvec(D.to_dist(xg, local_shapes=Om.local_shapes_m,
                             device="cpu", mask=mask))
    out["masked"] = (ym.mask, ym.norm().item(), ym.dot(ym).item(),
                     Om.has_fused_normal)
    # heterogeneous blocks
    Oh = pmtt.convert.blockdiag_from_numpy(hetero, device="cpu")
    xh = D.to_dist(np.ones(Oh.shape[1]), local_shapes=Oh.local_shapes_m,
                   device="cpu")
    out["hetero"] = (Oh.matvec(xh).array.numpy(),
                     Oh.rmatvec(D.to_dist(yh, local_shapes=Oh.local_shapes_n,
                                          device="cpu")).array.numpy())
    return out


@pytest.mark.parametrize("n", WORLDS)
def test_blockdiag(n, tmp_path, rng):
    import pylops_mpi_tpu as pmt
    from pylops_mpi_tpu.ops.blockdiag import _chunk_ops
    from pylops_mpi_tpu.ops.local import MatrixMult as JM
    blocks = _blocks(rng, HOMOG)
    hetero = _blocks(rng, HETERO)
    xg = rng.standard_normal(50)
    x2 = rng.standard_normal((50, 2))
    mask = mask_of(n)
    jh = pmt.MPIBlockDiag([JM(b) for b in hetero])
    yh = rng.standard_normal(jh.shape[0])
    def reference():
        mesh = jax_mesh(n)
        J = pmt.DistributedArray
        jop = pmt.MPIBlockDiag([JM(b) for b in blocks], mesh=mesh)
        x = J.to_dist(xg, mesh=mesh, local_shapes=jop.local_shapes_m)
        y = jop.matvec(x)
        yb = jop.matvec(J.to_dist(x2, mesh=mesh, local_shapes=[
            s + (2,) for s in jop.local_shapes_m]))
        jm = pmt.MPIBlockDiag([JM(b) for b in blocks], mask=mask, mesh=mesh)
        ym = jm.matvec(J.to_dist(xg, mesh=mesh, mask=mask,
                                 local_shapes=jm.local_shapes_m))
        jh = pmt.MPIBlockDiag([JM(b) for b in hetero], mesh=mesh)
        yhj = jh.matvec(J.to_dist(np.ones(jh.shape[1]), mesh=mesh,
                                  local_shapes=jh.local_shapes_m))
        xhj = jh.rmatvec(J.to_dist(yh, mesh=mesh,
                                   local_shapes=jh.local_shapes_n))
        return (jop, y, jop.rmatvec(y), jop.normal_matvec(x), yb, ym, yhj,
                xhj)

    res, ref = run_world(_blockdiag_rank, n, tmp_path, blocks, hetero, xg,
                         x2, yh, mask, during=reference)
    jop, y, xa, (u, q), yb, ym, yhj, xhj = ref
    # todense across ranks against the matrix itself (the JAX package's
    # todense is held against the port's at one rank below)
    dense = scipy.linalg.block_diag(*blocks)
    chunks = _chunk_ops(blocks, n)
    for r, o in enumerate(res):
        # each rank holds its chunk of the blocks, and only that
        assert len(o["held"]) == len(chunks[r])
        for a, b in zip(o["held"], chunks[r]):
            np.testing.assert_array_equal(a, b)
        assert o["batched"] == (len(chunks[r]), 6, 5)
        assert o["lsm"] == jop.local_shapes_m
        assert o["lsn"] == jop.local_shapes_n
        assert o["apply_calls"] == 0  # no communication in the apply
        close(o["y"], y.local_arrays()[r])
        close(o["xa"], xa.local_arrays()[r])
        uu, qq, calls = o["normal"]
        close(uu, u.local_arrays()[r])
        close(qq, q.local_arrays()[r])
        assert calls == [len(chunks[r])]  # the kernel's wrapper, the chunk
        close(o["y_default_split"], y.asarray())
        assert o["y_bcast"][0] == "BROADCAST"
        close(o["y_bcast"][1], y.asarray())
        close(o["block"], yb.local_arrays()[r])
        assert o["dottest"]
        close(o["diagonal"], jop.diagonal())
        close(o["dense"], dense)
        mk, mnorm, mdot, fused = o["masked"]
        gi = group_index(mask, r)
        assert mk == tuple(mask) and not fused
        close(mnorm, np.asarray(ym.norm())[gi])
        close(mdot, np.asarray(ym.dot(ym))[gi])
        close(o["hetero"][0], yhj.local_arrays()[r])
        close(o["hetero"][1], xhj.local_arrays()[r])


# ------------------------------------------------------------- derivatives

# (name, kwargs): every kind, order and edge flag of the axis-0 stencils
DERIVS = [
    ("first", dict(kind="centered")),
    ("first", dict(kind="centered", edge=True)),
    ("first", dict(kind="centered", order=5, edge=True)),
    ("first", dict(kind="forward", sampling=0.5)),
    ("first", dict(kind="backward")),
    ("second", dict(kind="centered", edge=True)),
    ("second", dict(kind="forward")),
    ("second", dict(kind="backward", sampling=2.0)),
]
# 10 rows: 3/3/2/2 over 4 ranks, short of the 3 rows edge stencils read
# (the gather path) and long enough for the others (the exchange); 21
# rows: the edge stencils on the exchange at every world size
DIMS = [(10, 7), (21, 5)]


def _derivs(dims):
    return DERIVS if dims == DIMS[0] else [d for d in DERIVS
                                           if d[1].get("edge")]


def _ranks_ops(pmtt, dims):
    ops = []
    for name, kw in _derivs(dims):
        cls = (pmtt.MPIFirstDerivative if name == "first"
               else pmtt.MPISecondDerivative)
        ops.append(cls(dims, dtype=torch.float64, **kw))
    return ops


def _deriv_rank(fields, datas):
    import pylops_mpi_tpu_torch as pmtt
    from pylops_mpi_tpu_torch import DistributedArray as D
    from pylops_mpi_tpu_torch.ops import derivatives, stencil_kernels
    ghosts = []
    real = stencil_kernels.stencil_taps

    def recording(slab, taps, w, out_pad=(0, 0), *, top=0, bottom=0):
        ghosts.append((isinstance(top, torch.Tensor),
                       isinstance(bottom, torch.Tensor)))
        return real(slab, taps, w, out_pad, top=top, bottom=bottom)

    stencil_kernels.stencil_taps = recording
    out = []
    for dims, f, d in zip(DIMS, fields, datas):
        for op in _ranks_ops(pmtt, dims):
            derivatives.paths.clear()
            ghosts.clear()
            x = D.to_dist(f.ravel(), local_shapes=op.local_shapes_m,
                          device="cpu")
            y = op.matvec(x)
            xa = op.rmatvec(D.to_dist(d.ravel(),
                                      local_shapes=op.local_shapes_n,
                                      device="cpu"))
            out.append(dict(y=y.array.numpy(), xa=xa.array.numpy(),
                            paths=dict(derivatives.paths),
                            ghosts=list(ghosts),
                            dottest=pmtt.dottest(op, rtol=1e-12,
                                                 device="cpu")))
    stencil_kernels.stencil_taps = real
    return out


@pytest.mark.parametrize("n", WORLDS)
def test_derivatives(n, tmp_path, rng, monkeypatch):
    import pylops_mpi_tpu as pmt
    fields = [rng.standard_normal(d) for d in DIMS]
    datas = [rng.standard_normal(d) for d in DIMS]
    # the JAX package's partitioned path on the same mesh: its explicit
    # shard_map kernels take 5-8x longer to compile on the CPU mesh
    monkeypatch.setenv("PYLOPS_MPI_TPU_EXPLICIT_STENCIL", "0")

    def reference():
        mesh = jax_mesh(n)
        J = pmt.DistributedArray
        out = []
        for dims, f, d in zip(DIMS, fields, datas):
            for name, kw in _derivs(dims):
                cls = (pmt.MPIFirstDerivative if name == "first"
                       else pmt.MPISecondDerivative)
                jop = cls(dims, mesh=mesh, dtype=np.float64, **kw)
                y = jop.matvec(J.to_dist(f.ravel(), mesh=mesh,
                                         local_shapes=jop._out_locals))
                xa = jop.rmatvec(J.to_dist(d.ravel(), mesh=mesh,
                                           local_shapes=jop._out_locals))
                out.append((y.local_arrays(), xa.local_arrays()))
        return out

    res, ref = run_world(_deriv_rank, n, tmp_path, fields, datas,
                         during=reference)
    k = 0
    for dims in DIMS:
        rows = [len(c) for c in np.array_split(np.arange(dims[0]), n)]
        for name, kw in _derivs(dims):
            ys, xas = ref[k]
            span = 3 if kw.get("edge") else (
                2 if kw.get("order") == 5 or name == "second"
                and kw["kind"] != "centered" else 1)
            for r in range(n):
                o = res[r][k]
                close(o["y"], ys[r])
                close(o["xa"], xas[r])
                assert o["dottest"]
                if n == 1:
                    assert o["paths"] == {"explicit": 2}
                elif min(rows) >= span:
                    # the tap kernel on the rank's shard, fed the ghost
                    # rows it received: tensors on both sides of an
                    # interior rank, zero counts at the ends of the world
                    assert o["paths"] == {"explicit": 2}
                    assert o["ghosts"] == [(r > 0, r < n - 1)] * 2
                else:
                    assert o["paths"] == {"gather": 2}
            k += 1


# ------------------------------------ Gradient, Laplacian, StackedVStack

def _grad_rank(f, g0, g1, dims):
    import pylops_mpi_tpu_torch as pmtt
    from pylops_mpi_tpu_torch import DistributedArray as D
    from pylops_mpi_tpu_torch import StackedDistributedArray as S
    from pylops_mpi_tpu_torch.ops import derivatives
    out = {}
    f64 = torch.float64
    G = pmtt.MPIGradient(dims, sampling=(1.0, 0.5), edge=True, dtype=f64)
    x = D.to_dist(f.ravel(), local_shapes=G.local_shapes_m, device="cpu")
    derivatives.paths.clear()
    y = G.matvec(x)
    out["grad"] = [c.array.numpy() for c in y.distarrays]
    out["grad_paths"] = dict(derivatives.paths)
    v = S([D.to_dist(g.ravel(), local_shapes=G.local_shapes_m, device="cpu")
           for g in (g0, g1)])
    out["grad_adj"] = G.rmatvec(v).array.numpy()
    out["grad_dot"] = pmtt.dottest(G, rtol=1e-12, device="cpu")
    for edge in (False, True):
        L = pmtt.MPILaplacian(dims, axes=(0, 1), weights=(1.0, 2.0),
                              sampling=(1.0, 2.0), edge=edge, dtype=f64)
        derivatives.paths.clear()
        yl = L.matvec(x)
        out[f"lap{edge}"] = (yl.array.numpy(), L.rmatvec(yl).array.numpy(),
                             dict(derivatives.paths),
                             pmtt.dottest(L, rtol=1e-12, device="cpu"))
    St = pmtt.MPIStackedVStack([
        pmtt.MPIFirstDerivative(dims, dtype=f64),
        2.0 * pmtt.MPISecondDerivative(dims, edge=True, dtype=f64)])
    ys = St.matvec(x)
    out["stack"] = (ys.asarray(), St.rmatvec(ys).array.numpy(),
                    St.local_shapes_m,
                    pmtt.dottest(St, rtol=1e-12, device="cpu"))
    # a BROADCAST input is cut to each rank's rows
    xb = D.to_dist(f.ravel(), partition=pmtt.Partition.BROADCAST,
                   device="cpu")
    out["bcast"] = G.matvec(xb).asarray()
    return out


@pytest.mark.parametrize("n", WORLDS)
def test_gradient_laplacian_stack(n, tmp_path, rng, monkeypatch):
    import pylops_mpi_tpu as pmt
    dims = (13, 6)
    f, g0, g1 = (rng.standard_normal(dims) for _ in range(3))
    monkeypatch.setenv("PYLOPS_MPI_TPU_EXPLICIT_STENCIL", "0")

    def reference():
        mesh = jax_mesh(n)
        J = pmt.DistributedArray
        G = pmt.MPIGradient(dims, sampling=(1.0, 0.5), edge=True, mesh=mesh,
                            dtype=np.float64)
        lay = G.Op.ops[0]._out_locals
        x = J.to_dist(f.ravel(), mesh=mesh, local_shapes=lay)
        y = G.matvec(x)
        v = pmt.StackedDistributedArray([J.to_dist(g.ravel(), mesh=mesh,
                                                   local_shapes=lay)
                                         for g in (g0, g1)])
        St = pmt.MPIStackedVStack([
            pmt.MPIFirstDerivative(dims, mesh=mesh, dtype=np.float64),
            2.0 * pmt.MPISecondDerivative(dims, edge=True, mesh=mesh,
                                          dtype=np.float64)])
        ys = St.matvec(x)
        laps = {}
        for edge in (False, True):
            L = pmt.MPILaplacian(dims, axes=(0, 1), weights=(1.0, 2.0),
                                 sampling=(1.0, 2.0), edge=edge, mesh=mesh,
                                 dtype=np.float64)
            yl = L.matvec(x)
            laps[edge] = (yl.local_arrays(), L.rmatvec(yl).local_arrays())
        return lay, y, G.rmatvec(v), ys, St.rmatvec(ys), laps

    res, ref = run_world(_grad_rank, n, tmp_path, f, g0, g1, dims,
                         during=reference)
    lay, y, xa, ys, xs, laps = ref
    for r, o in enumerate(res):
        for got, want in zip(o["grad"], y.distarrays):
            close(got, want.local_arrays()[r])
        # the axis-0 component on the exchange, axis 1 on the shard
        assert o["grad_paths"] == {"explicit": 1, "local": 1}
        close(o["grad_adj"], xa.local_arrays()[r])
        assert o["grad_dot"]
        for edge in (False, True):
            got_y, got_a, paths, dot = o[f"lap{edge}"]
            close(got_y, laps[edge][0][r])
            close(got_a, laps[edge][1][r])
            assert dot
            assert paths == ({"local": 2} if n == 1
                             else {"explicit": 2, "local": 2})
        ga, gxs, lsm, dot = o["stack"]
        close(ga, ys.asarray())
        close(gxs, xs.local_arrays()[r])
        assert lsm == tuple(lay) and dot
        close(o["bcast"], y.asarray())


# ------------------------------------------------- the world-of-one fixes

def test_blockdiag_positional_order(rng):
    import pylops_mpi_tpu_torch as pmtt
    from pylops_mpi_tpu_torch.ops.local import MatrixMult
    mats = [MatrixMult(torch.from_numpy(b))
            for b in _blocks(rng, [(5, 4)] * 3)]
    # the JAX package's order: (ops, mask, mesh, dtype, compute_dtype,
    # normal_path)
    op = pmtt.MPIBlockDiag(mats, [7], None, torch.float64, torch.float32,
                           "two_sweep")
    assert op.mask == (7,) and op.dtype == torch.float64
    assert op.compute_dtype == torch.float32 and op._batched.dtype == torch.float32
    assert not op.has_fused_normal
    assert pmtt.MPIBlockDiag(mats, None, None, None, None, "fused") \
        .has_fused_normal
    y = op.matvec(pmtt.DistributedArray.to_dist(np.ones(12), device="cpu",
                                                mask=[7]))
    assert y.mask == (7,)
    with pytest.raises(ValueError, match="normal_path"):
        pmtt.MPIBlockDiag(mats, normal_path="sometimes")
    # the blocks split over the process group; a mesh must describe it
    here = pmtt.parallel.make_mesh("cpu")
    assert len(pmtt.MPIBlockDiag(mats, None, here).ops) == 3
    with pytest.raises(ValueError, match="does not match the process group"):
        pmtt.MPIBlockDiag(mats, None, pmtt.parallel.Mesh(None, 0, 2, here.device))


def test_stacked_blockdiag_todense_diagonal(rng):
    import pylops_mpi_tpu as pmt
    import pylops_mpi_tpu_torch as pmtt
    from pylops_mpi_tpu.ops.local import MatrixMult as JM
    from pylops_mpi_tpu_torch.ops.blockdiag import MPIStackedBlockDiag
    blocks = _blocks(rng, [(6, 4)] * 8)
    hetero = _blocks(rng, [(3, 5), (4, 4), (2, 3)])
    jops = [pmt.MPIBlockDiag([JM(b) for b in blocks]),
            pmt.MPIBlockDiag([JM(b) for b in hetero])]
    tops = [pmtt.convert.blockdiag_from_numpy(blocks, device="cpu"),
            pmtt.convert.blockdiag_from_numpy(hetero, device="cpu")]
    for j, t in zip(jops, tops):
        close(t.diagonal().numpy(), j.diagonal())
        close(t.todense(), j.todense())
        close((2.0 * t.H).todense(device="cpu"), (2.0 * j.H).todense())
    jS = pmt.ops.blockdiag.MPIStackedBlockDiag(jops)
    tS = MPIStackedBlockDiag(tops)
    assert tS.shape == jS.shape and tS.dtype == torch.float64
    xs = [rng.standard_normal(o.shape[1]) for o in jops]
    ys = [rng.standard_normal(o.shape[0]) for o in jops]
    jy = jS.matvec(pmt.StackedDistributedArray(
        [pmt.DistributedArray.to_dist(x) for x in xs]))
    ty = tS.matvec(pmtt.convert.stacked_from_numpy(xs, device="cpu"))
    close(ty.asarray(), jy.asarray())
    jx = jS.rmatvec(pmt.StackedDistributedArray(
        [pmt.DistributedArray.to_dist(y) for y in ys]))
    tx = tS.rmatvec(pmtt.convert.stacked_from_numpy(ys, device="cpu"))
    close(tx.asarray(), jx.asarray())
    # the stacked product guard: operand lengths must match
    with pytest.raises(ValueError, match="different number of ops"):
        tS @ MPIStackedBlockDiag(tops[:1])
    with pytest.raises(ValueError, match="different number of ops"):
        jS @ pmt.ops.blockdiag.MPIStackedBlockDiag(jops[:1])
    sq = MPIStackedBlockDiag([pmtt.convert.blockdiag_from_numpy(
        _blocks(rng, [(3, 3)] * k), device="cpu") for k in (2, 3)])
    assert (sq @ sq).shape == (15, 15)


def test_example_plot_mpilinop():
    """``examples/plot_mpilinop.py``'s flow through both packages."""
    import pylops_mpi_tpu as pmt
    import pylops_mpi_tpu_torch as pmtt
    from pylops_mpi_tpu.ops.local import FirstDerivative as JF
    from pylops_mpi_tpu_torch.ops.local import FirstDerivative as TF
    Ny, Nx = 11, 22
    out = []
    for P, F, kw in ((pmt, JF, {}), (pmtt, TF, {"device": "cpu"})):
        Mop = P.asmpilinearoperator(F((Ny, Nx), axis=0, dtype=np.float64))
        x = P.DistributedArray.to_dist(np.ones(Ny * Nx),
                                       partition=P.Partition.BROADCAST, **kw)
        y = Mop @ x
        V = P.MPIVStack([F((Ny, Nx), axis=0, dtype=np.float64)
                         for _ in range(8)])
        yv = V.matvec(x)
        xadj = V.rmatvec(yv)
        Comb = 2.0 * Mop + Mop.H * Mop
        yc = Comb @ x
        P.dottest(Mop, x, y.copy())
        out.append(dict(y=y.asarray(), ny=float(y.norm()),
                        part=(y.partition.name, yv.partition.name,
                              xadj.partition.name),
                        shape=yv.global_shape, xadj=xadj.asarray(),
                        nc=float(yc.norm()), yc=yc.asarray()))
    j, t = out
    assert j["part"] == t["part"] == ("BROADCAST", "SCATTER", "BROADCAST")
    assert j["shape"] == t["shape"]
    for k in ("y", "ny", "xadj", "nc", "yc"):
        close(t[k], j[k])


def test_example_plot_stacked_array():
    """``examples/plot_stacked_array.py``'s flow through both packages."""
    import pylops_mpi_tpu as pmt
    import pylops_mpi_tpu_torch as pmtt
    out = []
    for P, kw in ((pmt, {}), (pmtt, {"device": "cpu"})):
        rng = np.random.default_rng(11)
        a = P.DistributedArray.to_dist(rng.standard_normal((16, 4)), axis=0,
                                       **kw)
        b = P.DistributedArray.to_dist(rng.standard_normal(24),
                                       partition=P.Partition.BROADCAST, **kw)
        s = P.StackedDistributedArray([a, b])
        s2 = (s + s) * 0.5 - s
        t = P.StackedDistributedArray([a.copy(), b.copy()])
        out.append(dict(zero=float(s2.norm()),
                        dot=complex(np.asarray(s.dot(t)).item()),
                        n2=float(s.norm(2)), ninf=float(s.norm(np.inf)),
                        shapes=[d.asarray().shape for d in s.distarrays],
                        gathered=s.asarray()))
    j, t = out
    assert j["zero"] == t["zero"] == 0.0
    assert j["shapes"] == t["shapes"] == [(16, 4), (24,)]
    for k in ("dot", "n2", "ninf", "gathered"):
        close(t[k], j[k])
