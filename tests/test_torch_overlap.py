"""The pipelined (overlap) collectives and their consumers across ranks,
held against the JAX package with overlap on, on a mesh of the same size:
``ring_pass`` (every owner visited once, tuple blocks), ``ring_halo_ghosts``
against the bulk exchange, ``resolve_chunks``'s fallback and its log, the
overlap path of the first and second derivatives over kinds, orders and
edges (a ragged world among them) and its ``2w`` gate, ``MPIHalo``'s
overlap select, ``ghosted`` (which has no overlap argument, as in JAX),
the stack's ring adjoint and the ``MPIHStack`` forward over it, SUMMA's
three rings with a padded ``(N, K, M)``, the FFT's chunked transposes (and
a chunk count that falls back), the sparse ring adjoint, CGLS through the
ring stack, gradients
through the derivative's ghosts and SUMMA's rings against ``jax.grad``,
and the knobs' resolution; with no group, overlap on gives the bulk
result bit for bit.

Two gloo worlds, of 2 and 3 ranks, are spawned once each and at the same
time (``run_world`` of ``test_torch_process_group.py``), and every case
runs in both; the JAX references run in this process meanwhile. The
cases are tests of their own, which read the worlds' results from a
module fixture. With overlap off the operators run the bulk schedules,
which their own test files hold against the JAX package.

Tolerances: rtol 1e-12 relative to the largest entry of the reference in
f64 (the rings and chunks sum in other orders than the JAX package's
schedules); CGLS (5 iterations) 1e-10. Copies (the halo, ``ghosted``,
the ghost slabs) are bitwise.
"""

import logging
import time
import warnings

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from test_torch_process_group import _entry, close, jax_mesh, run_world

WORLDS = (2, 3)
DIMS = (13, 5)          # rows (7, 6) at two ranks, (5, 4, 4) at three
GATE_DIMS = (9, 4)      # rows (3, 3, 3) at three: short of 2w = 4
D1 = [("centered", 5, True), ("centered", 3, True), ("forward", 3, False),
      ("backward", 3, False)]
D2 = [("centered", True), ("forward", False), ("backward", False)]
MM = (7, 9, 4)          # (N, K, M): padded tiles on (1, 2) and (1, 3)
FFT = (12, 8)


def _data():
    rng = np.random.default_rng(11)
    sp = rng.standard_normal((10, 8)) * (rng.random((10, 8)) < 0.4)
    return dict(
        x=rng.standard_normal(int(np.prod(DIMS))),
        xg=rng.standard_normal(int(np.prod(GATE_DIMS))),
        w=rng.standard_normal(int(np.prod(DIMS))),
        A=rng.standard_normal(MM[:2]), xm=rng.standard_normal(MM[1] * MM[2]),
        ym=rng.standard_normal(MM[0] * MM[2]),
        wm=rng.standard_normal(MM[0] * MM[2]),
        blocks=[rng.standard_normal((5, 4)) for _ in range(6)],
        ys=rng.standard_normal(30), Ys=rng.standard_normal((30, 2)),
        xs=rng.standard_normal(4),
        xf=rng.standard_normal(96) + 1j * rng.standard_normal(96),
        sp=sp, yp=rng.standard_normal(10),
        field=rng.standard_normal((8, 6)), g=rng.standard_normal((20, 3)))


def _rows_layout(dims, n):
    """The derivatives' flat row layout: the balanced split of axis 0."""
    inner = int(np.prod(dims[1:]))
    return [(len(r) * inner,) for r in np.array_split(np.arange(dims[0]), n)]


# --------------------------------------------------------------- ranks

def _overlap_rank(d):
    import pylops_mpi_tpu_torch as pmtt
    from pylops_mpi_tpu_torch import DistributedArray as D
    from pylops_mpi_tpu_torch.ops import derivatives
    from pylops_mpi_tpu_torch.ops import local as tl
    from pylops_mpi_tpu_torch.ops.halo import halo_block_split
    from pylops_mpi_tpu_torch.parallel import collectives as co
    from pylops_mpi_tpu_torch.utils import deps
    n, r = pmtt.parallel.world_size(), pmtt.parallel.rank()
    out = {}

    def vec(a, **kw):
        return D.to_dist(a, device="cpu", **kw)

    def counted(fn):
        co.reset_counts()
        res = fn()
        return res, dict(co.counts), dict(co.steps)

    # ring_pass: every owner's block once, a tuple of mixed dtypes
    blk = (torch.full((2,), float(10 * r)),
           torch.tensor([r], dtype=torch.int32))
    out["ring"] = counted(lambda: co.ring_pass(
        blk, lambda acc, res, owner, s: acc + [
            (float(res[0][0]), int(res[1][0]), owner, s)], init=[]))
    out["auto_gloo"] = deps.overlap_enabled("auto")
    # ring_halo_ghosts against the bulk exchange, and the zero-width side
    b = torch.arange(4 * 3, dtype=torch.float64).reshape(4, 3) + 100 * r
    co.reset_counts()
    top, bottom = co.halo_exchange(b, 2, 1)
    bulk_bytes = co.received["halo_exchange"]
    ghosts = co.ring_halo_ghosts(b, 2, 1)
    gf, gb = ghosts.wait()
    out["ghosts"] = dict(
        bulk=[p.numpy() if isinstance(p, torch.Tensor) else p
              for p in (top, bottom)], gf=gf.numpy(), gb=gb.numpy(),
        bytes=(bulk_bytes, co.received["ring_halo_ghosts"]),
        none=co.ring_halo_ghosts(b, 0, 1).wait()[0] is None,
        extend=co.ring_halo_extend(b, 2, 1).numpy())
    # derivatives: the overlap path against its own bulk path and JAX
    der = {}
    for key, cls, kw in (
            [(("d1",) + c, pmtt.MPIFirstDerivative,
              dict(kind=c[0], order=c[1], edge=c[2])) for c in D1]
            + [(("d2",) + c, pmtt.MPISecondDerivative,
                dict(kind=c[0], edge=c[1])) for c in D2]):
        op = cls(DIMS, overlap="on", **kw)
        xd = vec(d["x"], local_shapes=op.local_shapes_m)
        derivatives.paths.clear()
        (y, xa), calls, steps = counted(
            lambda: (op.matvec(xd).asarray(), op.rmatvec(xd).asarray()))
        bulk = cls(DIMS, overlap="off", **kw)
        der[key] = dict(y=y, xa=xa, paths=dict(derivatives.paths),
                        calls=calls,
                        bulk=(bulk.matvec(xd).asarray(),
                              bulk.rmatvec(xd).asarray()))
    out["deriv"] = der
    # the 2w gate: short shards keep the bulk exchange
    op = pmtt.MPIFirstDerivative(GATE_DIMS, kind="centered", order=5,
                                 edge=True, overlap="on")
    xd = vec(d["xg"], local_shapes=op.local_shapes_m)
    derivatives.paths.clear()
    (y, xa), calls, _ = counted(lambda: (op.matvec(xd).asarray(),
                                         op.rmatvec(xd).asarray()))
    bulk = pmtt.MPIFirstDerivative(GATE_DIMS, kind="centered", order=5,
                                   edge=True, overlap="off")
    out["gate"] = dict(y=y, xa=xa, paths=dict(derivatives.paths), calls=calls,
                       bulk=(bulk.matvec(xd).asarray(),
                             bulk.rmatvec(xd).asarray()))
    # MPIHalo: a copy, bitwise the bulk path
    grid = (n, 1)
    f = d["field"]
    H = pmtt.MPIHalo(f.shape, (1, 2), grid, overlap="on")
    Hb = pmtt.MPIHalo(f.shape, (1, 2), grid, overlap="off")
    xh = vec(np.concatenate([f[halo_block_split(f.shape, q, grid)].ravel()
                             for q in range(n)]),
             local_shapes=H.local_dim_sizes)
    yh, calls, _ = counted(lambda: H.matvec(xh))
    out["halo"] = dict(y=yh.asarray(), bulk=Hb.matvec(xh).asarray(),
                       calls=calls)
    g = vec(d["g"])
    out["ghosted"] = g.ghosted(1, 2).asarray()
    # the stack's ring adjoint and MPIHStack's forward over it
    V = pmtt.MPIVStack([tl.MatrixMult(torch.from_numpy(m))
                        for m in d["blocks"]], overlap="on")
    Hs = pmtt.MPIHStack([tl.MatrixMult(torch.from_numpy(m.T.copy()))
                         for m in d["blocks"]], overlap="on")
    yv = vec(d["ys"], local_shapes=V.local_shapes_n)
    Yv = vec(d["Ys"], local_shapes=[s + (2,) for s in V.local_shapes_n])
    xv, calls, steps = counted(lambda: V.rmatvec(yv))
    out["stack"] = dict(
        ring=V._ring, xa=xv.asarray(), calls=calls, steps=steps,
        Xa=V.rmatvec(Yv).asarray(), hy=Hs.matvec(
            vec(d["ys"], local_shapes=Hs.local_shapes_m)).asarray(),
        y=V.matvec(vec(d["xs"], partition=pmtt.Partition.BROADCAST))
        .asarray(),
        cgls=pmtt.cgls(V, yv, x0=vec(np.zeros(4),
                                     partition=pmtt.Partition.BROADCAST),
                       niter=5, tol=0.0)[0].asarray())
    # SUMMA's rings on a (1, n) grid
    N, K, M = MM
    mm = {}
    for sch in ("gather", "stat_a"):
        op = pmtt.MPIMatrixMult(d["A"], M, kind="summa", grid=(1, n),
                                schedule=sch, overlap="on", device="cpu")
        xm = vec(d["xm"])
        y, calls, steps = counted(lambda: op.matvec(xm))
        mm[sch] = dict(y=y.asarray(), calls=calls, steps=steps)
    ym = vec(d["ym"])
    xa, calls, steps = counted(lambda: op.rmatvec(ym))
    mm["adj"] = dict(y=xa.asarray(), calls=calls, steps=steps)
    out["summa"] = mm
    # the FFT's chunked transposes, and a count that falls back
    fft = {}
    for k in (2, 64):
        F = pmtt.MPIFFTND(FFT, axes=(0, 1), overlap="on", comm_chunks=k)
        xf = vec(d["xf"], local_shapes=F.model_local_shapes)
        y, calls, steps = counted(lambda: F.matvec(xf))
        fft[k] = dict(y=y.asarray(), xa=F.rmatvec(y).asarray(), calls=calls,
                      steps=steps)
    out["fft"] = fft
    # the sparse ring adjoint
    S = pmtt.MPISparseMatrixMult.from_dense(d["sp"], adjoint_mode="ring",
                                            device="cpu")
    yp = vec(d["yp"], local_shapes=S.local_shapes_n)
    xa, calls, steps = counted(lambda: S.rmatvec(yp))
    out["sparse"] = dict(xa=xa.asarray(), calls=calls, steps=steps)
    out["grad"] = _grad_cases(d, pmtt, co, vec)
    return out


def _grad_ops(mod, d, n, **kw):
    """The gradient cases, ``(name, apply, x, w)``: the derivative's
    overlap path, SUMMA's adjoint ring (the Y tiles, which carry the
    gradient, rotate) and its stat_a ring reduce-scatter."""
    N, K, M = MM

    def mm(sch):
        return mod.MPIMatrixMult(d["A"], M, kind="summa", grid=(1, n),
                                 schedule=sch, overlap="on", **kw)
    der = mod.MPIFirstDerivative(DIMS, kind="centered", order=5, edge=True,
                                 overlap="on", **{k: v for k, v in kw.items()
                                                  if k == "mesh"})
    return (("deriv", der.matvec, d["x"], d["w"]),
            ("summa_adj", mm("gather").rmatvec, d["ym"], d["xm"]),
            ("summa_stat_a", mm("stat_a").matvec, d["xm"], d["wm"]))


def _grad_cases(d, pmtt, co, vec):
    """Each rank's shard of the gradient of ``Σ w·y`` (summed over the
    ranks, so that every rank runs the backward) through the derivative's
    overlap path and SUMMA's rings, and the collective counts of forward
    and backward."""
    out = {}
    n = pmtt.parallel.world_size()
    for name, apply, x, w in _grad_ops(pmtt, d, n, device="cpu"):
        lsh = _rows_layout(DIMS, n) if name == "deriv" else None
        xd = vec(x, local_shapes=lsh)
        xd.array.requires_grad_(True)
        co.reset_counts()
        y = apply(xd)
        wl = torch.from_numpy(w).reshape(-1).split(
            [s[0] for s in y.local_shapes])[pmtt.parallel.rank()]
        loss = co.all_reduce((wl * y.array).sum().reshape(1))
        fwd = dict(co.counts)
        (gr,) = torch.autograd.grad(loss.sum(), xd.array)
        out[name] = dict(g=gr.numpy(), fwd=fwd, all=dict(co.counts),
                         steps=dict(co.steps),
                         lsh=[s[0] for s in xd.local_shapes])
    return out


# ------------------------------------------------------------ reference

def _jitted(fn, x):
    """``fn(x)`` of the JAX package, one jitted program over ``x``'s
    buffer (eagerly, each apply dispatches its shard_map kernel's pieces
    one by one, 10-40 times slower on the CPU mesh), as the global array."""
    import jax
    import pylops_mpi_tpu as pmt
    J = pmt.DistributedArray
    return np.asarray(jax.jit(lambda a: fn(J._wrap(a, x))._global())(x._arr))


def _reference(d):
    """The JAX package with overlap on, per world size."""
    import pylops_mpi_tpu as pmt
    from pylops_mpi_tpu.ops import local as jl
    from pylops_mpi_tpu.ops.halo import halo_block_split
    J = pmt.DistributedArray
    refs = {}
    for n in WORLDS:
        mesh = jax_mesh(n)
        ref = {}

        def vec(a, **kw):
            return J.to_dist(a, mesh=mesh, **kw)

        der = {}
        xd = vec(d["x"], local_shapes=_rows_layout(DIMS, n))
        for key, cls, kw in (
                [(("d1",) + c, pmt.MPIFirstDerivative,
                  dict(kind=c[0], order=c[1], edge=c[2])) for c in D1]
                + [(("d2",) + c, pmt.MPISecondDerivative,
                    dict(kind=c[0], edge=c[1])) for c in D2]):
            op = cls(DIMS, mesh=mesh, overlap="on", **kw)
            der[key] = (_jitted(op.matvec, xd), _jitted(op.rmatvec, xd))
        ref["deriv"] = der
        op = pmt.MPIFirstDerivative(GATE_DIMS, kind="centered", order=5,
                                    edge=True, mesh=mesh, overlap="on")
        xd = vec(d["xg"], local_shapes=_rows_layout(GATE_DIMS, n))
        ref["gate"] = (_jitted(op.matvec, xd), _jitted(op.rmatvec, xd))
        f = d["field"]
        grid = (n, 1)
        H = pmt.MPIHalo(f.shape, (1, 2), grid, mesh=mesh, overlap="on")
        xh = vec(np.concatenate([f[halo_block_split(f.shape, q, grid)]
                                 .ravel() for q in range(n)]),
                 local_shapes=H.local_dim_sizes)
        ref["halo"] = _jitted(H.matvec, xh)
        ref["ghosted"] = _jitted(lambda x: x.ghosted(1, 2), vec(d["g"]))
        V = pmt.MPIVStack([jl.MatrixMult(m) for m in d["blocks"]],
                          mesh=mesh, overlap="on")
        Hs = pmt.MPIHStack([jl.MatrixMult(m.T.copy()) for m in d["blocks"]],
                           mesh=mesh, overlap="on")
        yv = vec(d["ys"], local_shapes=V.local_shapes_n)
        ref["stack"] = dict(
            xa=_jitted(V.rmatvec, yv),
            Xa=_jitted(V.rmatvec, vec(d["Ys"], local_shapes=[
                s + (2,) for s in V.local_shapes_n])),
            hy=_jitted(Hs.matvec, vec(d["ys"])),
            cgls=np.asarray(pmt.cgls(V, yv, x0=vec(
                np.zeros(4), partition=pmt.Partition.BROADCAST), niter=5,
                tol=0.0)[0].asarray()))
        N, K, M = MM
        mm = {}
        for sch in ("gather", "stat_a"):
            op = pmt.MPIMatrixMult(d["A"], M, mesh=mesh, kind="summa",
                                   grid=(1, n), schedule=sch, overlap="on")
            mm[sch] = _jitted(op.matvec, vec(d["xm"]))
        mm["adj"] = _jitted(op.rmatvec, vec(d["ym"]))
        ref["summa"] = mm
        F = pmt.MPIFFTND(FFT, axes=(0, 1), mesh=mesh, overlap="on",
                         comm_chunks=2)
        xf = vec(d["xf"], local_shapes=F.model_local_shapes)
        yf = F.matvec(xf)
        ref["fft"] = (_jitted(F.matvec, xf), _jitted(F.rmatvec, yf))
        S = pmt.MPISparseMatrixMult.from_dense(d["sp"], mesh=mesh,
                                               adjoint_mode="ring")
        ref["sparse"] = _jitted(S.rmatvec, vec(d["yp"]))
        ref["grad"] = _jax_grads(d, n, mesh)
        refs[n] = ref
    return refs


def _jax_grads(d, n, mesh):
    """``jax.grad`` of ``Σ w·y`` through the JAX package's derivative and
    SUMMA gather ring with overlap on, as the global array."""
    import jax
    import jax.numpy as jnp
    import pylops_mpi_tpu as pmt
    J = pmt.DistributedArray
    out = {}
    for name, apply, x, w in _grad_ops(pmt, d, n, mesh=mesh):
        lsh = _rows_layout(DIMS, n) if name == "deriv" else None
        xd = J.to_dist(x, mesh=mesh, local_shapes=lsh)
        wj = jnp.asarray(w)

        def loss(a, apply=apply, xd=xd, wj=wj):
            return jnp.sum(wj * apply(J._wrap(a, xd))._global())

        g = jax.jit(jax.grad(loss))(xd._arr)
        out[name] = np.asarray(J._wrap(g, xd).asarray())
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds' rank results (spawned together) and the JAX
    references computed meanwhile."""
    d = _data()
    t0 = time.monotonic()
    tmp3 = tmp_path_factory.mktemp("w3")
    (tmp3 / "world3").mkdir()
    ctx3 = mp.spawn(_entry, args=(_overlap_rank, 3, str(tmp3 / "store3"),
                                  str(tmp3 / "world3"), (d,)),
                    nprocs=3, join=False)
    res2, ref = run_world(_overlap_rank, 2, tmp_path_factory.mktemp("w2"), d,
                          during=lambda: _reference(d))
    while not ctx3.join(timeout=max(0.1, 120 - (time.monotonic() - t0))):
        if time.monotonic() - t0 > 120:
            for p in ctx3.processes:
                p.kill()
            pytest.fail("the world of 3 ranks did not finish in 120 s")
    import pickle
    res3 = []
    for r in range(3):
        with open(tmp3 / "world3" / f"rank{r}.pkl", "rb") as f:
            res3.append(pickle.load(f))
    return d, {2: (res2, ref[2]), 3: (res3, ref[3])}


def _each(worlds):
    for n, (res, ref) in worlds[1].items():
        for r, o in enumerate(res):
            yield n, r, o, ref


def _shard(full, sizes, r):
    off = int(np.sum(sizes[:r]))
    return full[off:off + sizes[r]]


# ---------------------------------------------------------------- cases

def test_ring_pass_visits_every_owner_once(worlds):
    for n, r, o, _ in _each(worlds):
        seen, calls, steps = o["ring"]
        assert [s for *_, s in seen] == list(range(n))
        owners = [owner for _, _, owner, _ in seen]
        assert sorted(owners) == list(range(n)) and owners[0] == r
        # the resident at each step is its owner's block, both members
        assert all(v == 10 * owner and i == owner for v, i, owner, _ in seen)
        assert calls == {"ring_pass": 1} and steps == {"ring_pass": n - 1}
        assert o["auto_gloo"] is False  # auto: off under gloo


def test_ring_halo_ghosts_match_bulk_slab(worlds):
    for n, r, o, _ in _each(worlds):
        g = o["ghosts"]
        top, bottom = g["bulk"]
        if r > 0:
            np.testing.assert_array_equal(g["gf"], top)
        else:  # zeros past the domain's edge (the bulk gives a count)
            assert top == 2 and not g["gf"].any() and g["gf"].shape == (2, 3)
        if r < n - 1:
            np.testing.assert_array_equal(g["gb"], bottom)
        else:
            assert bottom == 1 and not g["gb"].any()
        assert g["bytes"][0] == g["bytes"][1] and g["none"]
        b = np.arange(12.0).reshape(4, 3) + 100 * r
        np.testing.assert_array_equal(
            g["extend"], np.concatenate([g["gf"], b, g["gb"]]))


def test_resolve_chunks_falls_back_and_logs(caplog):
    from pylops_mpi_tpu.parallel import collectives as jco
    from pylops_mpi_tpu_torch.diagnostics import trace
    from pylops_mpi_tpu_torch.parallel import collectives as co
    for args in [(16, 2, 4), (16, 4, 8), (5, 2, 4), (7, 3, 1), (3, 4, 2),
                 (9, 1, 4), (8, 2, 0)]:
        assert co.resolve_chunks(*args) == jco.resolve_chunks(*args), args
    trace.clear_events()
    with pytest.MonkeyPatch.context() as mpatch:
        mpatch.setenv("PYLOPS_MPI_TPU_TORCH_TRACE", "spans")
        with caplog.at_level(logging.INFO,
                             logger="pylops_mpi_tpu_torch.parallel."
                                    "collectives"):
            assert co.resolve_chunks(5, 2, 4) == 2
        ev = [e for e in trace.get_events()
              if e["name"] == "collective.resolve_chunks_fallback"]
    assert "falling back to 2 chunk(s)" in caplog.text
    assert ev and ev[-1]["args"]["resolved"] == 2
    trace.clear_events()


@pytest.mark.parametrize("key", [("d1",) + c for c in D1]
                         + [("d2",) + c for c in D2])
def test_derivative_overlap_matches_jax(worlds, key):
    for n, r, o, ref in _each(worlds):
        got = o["deriv"][key]
        close(got["y"], ref["deriv"][key][0])
        close(got["xa"], ref["deriv"][key][1])
        # the overlap path ran in both directions, the ghosts posted once
        # an apply; on the CPU it is the bulk path's arithmetic, bit for
        # bit
        assert got["paths"] == {"explicit": 2, "overlap": 2}
        assert got["calls"].get("ring_halo_ghosts") == 2
        assert "halo_exchange" not in got["calls"]
        np.testing.assert_array_equal(got["y"], got["bulk"][0])
        np.testing.assert_array_equal(got["xa"], got["bulk"][1])


def test_derivative_gate_keeps_bulk(worlds):
    for n, r, o, ref in _each(worlds):
        g = o["gate"]
        close(g["y"], ref["gate"][0])
        close(g["xa"], ref["gate"][1])
        if n == 3:  # (3, 3, 3) rows: short of 2w = 4
            assert g["paths"] == {"explicit": 2}
            assert g["calls"].get("halo_exchange") == 2
        else:       # (5, 4) rows
            assert g["paths"] == {"explicit": 2, "overlap": 2}
        np.testing.assert_array_equal(g["y"], g["bulk"][0])


def test_halo_overlap_matches_jax(worlds):
    for n, r, o, ref in _each(worlds):
        np.testing.assert_array_equal(o["halo"]["y"], ref["halo"])
        np.testing.assert_array_equal(o["halo"]["y"], o["halo"]["bulk"])
        assert o["halo"]["calls"] == {"cart_halo_extend": 1}


def test_ghosted_overlap_matches_jax(worlds):
    for n, r, o, ref in _each(worlds):
        np.testing.assert_array_equal(o["ghosted"], ref["ghosted"])


def test_stack_ring_adjoint_matches_jax(worlds):
    for n, r, o, ref in _each(worlds):
        s = o["stack"]
        assert s["ring"]
        close(s["xa"], ref["stack"]["xa"])
        close(s["Xa"], ref["stack"]["Xa"])
        close(s["hy"], ref["stack"]["hy"])
        # P chunk GEMMs, P - 1 hops, one gather back to BROADCAST
        assert s["calls"] == {"ring_reduce_scatter": 1, "all_gather": 1}
        assert s["steps"] == {"ring_reduce_scatter": n - 1}
        close(s["cgls"], ref["stack"]["cgls"], rtol=1e-10)


@pytest.mark.parametrize("which", ["gather", "stat_a", "adj"])
def test_summa_rings_match_jax(worlds, which):
    for n, r, o, ref in _each(worlds):
        got = o["summa"][which]
        close(got["y"], ref["summa"][which])
        name = "ring_reduce_scatter" if which == "stat_a" else "ring_pass"
        assert got["calls"][name] == 1
        assert got["steps"] == {name: n - 1}
        # the c-axis collective became the ring (grid (1, n): the r axis
        # has one rank and moves nothing); stat_a still gathers X along c
        if which == "stat_a":
            assert "reduce_scatter" not in got["calls"]
            assert got["calls"]["all_gather"] == 1
        else:
            assert "all_gather" not in got["calls"]


def test_fft_chunked_matches_jax(worlds):
    for n, r, o, ref in _each(worlds):
        f2, f64 = o["fft"][2], o["fft"][64]
        close(f2["y"], ref["fft"][0])
        close(f2["xa"], ref["fft"][1])
        assert f2["calls"] == {"chunked_pencil_transpose": 1}
        assert f2["steps"] == {"chunked_pencil_transpose": 2}
        # 64 chunks do not fit: the out-axis (8 wide) caps them at 8 // n
        close(f64["y"], ref["fft"][0])
        close(f64["xa"], ref["fft"][1])
        assert f64["steps"] == {"chunked_pencil_transpose": 8 // n}


def test_sparse_ring_matches_jax(worlds):
    for n, r, o, ref in _each(worlds):
        s = o["sparse"]
        close(s["xa"], ref["sparse"])
        assert s["calls"] == {"ring_pass": 1}
        assert s["steps"] == {"ring_pass": n - 1}


@pytest.mark.parametrize("name", ["deriv", "summa_adj", "summa_stat_a"])
def test_gradients_match_jax_grad(worlds, name):
    for n, r, o, ref in _each(worlds):
        g = o["grad"][name]
        close(g["g"], _shard(ref["grad"][name], g["lsh"], r))
        # each exchange of the forward has its adjoint (an all_gather's
        # backward is a reduce_scatter, not counted as an adjoint)
        fwd = {k: v for k, v in g["fwd"].items()
               if k not in ("all_reduce", "all_gather")}
        back = {k[:-len("_adjoint")]: v for k, v in g["all"].items()
                if k.endswith("_adjoint")}
        assert back == fwd
        ring = {"deriv": "ring_halo_ghosts", "summa_adj": "ring_pass",
                "summa_stat_a": "ring_reduce_scatter"}[name]
        assert fwd[ring] == 1
        if name != "deriv":
            assert g["steps"] == {ring: n - 1, ring + "_adjoint": n - 1}


def test_knob_resolution_matches_jax(monkeypatch):
    from pylops_mpi_tpu.utils import deps as jd
    from pylops_mpi_tpu_torch.utils import deps as td
    for k in ("PYLOPS_MPI_TPU_OVERLAP", "PYLOPS_MPI_TPU_TORCH_OVERLAP",
              "PYLOPS_MPI_TPU_COMM_CHUNKS",
              "PYLOPS_MPI_TPU_TORCH_COMM_CHUNKS"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(td, "_warned_overlap", False)
    monkeypatch.setattr(jd, "_warned_overlap", False)
    for raw in (None, "", "on", "OFF", " auto ", "default", "sideways"):
        for name, mod in (("PYLOPS_MPI_TPU_OVERLAP", jd),
                          ("PYLOPS_MPI_TPU_TORCH_OVERLAP", td)):
            if raw is None:
                monkeypatch.delenv(name, raising=False)
            else:
                monkeypatch.setenv(name, raw)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            assert td.overlap_mode() == jd.overlap_mode(), raw
            assert td.overlap_env_pinned() == jd.overlap_env_pinned()
            # the CPU: auto is off in both packages
            assert td.overlap_enabled() == jd.overlap_enabled()
    for user in (True, False, "on", "off", "auto", " On "):
        assert td.overlap_enabled(user) == jd.overlap_enabled(user), user
    with pytest.raises(ValueError, match="overlap"):
        td.overlap_enabled("sideways")
    monkeypatch.setattr(td, "_warned_overlap", False)
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_OVERLAP", "typo")
    with pytest.warns(UserWarning, match="typo"):
        assert td.overlap_mode() == "auto"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert td.overlap_mode() == "auto"  # warned once only
    for raw, want in [(None, 4), ("2", 2), ("0", 1), ("junk", 4)]:
        for name in ("PYLOPS_MPI_TPU_COMM_CHUNKS",
                     "PYLOPS_MPI_TPU_TORCH_COMM_CHUNKS"):
            if raw is None:
                monkeypatch.delenv(name, raising=False)
            else:
                monkeypatch.setenv(name, raw)
        assert td.comm_chunks_default() == jd.comm_chunks_default() == want
        assert td.comm_chunks_env_pinned() == jd.comm_chunks_env_pinned() \
            == (raw is not None)
    # no group: auto is off, an explicit "on" is on (and a world of one
    # then runs the bulk schedules)
    monkeypatch.delenv("PYLOPS_MPI_TPU_TORCH_OVERLAP", raising=False)
    assert td.overlap_enabled(None, "cuda") is False
    assert [k[0] for k in td.COLLECTIVE_KNOBS] == [
        "PYLOPS_MPI_TPU_TORCH_OVERLAP", "PYLOPS_MPI_TPU_TORCH_COMM_CHUNKS",
        "PYLOPS_MPI_TPU_TORCH_HIERARCHICAL"]


def test_world_of_one_overlap_is_bulk():
    """With no group, overlap on changes nothing: every operator of the
    slice gives the bulk result bit for bit, and nothing is counted."""
    import pylops_mpi_tpu_torch as pmtt
    from pylops_mpi_tpu_torch import DistributedArray as D
    from pylops_mpi_tpu_torch.ops import local as tl
    from pylops_mpi_tpu_torch.parallel import collectives as co
    d = _data()

    def vec(a, **kw):
        return D.to_dist(a, device="cpu", **kw)

    co.reset_counts()
    pairs = []
    for ov in ("on", "off"):
        out = []
        op = pmtt.MPIFirstDerivative(DIMS, kind="centered", order=5,
                                     edge=True, overlap=ov)
        out.append(op.matvec(vec(d["x"])).array)
        op = pmtt.MPIMatrixMult(d["A"], MM[2], kind="summa", overlap=ov,
                                device="cpu")
        out.append(op.matvec(vec(d["xm"])).array)
        out.append(op.rmatvec(vec(d["ym"])).array)
        V = pmtt.MPIVStack([tl.MatrixMult(torch.from_numpy(m))
                            for m in d["blocks"]], overlap=ov)
        out.append(V.rmatvec(vec(d["ys"])).array)
        F = pmtt.MPIFFTND(FFT, axes=(0, 1), overlap=ov, comm_chunks=2)
        out.append(F.matvec(vec(d["xf"])).array)
        S = pmtt.MPISparseMatrixMult.from_dense(
            d["sp"], adjoint_mode="ring" if ov == "on" else "scatter",
            device="cpu")
        out.append(S.rmatvec(vec(d["yp"])).array)
        H = pmtt.MPIHalo(d["field"].shape, (1, 2), overlap=ov)
        out.append(H.matvec(vec(d["field"].ravel())).array)
        pairs.append(out)
    for a, b in zip(*pairs):
        assert torch.equal(a, b)
    assert not co.counts and not co.steps


def test_graph_key_carries_the_schedule():
    """The bank of captured loops keys on an operator's resolved overlap
    and chunk count, so that a loop captured with overlap off is never
    replayed for an operator with overlap on."""
    import pylops_mpi_tpu_torch as pmtt
    from pylops_mpi_tpu_torch.aot import graphs
    from pylops_mpi_tpu_torch.aot.signature import schedule_signature
    F = {ov: pmtt.MPIFFTND(FFT, axes=(0, 1), overlap=ov, comm_chunks=2)
         for ov in ("on", "off")}
    G = pmtt.MPIGradient(DIMS, overlap="on")
    assert schedule_signature(F["on"]) == (("MPIFFTND", True, 2),)
    assert schedule_signature(F["off"]) == (("MPIFFTND", False, 2),)
    assert [s[1] for s in schedule_signature(G)] == [True, True]
    y = pmtt.DistributedArray.to_dist(np.zeros(F["on"].shape[0]),
                                      device="cpu")
    carry = [torch.zeros(3)]
    keys = [graphs.key("cgls", {}, F[ov], None, y, carry) for ov in F]
    i = keys[0].index(schedule_signature(F["on"]))
    assert keys[1][i] == schedule_signature(F["off"]) != keys[0][i]
