"""MPIMatrixMult across ranks, held against the JAX package on a mesh of
the same size, and the collectives it stands on: the 2-D grid of ranks
with its row and column sub-groups, ``reduce_scatter``, and
``all_to_all`` on a sub-group (world 4, two groups of two ranks) and on
the world.

One gloo world per size 1-4 runs every case (``run_world`` of
``test_torch_process_group.py``), the JAX reference in this process
meanwhile. Shapes that do not tile the grid (N=23, K=17, M=10), M below
the grid's column count (M=1), a block input ``(K·M, ncol)``, complex128,
every kind and schedule on the default grid and SUMMA on ``(n, 1)``.
Checked: values and output ``local_shapes`` against the JAX package,
each rank's tile of A, collective calls per apply, the bytes the SUMMA
collectives receive against the volume model, ``dottest`` and 5
iterations of CGLS.

Gradients (block and SUMMA): of ``0.5‖A x − y‖²`` with respect to x, by
autograd straight through ``matvec`` (the flat↔tile moves' ``all_to_all``
rule), and with respect to each rank's rows or tile of A, through
``make_differentiable(..., params=True)``, against ``jax.grad`` through
the JAX operator (for A, through its construction: the JAX SUMMA's
kernels read a padded copy of A that is not one of its pytree leaves,
so ``jax.grad`` by the leaf gives zero).

Tolerances: rtol 1e-12 of the largest reference entry (f64,
complex128); 1e-10 for CGLS and the gradients.
"""

import numpy as np
import pytest

from test_torch_process_group import WORLDS, close, jax_mesh, run_world

# (label, A key, M, ncol, kind, schedule, grid: None or "n1")
CASES = [("f64_block", "A", 10, None, "block", "auto", None),
         ("f64_gather", "A", 10, None, "summa", "gather", None),
         ("f64_stat_a", "A", 10, None, "summa", "stat_a", None),
         ("f64_auto", "A", 10, None, "summa", "auto", None),
         ("f64_kind_auto", "A", 10, None, "auto", "auto", None),
         ("f64_gather_n1", "A", 10, None, "summa", "gather", "n1"),
         ("f64_stat_a_n1", "A", 10, None, "summa", "stat_a", "n1"),
         ("c128_block", "Ac", 10, None, "block", "auto", None),
         ("c128_auto", "Ac", 10, None, "summa", "auto", None),
         ("skinny_gather", "As", 1, None, "summa", "gather", None),
         ("skinny_stat_a", "As", 1, None, "summa", "stat_a", None),
         ("ncol_block", "Ab", 5, 3, "block", "auto", None),
         ("ncol_gather", "Ab", 5, 3, "summa", "gather", None),
         ("ncol_stat_a", "Ab", 5, 3, "summa", "stat_a", None)]
CGLS = ("f64_block", "f64_auto", "c128_auto")
GRADS = ("f64_block", "f64_auto")


def _data():
    rng = np.random.default_rng(21)
    d = dict(A=rng.standard_normal((23, 17)),
             Ac=rng.standard_normal((23, 17))
             + 1j * rng.standard_normal((23, 17)),
             As=rng.standard_normal((8, 6)),
             Ab=rng.standard_normal((11, 7)))
    for label, key, M, ncol, *_ in CASES:
        N, K = d[key].shape
        tail = () if ncol is None else (ncol,)
        cplx = np.iscomplexobj(d[key])

        def draw(n, tail=tail, cplx=cplx):
            v = rng.standard_normal((n,) + tail)
            return v + 1j * rng.standard_normal((n,) + tail) if cplx else v
        d["x_" + label], d["y_" + label] = draw(K * M), draw(N * M)
    return d


def _grid(spec, n):
    return (n, 1) if spec == "n1" else None


# --------------------------------------------------------------- ranks

def _collectives_rank():
    """The grid, sub-group collectives and ``reduce_scatter``, with no
    operator."""
    import torch
    import torch.distributed as dist
    import pylops_mpi_tpu_torch as pmtt
    from pylops_mpi_tpu_torch.ops.matrixmult import active_grid_comm
    from pylops_mpi_tpu_torch.parallel import collectives as co
    n, r = pmtt.parallel.world_size(), pmtt.parallel.rank()
    out = {}
    for grid in (None, (n, 1), (1, n)):
        g = pmtt.parallel.make_grid_2d(grid)
        v = torch.tensor([float(r)], dtype=torch.float64)
        out[str(grid)] = dict(
            shape=g.shape, coords=g.coords,
            c_sum=float(co.all_reduce(v.clone(), group=g.c)),
            r_sum=float(co.all_reduce(v.clone(), group=g.r)),
            c_size=dist.get_world_size(g.c), r_size=dist.get_world_size(g.r))
    try:
        pmtt.parallel.make_grid_2d((n + 1, 1))
        out["bad_grid"] = None
    except ValueError as e:
        out["bad_grid"] = str(e)
    # all_to_all on the world (default and explicit) with ragged pieces:
    # rank r sends q a (q + 1, r + 1) block of 10 r + q
    for name, group in (("world", None), ("WORLD", dist.group.WORLD)):
        sends = [torch.full((q + 1, r + 1), 10.0 * r + q) for q in range(n)]
        got = co.all_to_all(sends, [(r + 1, p + 1) for p in range(n)],
                            group)
        out["a2a_" + name] = [t.numpy() for t in got]
    # all_to_all and reduce_scatter on sub-groups (mask r // 2: at four
    # ranks two groups of two), sends listed by group rank
    grp = co.mask_group([q // 2 for q in range(n)])
    members = [q for q in range(n) if q // 2 == r // 2]
    me = members.index(r)
    sends = [torch.full((q + 1, r + 1), 10.0 * r + q)
             for q in range(len(members))]
    co.reset_counts()
    got = co.all_to_all(sends, [(me + 1, p + 1) for p in members], grp)
    out["a2a_group"] = dict(members=members,
                            got=[t.numpy() for t in got],
                            counts=dict(co.counts),
                            received=dict(co.received))
    sizes = [q + 2 for q in range(len(members))]
    t = torch.arange(float(sum(sizes) * 2)).reshape(-1, 2) * (r + 1)
    out["rs_group"] = co.reduce_scatter(t, sizes, 0, grp).numpy()
    sizes_w = [q + 1 for q in range(n)]
    tw = torch.arange(float(3 * sum(sizes_w))).reshape(3, -1) * (r + 1)
    co.reset_counts()
    out["rs_world"] = co.reduce_scatter(tw, sizes_w, 1).numpy()
    out["rs_counts"] = (dict(co.counts), dict(co.received))
    group, agrid, active, full = active_grid_comm(5, 5)
    out["active"] = (agrid, active, full,
                     None if group is None else dist.get_world_size(group))
    return out


def _mm_rank(d):
    import pylops_mpi_tpu_torch as pmtt
    from pylops_mpi_tpu_torch.parallel import collectives as co
    n = pmtt.parallel.world_size()
    D = pmtt.DistributedArray
    out = {}
    for label, key, M, ncol, kind, schedule, grid in CASES:
        Op = pmtt.MPIMatrixMult(d[key], M, kind=kind, schedule=schedule,
                                grid=_grid(grid, n), device="cpu")
        x = D.to_dist(d["x_" + label], device="cpu")
        co.reset_counts()
        y = Op.matvec(x)
        fwd = (dict(co.counts), dict(co.received))
        v = D.to_dist(d["y_" + label], device="cpu")
        co.reset_counts()
        xa = Op.rmatvec(v)
        adj = (dict(co.counts), dict(co.received))
        o = dict(y=y.asarray(), y_lsh=y.local_shapes, xa=xa.asarray(),
                 xa_lsh=xa.local_shapes, fwd=fwd, adj=adj,
                 A=Op.A.numpy(), schedule=getattr(Op, "schedule", None),
                 grid=getattr(Op, "grid", None),
                 dot=pmtt.dottest(Op, x, v, rtol=1e-12))
        if label in CGLS:
            x0 = D.to_dist(np.zeros(Op.shape[1], dtype=d[key].dtype),
                           device="cpu")
            o["cgls"] = pmtt.cgls(Op, y, x0=x0, niter=5,
                                  tol=0.0)[0].asarray()
        out[label] = o
    # a masked input keeps its mask; a BROADCAST input is cut locally
    mask = [q % 2 for q in range(n)]
    Op = pmtt.MPIMatrixMult(d["A"], 10, device="cpu")
    ym = Op.matvec(D.to_dist(d["x_f64_gather"], mask=mask, device="cpu"))
    co.reset_counts()
    yb = Op.matvec(D.to_dist(d["x_f64_gather"], device="cpu",
                             partition=pmtt.Partition.BROADCAST))
    out["mask"] = (ym.mask, ym.asarray())
    out["broadcast"] = (yb.asarray(), dict(co.counts).get("all_to_all", 0))
    out["collectives"] = _collectives_rank()
    out["grads"] = _grad_rank(d)
    return out


def _grad_rank(d):
    """GRADS' gradients of 0.5‖A x − y‖²: x's shard (autograd through
    ``matvec``) with the forward's and backward's collective calls, and
    A's rows or tile (``make_differentiable(..., params=True)``)."""
    import torch
    import pylops_mpi_tpu_torch as pmtt
    from pylops_mpi_tpu_torch.autodiff import make_differentiable
    from pylops_mpi_tpu_torch.linearoperator import operator_params
    from pylops_mpi_tpu_torch.parallel import collectives as co
    n = pmtt.parallel.world_size()
    D = pmtt.DistributedArray
    out = {}
    for label, key, M, ncol, kind, schedule, grid in CASES:
        if label not in GRADS:
            continue
        Op = pmtt.MPIMatrixMult(d[key], M, kind=kind, schedule=schedule,
                                grid=_grid(grid, n), device="cpu")
        y = D.to_dist(d["y_" + label], device="cpu")

        def loss(ax):
            r = ax - y
            return 0.5 * r.dot(r)
        x = D.to_dist(d["x_" + label], device="cpu")
        x.array.requires_grad_(True)
        co.reset_counts()
        (gx,) = torch.autograd.grad(loss(Op.matvec(x)), x.array)
        x.array.requires_grad_(False)
        calls = dict(co.counts)
        (A,) = operator_params(Op)
        A.requires_grad_(True)
        (gA,) = torch.autograd.grad(
            loss(make_differentiable(Op, params=True).matvec(x)), A)
        A.requires_grad_(False)
        out[label] = dict(gx=gx.numpy(), gA=gA.numpy(), calls=calls)
    return out


# ------------------------------------------------------------ reference

def _reference(n, d):
    import pylops_mpi_tpu as pmt
    mesh = jax_mesh(n)
    ref = {}
    for label, key, M, ncol, kind, schedule, grid in CASES:
        kw = dict(schedule=schedule) if kind == "summa" else {}
        if kind != "block":
            kw["grid"] = _grid(grid, n)
        Op = pmt.MPIMatrixMult(d[key], M, kind=kind, mesh=mesh, **kw)
        x = pmt.DistributedArray.to_dist(d["x_" + label], mesh=mesh)
        y = Op.matvec(x)
        xa = Op.rmatvec(pmt.DistributedArray.to_dist(d["y_" + label],
                                                     mesh=mesh))
        o = dict(y=y.asarray(), y_lsh=y.local_shapes, xa=xa.asarray(),
                 xa_lsh=xa.local_shapes,
                 schedule=getattr(Op, "schedule", None),
                 grid=getattr(Op, "grid", None))
        if label in CGLS:
            x0 = pmt.DistributedArray.to_dist(
                np.zeros(Op.shape[1], dtype=d[key].dtype), mesh=mesh)
            o["cgls"] = pmt.cgls(Op, y, x0=x0, niter=5, tol=0.0)[0].asarray()
        ref[label] = o
    ref["grads"] = _grad_reference(mesh, d)
    return ref


def _grad_reference(mesh, d):
    """``jax.grad`` of GRADS' losses with respect to x and to A, the A
    the JAX operator is built from (module docstring)."""
    import jax
    import jax.numpy as jnp
    import pylops_mpi_tpu as pmt
    J = pmt.DistributedArray
    ref = {}
    for label, key, M, ncol, kind, schedule, grid in CASES:
        if label not in GRADS:
            continue
        kw = dict(schedule=schedule) if kind == "summa" else {}
        x = J.to_dist(d["x_" + label], mesh=mesh)
        y = J.to_dist(d["y_" + label], mesh=mesh)

        def loss(A, a, kw=kw, kind=kind, M=M, x=x, y=y):
            Op = pmt.MPIMatrixMult(A, M, kind=kind, mesh=mesh, **kw)
            r = Op.matvec(J._wrap(a, x)) - y
            return 0.5 * r.dot(r)
        gA, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(
            jnp.asarray(d[key]), x._arr)
        ref[label] = dict(gx=J._wrap(gx, x).asarray(), gA=np.asarray(gA))
    return ref


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    d = _data()
    out = {}
    for n in WORLDS:
        out[n] = run_world(_mm_rank, n, tmp_path_factory.mktemp("w"), d,
                           during=lambda: _reference(n, d))
    return d, out


@pytest.fixture(scope="module")
def collective_worlds(worlds):
    return {n: [o["collectives"] for o in res]
            for n, (res, _) in worlds[1].items()}


def _each(worlds):
    d, out = worlds
    for n, (res, ref) in out.items():
        for r, o in enumerate(res):
            yield n, r, o, ref


# ---------------------------------------------------------------- cases

@pytest.mark.parametrize("label", [c[0] for c in CASES])
def test_matches_jax(worlds, label):
    """Values and output ``local_shapes`` (the default split) of both
    applies against the JAX package; the schedule and grid chosen."""
    for n, r, o, ref in _each(worlds):
        v, w = o[label], ref[label]
        close(v["y"], w["y"])
        close(v["xa"], w["xa"])
        assert v["y_lsh"] == w["y_lsh"] and v["xa_lsh"] == w["xa_lsh"]
        assert v["grid"] == w["grid"]
        if w["schedule"] is not None:  # the JAX auto kind has none
            assert v["schedule"] == w["schedule"]
        assert v["dot"]


def _rank_piece(A, kind, grid, n, r):
    """What rank ``r`` of ``n`` keeps of ``A``: a block rank its balanced
    split of the rows, a SUMMA rank its tile of ``A`` zero-padded to the
    ``grid`` (``local_block_split``)."""
    from pylops_mpi_tpu_torch.ops.matrixmult import local_block_split
    if kind == "block":
        return A[np.array_split(np.arange(A.shape[0]), n)[r]]
    pr, pc = grid
    Np = pr * -(-A.shape[0] // pr)
    Kp = pc * -(-A.shape[1] // pc)
    Ap = np.zeros((Np, Kp), dtype=A.dtype)
    Ap[:A.shape[0], :A.shape[1]] = A
    return Ap[local_block_split((Np, Kp), r, (pr, pc))]


def test_each_rank_keeps_its_tile(worlds):
    """A block rank keeps its balanced split of A's rows; a SUMMA rank
    its zero-padded tile (``local_block_split`` of the padded matrix)."""
    d = worlds[0]
    for n, r, o, ref in _each(worlds):
        for label, key, M, ncol, kind, schedule, grid in CASES:
            np.testing.assert_array_equal(
                o[label]["A"], _rank_piece(d[key], kind, o[label]["grid"],
                                           n, r))


@pytest.mark.parametrize("label", GRADS)
def test_gradients_match_jax(worlds, label):
    """x's gradient, each rank's shard of ``jax.grad``'s, through the
    moves' ``all_to_all`` rule (one adjoint call for each forward move);
    each rank's rows or tile of A's gradient."""
    _, out = worlds
    kind = dict((c[0], c[4]) for c in CASES)[label]
    for n, (res, ref) in out.items():
        want = ref["grads"][label]
        close(np.concatenate([o["grads"][label]["gx"] for o in res]),
              want["gx"], 1e-10)
        for r, o in enumerate(res):
            got = o["grads"][label]
            close(got["gA"], _rank_piece(want["gA"], kind, o[label]["grid"],
                                         n, r), 1e-10)
            calls = got["calls"]
            assert calls.get("all_to_all_adjoint", 0) == \
                calls.get("all_to_all", 0) == (0 if n == 1 else
                                               1 + (kind != "block"))


def test_collective_counts(worlds):
    """Collectives per apply: the flat↔tile (or rows) moves are one
    ``all_to_all`` each; the SUMMA kernels gather and reduce-scatter
    only along grid axes of more than one rank; a world of one moves
    nothing."""
    for n, r, o, ref in _each(worlds):
        for label, key, M, ncol, kind, schedule, grid in CASES:
            v = o[label]
            fwd, adj = v["fwd"][0], v["adj"][0]
            if n == 1:
                assert fwd == {} and adj == {}
                continue
            if kind == "block":
                assert fwd == {"all_gather": 1, "all_to_all": 1}
                assert adj == {"all_to_all": 1, "reduce_scatter": 1}
                continue
            pr, pc = v["grid"]
            sch = v["schedule"]
            want = {"all_to_all": 2,
                    "all_gather": (pr > 1) + (pc > 1),
                    "reduce_scatter": int(sch == "stat_a" and pc > 1)}
            assert fwd == {k: c for k, c in want.items() if c}, (label, fwd)
            want = {"all_to_all": 2, "all_gather": int(pc > 1),
                    "reduce_scatter": int(pr > 1)}
            assert adj == {k: c for k, c in want.items() if c}, (label, adj)


def test_summa_bytes_match_volume_model(worlds):
    """The bytes a rank receives in the SUMMA kernels' gathers and
    reduce-scatters per forward equal the JAX package's volume model
    for the schedule; the adjoint's Y gather equals its ``c`` part and
    the reduce-scatter over ``r`` receives (pr - 1) pieces of the
    split K block."""
    from pylops_mpi_tpu_torch.ops.matrixmult import summa_comm_volume_split
    d = worlds[0]
    for n, r, o, ref in _each(worlds):
        for label, key, M, ncol, kind, schedule, grid in CASES:
            if kind == "block" or ncol is not None or n == 1:
                continue
            v = o[label]
            item = d[key].itemsize
            N, K = d[key].shape
            pr, pc = v["grid"]
            vol = summa_comm_volume_split(N, K, M, (pr, pc))
            got = v["fwd"][1]
            kern = got.get("all_gather", 0) + got.get("reduce_scatter", 0)
            assert kern == sum(vol[v["schedule"]].values()) * item, label
            bk = -(-K // pc)
            piece = -(-bk // pr) * pc * -(-M // pc)
            got = v["adj"][1]
            assert got.get("all_gather", 0) == vol["adjoint"]["c"] * item
            assert got.get("reduce_scatter", 0) == (pr - 1) * piece * item
            # the two moves carry this rank's share of x and of y at most
            assert got["all_to_all"] <= (K * M + N * M) * item


def test_cgls(worlds):
    """Five CGLS iterations through the operator, block and SUMMA."""
    for n, r, o, ref in _each(worlds):
        for label in CGLS:
            close(o[label]["cgls"], ref[label]["cgls"], 1e-10)


def test_mask_and_broadcast_inputs(worlds):
    """The output carries the input's mask; a BROADCAST input is cut to
    the tile on each rank with no move."""
    d = worlds[0]
    for n, r, o, ref in _each(worlds):
        mask, y = o["mask"]
        assert mask == tuple(q % 2 for q in range(n))
        close(y, (d["A"] @ d["x_f64_gather"].reshape(17, 10)).ravel())
        yb, moves = o["broadcast"]
        close(yb, ref["f64_gather"]["y"])
        assert moves == (1 if n > 1 else 0)   # tile→flat only


def test_grid_2d(collective_worlds):
    """``make_grid_2d``: row-major coordinates; ``c`` sums over the
    rank's grid row, ``r`` over its grid column; a grid that does not
    tile the world is refused."""
    from pylops_mpi_tpu_torch.parallel.mesh import best_grid_2d
    for n, res in collective_worlds.items():
        for r, o in enumerate(res):
            for grid in (None, (n, 1), (1, n)):
                pr, pc = best_grid_2d(n) if grid is None else grid
                g = o[str(grid)]
                i, j = divmod(r, pc)
                assert g["shape"] == (pr, pc) and g["coords"] == (i, j)
                assert g["c_sum"] == sum(i * pc + q for q in range(pc))
                assert g["r_sum"] == sum(q * pc + j for q in range(pr))
                assert (g["c_size"], g["r_size"]) == (pc, pr)
            assert "does not tile" in o["bad_grid"]


def test_all_to_all_world_unchanged(collective_worlds):
    """On the world (``None`` or ``dist.group.WORLD``) pieces are listed
    by world rank, as before sub-groups were taken."""
    for n, res in collective_worlds.items():
        for r, o in enumerate(res):
            for name in ("world", "WORLD"):
                got = o["a2a_" + name]
                for p in range(n):
                    np.testing.assert_array_equal(
                        got[p], np.full((r + 1, p + 1), 10.0 * p + r))


def test_all_to_all_on_sub_groups(collective_worlds):
    """At four ranks, mask ``r // 2`` gives two groups of two: each rank
    exchanges with its own group only, pieces listed by group rank and
    sent to the members' global ranks (the world's indices would read
    the wrong piece, or past the list)."""
    for n, res in collective_worlds.items():
        for r, o in enumerate(res):
            a = o["a2a_group"]
            members = a["members"]
            me = members.index(r)
            assert members == [q for q in range(n) if q // 2 == r // 2]
            for p, g in zip(members, a["got"]):
                np.testing.assert_array_equal(
                    g, np.full((me + 1, p + 1), 10.0 * p + me))
            if n > 1:
                assert a["counts"] == {"all_to_all": 1}
                others = [p for p in members if p != r]
                assert a["received"] == {"all_to_all": sum(
                    (me + 1) * (p + 1) * 4 for p in others)}


def test_reduce_scatter(collective_worlds):
    """Ragged pieces, on the world along axis 1 and on sub-groups along
    axis 0: the sum over the group's ranks, this rank's piece."""
    for n, res in collective_worlds.items():
        for r, o in enumerate(res):
            members = o["a2a_group"]["members"]
            me = members.index(r)
            sizes = [q + 2 for q in range(len(members))]
            full = np.arange(float(sum(sizes) * 2)).reshape(-1, 2) * sum(
                p + 1 for p in members)
            lo = sum(sizes[:me])
            np.testing.assert_array_equal(o["rs_group"],
                                          full[lo:lo + sizes[me]])
            sizes = [q + 1 for q in range(n)]
            full = np.arange(float(3 * sum(sizes))).reshape(3, -1) \
                * n * (n + 1) / 2
            lo = sum(sizes[:r])
            np.testing.assert_array_equal(o["rs_world"],
                                          full[:, lo:lo + sizes[r]])
            calls, received = o["rs_counts"]
            if n > 1:
                assert calls == {"reduce_scatter": 1}
                assert received == {"reduce_scatter": 3 * n * 4 * (n - 1)}


def test_active_grid_comm(collective_worlds):
    """The largest square grid of active ranks: at 4 ranks all of them
    (no group made), at 2 and 3 rank 0 alone, the rest in the group of
    the other color (the reference's ``Split``)."""
    for n, res in collective_worlds.items():
        for r, o in enumerate(res):
            grid, active, full, gsize = o["active"]
            d = int(np.sqrt(n))
            assert grid == (d, d) and active == list(range(d * d))
            assert full == (d * d == n)
            if full:
                assert gsize is None
            else:
                assert gsize == (1 if r == 0 else n - 1)
