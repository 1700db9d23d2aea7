"""The two-level (hierarchical) collectives and their consumers, on a gloo
world of 4 ranks declared 2 hosts of 2 (``PYLOPS_MPI_TPU_TORCH_FABRIC=2x2``).

- **The primitives, against the JAX package's** on a ``(2, 2)`` JAX mesh
  of 4 of its CPU devices, axes ``("dcn", "sp")``: ``ring_pass(
  slice_size=2)`` against the JAX ``ring_pass(..., slice_size=2)`` on
  ``make_mesh(4)``, through a body that does not commute (so the visit
  order itself is compared); ``hier_all_gather`` and the pencil transpose
  and its inverse bitwise; ``hier_reduce_scatter`` (JAX
  ``hier_psum_scatter``) to rtol 1e-12. Ragged sizes, which the JAX
  primitives do not take, against the port's flat collectives, bitwise.
- **The consumers, against the JAX package on a flat 4-device mesh**
  (which pins its hybrid results to its flat ones) to rtol 1e-12 in f64,
  and against the port's own ``hierarchical="off"`` in the same world:
  bitwise where the JAX package pins bit-identity (SUMMA on ``(2, 2)``,
  SUMMA's adjoint placement on ``(1, 4)``, the FFT with and without
  chunks, ``MPIHalo``, the derivatives), rtol 1e-12 where the two-level
  schedule sums in another order (the stack's adjoint, SUMMA's gather
  ring on ``(1, 4)``); CGLS through the two-level stack (5 iterations)
  to 1e-10.
- **A gradient** through the two-level stack adjoint (``MPIHStack``'s
  forward) against ``jax.grad`` on the flat mesh.
- **The counters**: the neighbour exchange's ghost bytes split pair by
  pair, summed over the ranks, against the JAX package's per-device
  counters times 4 (within 4 bytes: its ceiling); the FFT's IB bytes
  against ``pencil_transpose_cost(..., hierarchical=True)`` (JAX
  ``test_pencil_dcn_reduction_model_vs_trace``) and below the flat
  all-to-all's; the same world made flat adds no per-fabric counter.
- **The knob and the tuner**: the knob against JAX
  ``hierarchical_enabled``, a malformed value; ``_expand_hier`` only on a
  hybrid key; a seeded hybrid plan flips ``hierarchical``, while an
  explicit keyword and a pinned environment still win.

One world is spawned for the module (``run_world`` of
``test_torch_process_group.py``); the JAX references run in this process
meanwhile, and the cases read both from a module fixture.
"""

import os
import warnings

import numpy as np
import pytest
import torch

from test_torch_process_group import close, run_world

N_RANKS = 4
P = "PYLOPS_MPI_TPU_TORCH_"
MM = (7, 9, 4)          # (N, K, M): padded tiles on (1, 4) and (2, 2)
FFT = (16, 8, 4)        # even splits: the model's bytes are exact
FFT_RAGGED = (13, 10, 3)
DIMS = (22, 5)          # derivative and halo rows (6, 6, 5, 5)
GHOST = (2, 1)          # front, back ghost rows of the bare exchange


def _data():
    rng = np.random.default_rng(18)
    return dict(
        ring=rng.standard_normal((N_RANKS, 3)),
        part=rng.standard_normal((N_RANKS, 16, 3)),
        gat=rng.standard_normal((N_RANKS, 4, 3)),
        tr=rng.standard_normal((N_RANKS, 3, 8)),
        A=rng.standard_normal(MM[:2]), xm=rng.standard_normal(MM[1] * MM[2]),
        ym=rng.standard_normal(MM[0] * MM[2]),
        blocks=[rng.standard_normal((5, 4)) for _ in range(8)],
        ys=rng.standard_normal(40), xs=rng.standard_normal(4),
        ws=rng.standard_normal(4),
        xf=(rng.standard_normal(int(np.prod(FFT)))
            + 1j * rng.standard_normal(int(np.prod(FFT)))),
        xr=(rng.standard_normal(int(np.prod(FFT_RAGGED)))
            + 1j * rng.standard_normal(int(np.prod(FFT_RAGGED)))),
        x=rng.standard_normal(int(np.prod(DIMS))),
        field=rng.standard_normal((12, 6)),
        gh=rng.standard_normal((N_RANKS, 5, 3)))


def _rows_layout(dims, n):
    inner = int(np.prod(dims[1:]))
    return [(len(r) * inner,) for r in np.array_split(np.arange(dims[0]), n)]


def _ragged(n_total, parts):
    return [len(c) for c in np.array_split(np.arange(n_total), parts)]


# --------------------------------------------------------------- ranks

def _hier_rank(d):
    import pylops_mpi_tpu_torch as pmtt
    from pylops_mpi_tpu_torch import DistributedArray as D
    from pylops_mpi_tpu_torch.aot.signature import schedule_signature
    from pylops_mpi_tpu_torch.diagnostics import metrics
    from pylops_mpi_tpu_torch.ops import local as tl
    from pylops_mpi_tpu_torch.ops.fft import _pencil_transpose
    from pylops_mpi_tpu_torch.ops.halo import halo_block_split
    from pylops_mpi_tpu_torch.parallel import collectives as co
    from pylops_mpi_tpu_torch.parallel import topology
    n, r = pmtt.parallel.world_size(), pmtt.parallel.rank()
    out = dict(world_shape=topology.world_shape(),
               groups=topology.hier_groups() is not None)

    def vec(a, **kw):
        return D.to_dist(a, device="cpu", **kw)

    def counted(fn):
        co.reset_counts()
        metrics.clear_metrics()
        res = fn()
        cnt = {k: v for k, v in metrics.snapshot()["counters"].items()
               if k.startswith("collective.")}
        return res, dict(co.counts), dict(co.steps), cnt

    # ring_pass in the host-blocked order, a body that does not commute
    owners = []

    def body(acc, res, owner, s):
        owners.append(owner)
        part = res * (owner + 1)
        return part if acc is None else acc * 0.5 + part
    y, calls, steps, cnt = counted(lambda: co.ring_pass(
        torch.from_numpy(d["ring"][r]), body, slice_size=2))
    out["ring"] = dict(y=y.numpy(), owners=owners, calls=calls, steps=steps,
                       cnt=cnt)
    # the two-level reduce-scatter and gather, equal and ragged
    part = torch.from_numpy(d["part"][r])
    red, calls, _, cnt = counted(lambda: co.hier_reduce_scatter(part,
                                                                [4] * n))
    out["rs"] = dict(y=red.numpy(), calls=calls, cnt=cnt)
    rag = _ragged(16, n)
    out["rs_ragged"] = (co.hier_reduce_scatter(part, rag).numpy(),
                        co.reduce_scatter(part, rag).numpy())
    g = torch.from_numpy(d["gat"][r])
    ag, calls, _, cnt = counted(lambda: co.hier_all_gather(g, [4] * n))
    out["ag"] = dict(y=ag.numpy(), calls=calls, cnt=cnt)
    gr = g[:[1, 4, 2, 3][r]]
    out["ag_ragged"] = (co.hier_all_gather(gr, [1, 4, 2, 3]).numpy(),
                        co.all_gather(gr, [1, 4, 2, 3]).numpy())
    # the pencil transpose and its inverse, equal and ragged
    b = torch.from_numpy(d["tr"][r])
    t, calls, _, cnt = counted(lambda: co.hier_pencil_transpose(
        b, 1, 0, [2] * n, [3] * n))
    back = co.hier_pencil_transpose(t, 0, 1, [3] * n, [2] * n, forward=False)
    out["tr"] = dict(y=t.numpy(), back=back.numpy(), calls=calls, cnt=cnt)
    send, recv = [1, 3, 2, 2], [2, 1, 3, 1]
    br = torch.from_numpy(d["tr"][r][:recv[r]])
    hr = co.hier_pencil_transpose(br, 1, 0, send, recv)
    out["tr_ragged"] = (hr.numpy(), _pencil_transpose(br, 1, 0, send,
                                                      recv).numpy(),
                        co.hier_pencil_transpose(hr, 0, 1, recv, send,
                                                 forward=False).numpy(),
                        br.numpy())

    # the consumers, on against off
    cons = {}
    blocks = [tl.MatrixMult(torch.from_numpy(m)) for m in d["blocks"]]
    for mode in ("on", "off"):
        V = pmtt.MPIVStack(blocks, overlap="on", hierarchical=mode)
        yv = vec(d["ys"], local_shapes=V.local_shapes_n)
        xa, calls, steps, cnt = counted(lambda: V.rmatvec(yv).asarray())
        x0 = vec(np.zeros(4), partition=pmtt.Partition.BROADCAST)
        cons[("stack", mode)] = dict(
            hier=V._hier, sig=schedule_signature(V), y=xa, calls=calls,
            steps=steps, cnt=cnt,
            cgls=pmtt.cgls(V, yv, x0=x0, niter=5, tol=0.0)[0].asarray())
    N, K, M = MM
    for grid in ((1, n), (2, 2)):
        for mode in ("on", "off"):
            op = pmtt.MPIMatrixMult(d["A"], M, kind="summa", grid=grid,
                                    schedule="gather", overlap="on",
                                    hierarchical=mode, device="cpu")
            fy, calls, steps, cnt = counted(
                lambda: op.matvec(vec(d["xm"])).asarray())
            ay, acalls, asteps, acnt = counted(
                lambda: op.rmatvec(vec(d["ym"])).asarray())
            cons[("summa", grid, mode)] = dict(
                hier=op._hier, ring_slice=op._ring_slice,
                sig=schedule_signature(op), y=fy, calls=calls,
                steps=steps, cnt=cnt, adj=ay, acalls=acalls, asteps=asteps,
                acnt=acnt)
    for chunks in (None, 2):
        for mode in ("on", "off"):
            F = pmtt.MPIFFTND(FFT, axes=(0, 1),
                              overlap="on" if chunks else "off",
                              comm_chunks=chunks, hierarchical=mode)
            xf = vec(d["xf"], local_shapes=F.model_local_shapes)
            yf, calls, steps, cnt = counted(lambda: F.matvec(xf))
            cons[("fft", chunks, mode)] = dict(
                hier=F._hier, sig=schedule_signature(F), y=yf.asarray(),
                xa=F.rmatvec(yf).asarray(),
                calls=calls, steps=steps, cnt=cnt)
            Fr = pmtt.MPIFFTND(FFT_RAGGED, axes=(0, 1, 2),
                               overlap="on" if chunks else "off",
                               comm_chunks=chunks, hierarchical=mode)
            xr = vec(d["xr"], local_shapes=Fr.model_local_shapes)
            yr = Fr.matvec(xr)
            cons[("fft_ragged", chunks, mode)] = dict(
                y=yr.asarray(), xa=Fr.rmatvec(yr).asarray())
    grid = (n, 1)
    f = d["field"]
    for mode in ("on", "off"):
        H = pmtt.MPIHalo(f.shape, (1, 2), grid, hierarchical=mode)
        xh = vec(np.concatenate([f[halo_block_split(f.shape, q, grid)]
                                 .ravel() for q in range(n)]),
                 local_shapes=H.local_dim_sizes)
        yh, calls, _, cnt = counted(lambda: H.matvec(xh))
        cons[("halo", mode)] = dict(hier=H._hier, sig=schedule_signature(H),
                                    y=yh.asarray(),
                                    xa=H.rmatvec(yh).asarray(), cnt=cnt)
        for name, op in (
                ("d1", pmtt.MPIFirstDerivative(DIMS, kind="centered",
                                               order=5, edge=True,
                                               hierarchical=mode)),
                ("d2", pmtt.MPISecondDerivative(DIMS, edge=True,
                                                hierarchical=mode))):
            xd = vec(d["x"], local_shapes=op.local_shapes_m)
            yd, calls, _, cnt = counted(lambda: op.matvec(xd))
            cons[(name, mode)] = dict(hier=op._hier,
                                      sig=schedule_signature(op),
                                      y=yd.asarray(),
                                      xa=op.rmatvec(xd).asarray(), cnt=cnt)
    out["cons"] = cons

    # a gradient through the two-level stack adjoint (MPIHStack forward)
    Hs = pmtt.MPIHStack([tl.MatrixMult(torch.from_numpy(m.T.copy()))
                         for m in d["blocks"]], overlap="on",
                        hierarchical="on")
    xs = vec(d["ys"], local_shapes=Hs.local_shapes_m)
    xs.array.requires_grad_(True)
    co.reset_counts()
    y = Hs.matvec(xs)
    # BROADCAST output: rank 0's copy carries the loss
    w = torch.from_numpy(d["ws"])
    loss = co.all_reduce(((w * y.array).sum() * (r == 0)).reshape(1))
    (grad,) = torch.autograd.grad(loss.sum(), xs.array)
    out["grad"] = dict(g=grad.numpy(), calls=dict(co.counts))

    # the ghost split of the bare exchange
    blk = torch.from_numpy(d["gh"][r])
    _, calls, _, cnt = counted(lambda: co.halo_exchange(blk, *GHOST))
    out["ghost"] = dict(calls=calls, cnt=cnt,
                        received=sum(v for k, v in cnt.items()
                                     if k.endswith(".bytes")))

    # the tuner's seam on this world
    from pylops_mpi_tpu_torch.tuning import cache as tcache
    from pylops_mpi_tpu_torch.tuning import plan as tplan
    from pylops_mpi_tpu_torch.utils.deps import batch_default
    os.environ[P + "TUNE"] = "on"
    tcache.clear_memory()
    try:
        seed = pmtt.MPIMatrixMult(d["A"], M, kind="summa", grid=(1, n),
                                  device="cpu")
        p = tplan.get_plan("matrixmult", shape=(N, K, M),
                           dtype=torch.float64, n_dev=n, device="cpu",
                           extra={"grid": (1, n), "batch": batch_default()})
        tcache.store(p.key, {"params": {"schedule": "gather",
                                        "overlap": "off",
                                        "hierarchical": "off"},
                             "provenance": "tuned"})
        banked = pmtt.MPIMatrixMult(d["A"], M, kind="summa", grid=(1, n),
                                    device="cpu")
        kw = pmtt.MPIMatrixMult(d["A"], M, kind="summa", grid=(1, n),
                                hierarchical="on", device="cpu")
        os.environ[P + "HIERARCHICAL"] = "on"
        pinned = pmtt.MPIMatrixMult(d["A"], M, kind="summa", grid=(1, n),
                                    device="cpu")
        out["tuner"] = dict(key=p.key, seed_params=p.params,
                            seed=seed._hier, banked=banked._hier,
                            keyword=kw._hier, pinned=pinned._hier)
    finally:
        os.environ.pop(P + "TUNE", None)
        os.environ.pop(P + "HIERARCHICAL", None)
        tcache.clear_memory()

    # the same world made flat: no two-level schedule, no fabric counter
    os.environ[P + "FABRIC"] = ""
    pmtt.parallel.make_mesh_hybrid()
    V = pmtt.MPIVStack(blocks, overlap="on", hierarchical="on")
    yv = vec(d["ys"], local_shapes=V.local_shapes_n)
    xa, calls, _, cnt = counted(lambda: V.rmatvec(yv).asarray())
    _, _, _, gcnt = counted(lambda: co.halo_exchange(blk, *GHOST))
    out["flat"] = dict(hier=V._hier, world_shape=topology.world_shape(),
                       y=xa, calls=calls,
                       keys=sorted(k for k in {**cnt, **gcnt}
                                   if "bytes_" in k))
    return out


# ------------------------------------------------------------ reference

def _jitted(fn, x):
    """``fn(x)`` of the JAX package as one jitted program, the global
    array."""
    import jax
    import pylops_mpi_tpu as pmt
    J = pmt.DistributedArray
    return np.asarray(jax.jit(lambda a: fn(J._wrap(a, x))._global())(x._arr))


def _jax_primitives(d):
    """The JAX two-level primitives on a (2, 2) mesh, and its ring on
    ``make_mesh(4)``, each device's result in rank order."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as PSpec
    from pylops_mpi_tpu.jaxcompat import shard_map
    from pylops_mpi_tpu.parallel import collectives as C
    from pylops_mpi_tpu.parallel.mesh import make_mesh
    mesh = make_mesh(N_RANKS)
    name = mesh.axis_names[0]

    def ring(xb):
        def body(acc, res, owner, s):
            part = res * (owner + 1)
            return part if acc is None else acc * 0.5 + part
        return C.ring_pass(xb, name, N_RANKS, body, slice_size=2)

    def smap(fn, m, spec_in, spec_out, *args):
        return np.asarray(jax.jit(shard_map(
            fn, mesh=m, in_specs=spec_in, out_specs=spec_out,
            check_vma=False))(*args))

    out = {"ring": smap(ring, mesh, PSpec(name), PSpec(name),
                        jnp.asarray(d["ring"]))}
    hyb = Mesh(np.asarray(jax.devices()[:N_RANKS]).reshape(2, 2),
               ("dcn", "sp"))
    ax = ("dcn", "sp")
    out["rs"] = smap(lambda x: C.hier_psum_scatter(x[0], "dcn", "sp", 2, 2)
                     [None], hyb, PSpec(ax), PSpec(ax),
                     jnp.asarray(d["part"]))
    out["ag"] = smap(lambda x: C.hier_all_gather(x[0], "dcn", "sp", 2, 2)
                     [None], hyb, PSpec(ax), PSpec(ax),
                     jnp.asarray(d["gat"]))
    tr = smap(lambda x: C.hier_pencil_transpose(x[0], "dcn", "sp", 2, 2, 1)
              [None], hyb, PSpec(ax), PSpec(ax), jnp.asarray(d["tr"]))
    out["tr"] = tr
    out["tr_back"] = smap(lambda x: C.hier_pencil_transpose(
        x[0], "dcn", "sp", 2, 2, 1, forward=False)[None], hyb, PSpec(ax),
        PSpec(ax), jnp.asarray(tr))
    return out


def _jax_consumers(d):
    """The JAX package on a flat 4-device mesh: overlap on where the
    port's two-level schedule replaces a pipelined one."""
    import jax
    import jax.numpy as jnp
    import pylops_mpi_tpu as pmt
    from pylops_mpi_tpu.ops import local as jl
    from pylops_mpi_tpu.ops.halo import halo_block_split
    from test_torch_process_group import jax_mesh
    J = pmt.DistributedArray
    mesh = jax_mesh(N_RANKS)
    n = N_RANKS

    def vec(a, **kw):
        return J.to_dist(a, mesh=mesh, **kw)

    ref = {}
    V = pmt.MPIVStack([jl.MatrixMult(m) for m in d["blocks"]], mesh=mesh,
                      overlap="on")
    yv = vec(d["ys"], local_shapes=V.local_shapes_n)
    ref["stack"] = _jitted(V.rmatvec, yv)
    ref["cgls"] = np.asarray(pmt.cgls(V, yv, x0=vec(
        np.zeros(4), partition=pmt.Partition.BROADCAST), niter=5,
        tol=0.0)[0].asarray())
    N, K, M = MM
    for grid in ((1, n), (2, 2)):
        op = pmt.MPIMatrixMult(d["A"], M, mesh=mesh, kind="summa", grid=grid,
                               schedule="gather", overlap="on")
        ref[("summa", grid)] = (_jitted(op.matvec, vec(d["xm"])),
                                _jitted(op.rmatvec, vec(d["ym"])))
    for chunks in (None, 2):
        F = pmt.MPIFFTND(FFT, axes=(0, 1), mesh=mesh,
                         overlap="on" if chunks else "off",
                         comm_chunks=chunks)
        xf = vec(d["xf"], local_shapes=F.model_local_shapes)
        ref[("fft", chunks)] = (_jitted(F.matvec, xf),
                                _jitted(F.rmatvec, F.matvec(xf)))
    grid = (n, 1)
    f = d["field"]
    H = pmt.MPIHalo(f.shape, (1, 2), grid, mesh=mesh)
    xh = vec(np.concatenate([f[halo_block_split(f.shape, q, grid)].ravel()
                             for q in range(n)]),
             local_shapes=H.local_dim_sizes)
    ref["halo"] = (_jitted(H.matvec, xh), _jitted(H.rmatvec, H.matvec(xh)))
    xd = vec(d["x"], local_shapes=_rows_layout(DIMS, n))
    for name, op in (("d1", pmt.MPIFirstDerivative(
            DIMS, kind="centered", order=5, edge=True, mesh=mesh)),
            ("d2", pmt.MPISecondDerivative(DIMS, edge=True, mesh=mesh))):
        ref[name] = (_jitted(op.matvec, xd), _jitted(op.rmatvec, xd))
    # jax.grad of w·(HStack x) on the flat mesh, overlap on
    Hs = pmt.MPIHStack([jl.MatrixMult(m.T.copy()) for m in d["blocks"]],
                       mesh=mesh, overlap="on")
    xs = vec(d["ys"])
    wj = jnp.asarray(d["ws"])

    def loss(a):
        return jnp.sum(wj * Hs.matvec(J._wrap(a, xs))._global())
    ref["grad"] = np.asarray(jax.jit(jax.grad(loss))(xs._arr))
    return ref


def _reference(d):
    return dict(prim=_jax_primitives(d), cons=_jax_consumers(d))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The world's rank results and the JAX references computed
    meanwhile. The world is declared 2 hosts of 2 before its ranks
    start, so ``init`` lays it out and makes the two-level groups."""
    d = _data()
    env = {P + "FABRIC": "2x2", P + "METRICS": "on"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        res, ref = run_world(_hier_rank, N_RANKS,
                             tmp_path_factory.mktemp("hier4"), d,
                             during=lambda: _reference(d))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return d, res, ref


def _shard(full, sizes, r):
    off = int(np.sum(sizes[:r]))
    return full[off:off + sizes[r]]


def _bytes(cnt, name, fab=None):
    return cnt.get(f"collective.{name}.bytes" + (f"_{fab}" if fab else ""),
                   0)


# ------------------------------------------------------------ primitives

def test_world_is_laid_out_two_by_two(world):
    for o in world[1]:
        assert o["world_shape"] == (2, 2) and o["groups"]


def test_ring_pass_host_blocked_matches_jax(world):
    d, res, ref = world
    for r, o in enumerate(res):
        rg = o["ring"]
        close(rg["y"], ref["prim"]["ring"][r])
        # the host-blocked visit order: owner ((d+k)%D)·L + (l+t-k)%L
        dd, ll = divmod(r, 2)
        assert rg["owners"] == [((dd + t // 2) % 2) * 2 + (ll + t - t // 2)
                                % 2 for t in range(N_RANKS)]
        assert sorted(rg["owners"]) == list(range(N_RANKS))
        assert rg["calls"] == {"ring_pass": 1}
        assert rg["steps"] == {"ring_pass": N_RANKS - 1}
        blk = d["ring"][r].nbytes
        # JAX :470-478: blk·D·(L-1) on NVLink, blk·(D-1) on IB
        assert _bytes(rg["cnt"], "ring_pass", "nvlink") == blk * 2 * 1
        assert _bytes(rg["cnt"], "ring_pass", "ib") == blk * 1
        assert _bytes(rg["cnt"], "ring_pass") == blk * (N_RANKS - 1)


def test_hier_reduce_scatter_matches_jax(world):
    d, res, ref = world
    for r, o in enumerate(res):
        close(o["rs"]["y"], ref["prim"]["rs"][r])
        assert o["rs"]["calls"] == {"hier_psum_scatter": 1}
        # JAX :900-906: L·(I-1)/I on NVLink, L·(D-1)/(D·I) on IB
        L = d["part"][r].nbytes
        assert _bytes(o["rs"]["cnt"], "hier_psum_scatter", "nvlink") == L // 2
        assert _bytes(o["rs"]["cnt"], "hier_psum_scatter", "ib") == L // 4
        got, flat = o["rs_ragged"]
        close(got, flat)


def test_hier_all_gather_bitwise_jax(world):
    d, res, ref = world
    for r, o in enumerate(res):
        assert np.array_equal(o["ag"]["y"],
                              ref["prim"]["ag"][r])
        assert o["ag"]["calls"] == {"hier_all_gather": 1}
        # JAX :931-937: L·(I-1) on NVLink, L·I·(D-1) on IB
        L = d["gat"][r].nbytes
        assert _bytes(o["ag"]["cnt"], "hier_all_gather", "nvlink") == L
        assert _bytes(o["ag"]["cnt"], "hier_all_gather", "ib") == 2 * L
        got, flat = o["ag_ragged"]
        assert np.array_equal(got, flat)


def test_hier_transposes_bitwise_jax(world):
    d, res, ref = world
    for r, o in enumerate(res):
        assert np.array_equal(o["tr"]["y"], ref["prim"]["tr"][r])
        assert np.array_equal(o["tr"]["back"],
                              ref["prim"]["tr_back"][r])
        assert np.array_equal(o["tr"]["back"], d["tr"][r])
        assert o["tr"]["calls"] == {"hier_pencil_transpose": 1}
        # JAX :765-770: L·(I-1)/I on NVLink, L·(D-1)/D on IB
        L = d["tr"][r].nbytes
        assert _bytes(o["tr"]["cnt"], "hier_pencil_transpose", "nvlink") \
            == L // 2
        assert _bytes(o["tr"]["cnt"], "hier_pencil_transpose", "ib") == L // 2
        hier, flat, back, orig = o["tr_ragged"]
        assert np.array_equal(hier, flat) and np.array_equal(back, orig)


# ------------------------------------------------------------ consumers

def test_stack_adjoint_two_level(world):
    d, res, ref = world
    for o in res:
        on, off = o["cons"][("stack", "on")], o["cons"][("stack", "off")]
        assert on["hier"] and not off["hier"]
        assert on["calls"] == {"hier_psum_scatter": 1, "hier_all_gather": 1}
        assert off["calls"] == {"ring_reduce_scatter": 1, "all_gather": 1}
        close(on["y"], ref["cons"]["stack"])
        close(on["y"], off["y"])
        close(on["cgls"], ref["cons"]["cgls"], rtol=1e-10)


@pytest.mark.parametrize("grid", [(1, 4), (2, 2)])
def test_summa_two_level(world, grid):
    d, res, ref = world
    fwd, adj = ref["cons"][("summa", grid)]
    for o in res:
        on = o["cons"][("summa", grid, "on")]
        off = o["cons"][("summa", grid, "off")]
        assert on["hier"] and not off["hier"]
        close(on["y"], fwd)
        close(on["adj"], adj)
        # the adjoint places each tile at its owner's columns: exact
        assert np.array_equal(on["adj"], off["adj"])
        if grid == (1, 4):
            assert on["ring_slice"] == 2 and off["ring_slice"] is None
            assert on["steps"] == {"ring_pass": 3}
            assert _bytes(on["cnt"], "ring_pass", "ib") \
                < _bytes(off["cnt"], "ring_pass", "ib")
            assert _bytes(on["acnt"], "ring_pass", "ib") \
                < _bytes(off["acnt"], "ring_pass", "ib")
        else:
            # the ring axis stays on one host: the schedule is the flat one
            assert on["ring_slice"] is None
            assert np.array_equal(on["y"], off["y"])


@pytest.mark.parametrize("chunks", [None, 2])
def test_fft_two_level(world, chunks):
    d, res, ref = world
    fwd, adj = ref["cons"][("fft", chunks)]
    name = ("hier_chunked_pencil_transpose" if chunks
            else "hier_pencil_transpose")
    for o in res:
        on = o["cons"][("fft", chunks, "on")]
        off = o["cons"][("fft", chunks, "off")]
        assert on["hier"] and not off["hier"]
        assert set(on["calls"]) == {name}
        assert np.array_equal(on["y"], off["y"])
        assert np.array_equal(on["xa"], off["xa"])
        close(on["y"], fwd)
        close(on["xa"], adj)
        if chunks:
            assert on["steps"] == {name: chunks}
        rg_on = o["cons"][("fft_ragged", chunks, "on")]
        rg_off = o["cons"][("fft_ragged", chunks, "off")]
        assert np.array_equal(rg_on["y"], rg_off["y"])
        assert np.array_equal(rg_on["xa"], rg_off["xa"])


@pytest.mark.parametrize("name", ["halo", "d1", "d2"])
def test_halo_and_derivatives_unchanged(world, name):
    d, res, ref = world
    fwd, adj = ref["cons"][name]
    for o in res:
        on, off = o["cons"][(name, "on")], o["cons"][(name, "off")]
        assert on["hier"] and not off["hier"]
        assert np.array_equal(on["y"], off["y"])
        assert np.array_equal(on["xa"], off["xa"])
        close(on["y"], fwd)
        close(on["xa"], adj)
        # the bytes split whatever the setting
        assert on["cnt"] == off["cnt"]


def test_schedule_signature_marks_two_level_schedules(world):
    """The graph bank's key gains ``("hier", ring_slice)`` where a
    two-level schedule runs, and only there."""
    runs = {("stack", "on"): True, ("summa", (1, 4), "on"): True,
            ("summa", (2, 2), "on"): False, ("fft", None, "on"): True,
            ("fft", 2, "on"): True, ("halo", "on"): False,
            ("d1", "on"): False, ("d2", "on"): False}
    for o in world[1]:
        for key, two in runs.items():
            on = o["cons"][key]["sig"]
            off = o["cons"][key[:-1] + ("off",)]["sig"]
            assert not any(len(e) > 3 for e in off), key
            if not two:
                assert on == off, key
                continue
            assert tuple(e[:3] for e in on) == off, key
            marks = {e[3:] for e in on if len(e) > 3}
            assert marks == {("hier", 2 if key[0] == "summa" else None)}, \
                key


def test_stack_gradient_matches_jax_grad(world):
    d, res, ref = world
    sizes = [5 * 2] * N_RANKS  # two blocks of 5 rows a rank
    for r, o in enumerate(res):
        close(o["grad"]["g"], _shard(ref["cons"]["grad"], sizes, r))
        calls = o["grad"]["calls"]
        # forward: the two-level pair; backward: each one's adjoint
        assert calls["hier_psum_scatter"] == 2
        assert calls["hier_all_gather"] == 2


# ------------------------------------------------------------ counters

def test_ghost_bytes_split_by_fabric(world, monkeypatch):
    """Each rank charges each ghost to the fabric of its sender; summed
    over the ranks, the JAX package's per-device counters times 4."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as PSpec
    from pylops_mpi_tpu.diagnostics import metrics as jm
    from pylops_mpi_tpu.jaxcompat import shard_map
    from pylops_mpi_tpu.parallel import collectives as C
    from pylops_mpi_tpu.parallel.mesh import make_mesh
    d, res, _ = world
    row = d["gh"][0][0].nbytes
    front, back = GHOST
    for r, o in enumerate(res):
        c = o["ghost"]["cnt"]
        nv = _bytes(c, "halo_exchange", "nvlink")
        ib = _bytes(c, "halo_exchange", "ib")
        # ranks 0 and 3 have one neighbour, on their host; 1 and 2 one
        # on their host and one across
        want_nv = {0: back, 1: front, 2: back, 3: front}[r] * row
        want_ib = {0: 0, 1: back, 2: front, 3: 0}[r] * row
        assert (nv, ib) == (want_nv, want_ib)
        assert nv + ib == _bytes(c, "halo_exchange")
        if r in (0, 3):
            assert "collective.halo_exchange.bytes_ib" not in c
    monkeypatch.setenv("PYLOPS_MPI_TPU_METRICS", "on")
    jm.clear_metrics()
    mesh = make_mesh(N_RANKS)
    name = mesh.axis_names[0]

    def kernel(b):
        return C.cart_halo_extend(b, name, (N_RANKS,), 0, front, back,
                                  b.shape[0], slice_map=(0, 0, 1, 1))
    jax.jit(shard_map(kernel, mesh=mesh, in_specs=PSpec(name),
                      out_specs=PSpec(name), check_vma=False))(
        jnp.asarray(d["gh"].reshape(-1, 3)))
    jc = jm.snapshot()["counters"]
    jm.clear_metrics()
    for fab, jfab in (("nvlink", "ici"), ("ib", "dcn")):
        total = sum(_bytes(o["ghost"]["cnt"], "halo_exchange", fab)
                    for o in res)
        want = N_RANKS * jc[f"collective.cart_halo_extend.bytes_{jfab}"]
        assert want - N_RANKS < total <= want
    # the derivatives' exchange splits the same way (equal widths)
    for r, o in enumerate(res):
        c = o["cons"][("d1", "on")]["cnt"]
        nv = _bytes(c, "halo_exchange", "nvlink")
        ib = _bytes(c, "halo_exchange", "ib")
        if r in (0, 3):
            assert nv > 0 and ib == 0
        else:
            assert nv == ib > 0


def test_fft_ib_bytes_model_vs_trace(world):
    """JAX ``test_pencil_dcn_reduction_model_vs_trace``: the two-level
    transposes' IB bytes are the model's, and below the flat all-to-all's
    on the same world."""
    from pylops_mpi_tpu_torch.diagnostics import costmodel
    _, res, _ = world
    hier = costmodel.pencil_transpose_cost(
        FFT, N_RANKS, itemsize=16, n_transposes=1, fabric_shape=(2, 2),
        hierarchical=True)
    flat = costmodel.pencil_transpose_cost(
        FFT, N_RANKS, itemsize=16, n_transposes=1, fabric_shape=(2, 2),
        hierarchical=False)
    for o in res:
        on = o["cons"][(("fft", None, "on"))]["cnt"]
        off = o["cons"][(("fft", None, "off"))]["cnt"]
        # two transposes a forward apply
        assert _bytes(on, "hier_pencil_transpose", "ib") \
            == 2 * hier.dcn_bytes
        assert _bytes(on, "hier_pencil_transpose", "nvlink") \
            == 2 * hier.ici_bytes
        assert _bytes(on, "hier_pencil_transpose", "ib") \
            < _bytes(off, "all_to_all", "ib")
        assert flat.dcn_bytes > hier.dcn_bytes


def test_flat_world_adds_no_fabric_counter(world):
    d, res, ref = world
    for o in res:
        fl = o["flat"]
        assert fl["world_shape"] is None and not fl["hier"]
        assert fl["calls"] == {"ring_reduce_scatter": 1, "all_gather": 1}
        assert fl["keys"] == []
        close(fl["y"], ref["cons"]["stack"])


# ------------------------------------------------------ knob and tuner

def test_knob_resolution_matches_jax(monkeypatch):
    import pylops_mpi_tpu.utils.deps as jd
    import pylops_mpi_tpu_torch.utils.deps as td
    from pylops_mpi_tpu_torch.parallel import topology
    for fab in (None, "2x2"):
        for name in ("PYLOPS_MPI_TPU_FABRIC", P + "FABRIC"):
            if fab is None:
                monkeypatch.delenv(name, raising=False)
            else:
                monkeypatch.setenv(name, fab)
        # the port's auto reads the world's layout, where the JAX package
        # reads its fabric variable: the layout the declared fabric gives
        # a world of 4
        shape = None if fab is None else (2, 2)
        monkeypatch.setattr(topology, "world_shape", lambda s=shape: s)
        for raw in (None, "auto", "on", "off", " ON ", ""):
            for name in ("PYLOPS_MPI_TPU_HIERARCHICAL", P + "HIERARCHICAL"):
                if raw is None:
                    monkeypatch.delenv(name, raising=False)
                else:
                    monkeypatch.setenv(name, raw)
            assert td.hierarchical_mode() == jd.hierarchical_mode()
            assert td.hierarchical_env_pinned() == \
                jd.hierarchical_env_pinned()
            assert td.hierarchical_enabled() == jd.hierarchical_enabled(), \
                (fab, raw)
            # active: enabled on a world laid out hosts x ranks
            assert td.hierarchical_active() == (
                td.hierarchical_enabled() and fab is not None)
        for user in (True, False, "on", "off", "auto", " Off "):
            assert td.hierarchical_enabled(user) == \
                jd.hierarchical_enabled(user), (fab, user)
    for fn in (td.hierarchical_enabled, td.hierarchical_active):
        with pytest.raises(ValueError, match="hierarchical"):
            fn("sideways")
    monkeypatch.setattr(td, "_warned_hier", False)
    monkeypatch.setenv(P + "HIERARCHICAL", "typo")
    with pytest.warns(UserWarning, match="typo"):
        assert td.hierarchical_mode() == "auto"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert td.hierarchical_mode() == "auto"  # warned once only


def test_expand_hier_only_on_a_hybrid_key(monkeypatch):
    from pylops_mpi_tpu.tuning import space as jspace
    from pylops_mpi_tpu_torch.tuning import space as tspace
    monkeypatch.setenv(P + "FABRIC", "2x2")
    for op in ("matrixmult", "fft"):
        sp, jsp = tspace.space_for(op), jspace.space_for(op)
        extra = {"grid": (1, 4)} if op == "matrixmult" else {}
        flat = dict(op=op, shape=(64, 32, 16), n_dev=4, platform="cpu",
                    extra=extra)
        hyb = dict(flat, extra=dict(extra, topology="ib2xnvlink2"))
        jhyb = dict(flat, extra=dict(extra, topology="dcn2xici2"))
        assert tspace.candidates(sp, flat) == jspace.candidates(jsp, flat)
        assert not any("hierarchical" in p
                       for p in tspace.candidates(sp, flat))
        got = tspace.candidates(sp, hyb)
        assert got == jspace.candidates(jsp, jhyb)
        assert len(got) == 2 * len(tspace.candidates(sp, flat))
        # auto resolves on here: the seed ranks it first
        assert tspace.rank(sp, hyb)[0]["hierarchical"] == "on"
        assert tspace.default_params(sp, hyb)["hierarchical"] == "on"
        assert "hierarchical" not in tspace.default_params(sp, flat)


def test_seeded_hybrid_plan_flips_hierarchical(world):
    for o in world[1]:
        t = o["tuner"]
        assert t["key"].endswith("|tib2xnvlink2")
        assert t["seed_params"]["hierarchical"] == "on" and t["seed"]
        # the banked plan fills the sentinel: off, though auto is on
        assert t["banked"] is False
        # an explicit keyword and a pinned environment beat the plan
        assert t["keyword"] is True and t["pinned"] is True

