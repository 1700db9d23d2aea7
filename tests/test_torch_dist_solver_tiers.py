"""The port's solver tiers across ranks, held against the JAX package on
a mesh of the same size: block CGLS on ragged blocks, PCGLS with Jacobi
and with block-Jacobi, PCG with block-Jacobi blocks that straddle the
shards (and the three schedules of a block-Jacobi apply), pipelined
CGLS (``normal=True`` and on ragged f64 blocks), s-step CG, and the
sparse product's applies and CGLS, and the serving pool's packed solve
(and the daemon over the group). Each world also counts its
``all_reduce`` calls: one an iteration for the pipelined engines, one
an outer step for s-step, one a stacked block reduction.

One gloo world of 2 and one of 4 ranks are spawned for the whole module
and run every case; the JAX references run in this process meanwhile.
Tolerance: rtol 1e-9 (relative to the largest entry) in f64 over 10
iterations.
"""

import os

import numpy as np
import pytest

from test_torch_process_group import close, jax_mesh, run_world

NITER = 10
SIZES = [2, 4]
RTOL = 1e-9


def _odd_split(n):
    """An uneven split of 48 rows that no block boundary follows."""
    return {2: [(5,), (43,)], 4: [(5,), (20,), (3,), (20,)]}[n]


def make_data():
    rng = np.random.default_rng(3)
    rect = [rng.standard_normal((10, 8)) / 3 + 2 * np.eye(10, 8)
            for _ in range(8)]
    ragged = [rng.standard_normal((10, 8)) / 3 + 2 * np.eye(10, 8)
              for _ in range(10)]
    spd = []
    for _ in range(8):
        a = rng.standard_normal((6, 6))
        spd.append(a @ a.T * 0.2 + 3 * np.eye(6))
    A = rng.standard_normal((37, 29)) * (rng.random((37, 29)) < 0.2)
    A[np.arange(29), np.arange(29)] += 2.0
    damp = 0.2
    gram = np.stack([b.T @ b + damp ** 2 * np.eye(8) for b in rect])
    djac = np.concatenate([np.sum(b ** 2, axis=0) for b in rect]) + damp ** 2
    return dict(rect=rect, ragged=ragged, spd=spd, A=A, damp=damp, gram=gram,
                djac=djac, Y=rng.standard_normal((100, 3)),
                y80=rng.standard_normal(80), y100=rng.standard_normal(100),
                y48=rng.standard_normal(48), v48=rng.standard_normal(48),
                y37=rng.standard_normal(37), x29=rng.standard_normal(29),
                Ypool=rng.standard_normal((80, 3)))


# ------------------------------------------------------------ the ranks

def _tiers_rank(d):
    import pylops_mpi_tpu_torch as pmtt
    from pylops_mpi_tpu_torch import DistributedArray as D
    from pylops_mpi_tpu_torch.parallel import collectives as co
    from pylops_mpi_tpu_torch.ops import precond as pc
    n = pmtt.parallel.world_size()
    out = {}

    def bd(blocks):
        return pmtt.convert.blockdiag_from_numpy(blocks, device="cpu")

    def vec(v, op=None, rows=None):
        ls = rows if rows is not None else (
            None if op is None else op.local_shapes_n)
        if ls is not None and np.ndim(v) == 2:
            ls = [(s[0], v.shape[1]) for s in ls]
        return D.to_dist(v, local_shapes=ls, device="cpu")

    def run(key, fn, setup=0):
        co.reset_counts()
        res = fn()
        calls = (co.counts["all_reduce"] - setup) / NITER
        out[key] = (res, calls)

    R, G = bd(d["ragged"]), bd(d["rect"])
    # block CGLS, ragged blocks: 3 stacked reductions an iteration
    # (q·q, r·z, |s|²), each of K columns in one all_reduce
    run("block_cgls", lambda: (lambda o: (o[0].asarray(), o[2],
                                          o[5].numpy()))(
        pmtt.block_cgls(R, vec(d["Y"], R), niter=NITER, tol=0.0)), setup=2)
    MJ = pc.JacobiPrecond(d["djac"], device="cpu")
    run("pcgls_jacobi", lambda: (lambda o: (o[0].asarray(), o[2],
                                            o[5].numpy()))(
        pmtt.cgls(G, vec(d["y80"], G), niter=NITER, damp=d["damp"], tol=0.0,
                  M=MJ)))
    MB = pc.BlockJacobiPrecond.from_block_diag(G, normal=True, damp=d["damp"])
    run("pcgls_block", lambda: (lambda o: (o[0].asarray(), o[2],
                                           o[5].numpy()))(
        pmtt.cgls(G, vec(d["y80"], G), niter=NITER, damp=d["damp"], tol=0.0,
                  normal=True, M=MB)))
    # one all_gather: the final asarray; the applies were local
    out["pcgls_block_gathers"] = co.counts["all_gather"]
    # block-Jacobi blocks of 8 over the SPD operator's shards of 24 (two
    # ranks: aligned) or 12 (four ranks: they straddle)
    S = bd(d["spd"])
    MS = pc.BlockJacobiPrecond.from_operator(S, 8)
    run("pcg_straddle", lambda: (lambda o: (o[0].asarray(), o[1],
                                            o[2].numpy()))(
        pmtt.cg(S, vec(d["y48"], S), niter=NITER, tol=0.0, M=MS)))
    # the three schedules of one apply: bytes this rank receives
    applies = {}
    for name, rows in (("default", None), ("blocks", S.local_shapes_m),
                       ("odd", _odd_split(n))):
        co.reset_counts()
        y = MS.matvec(vec(d["v48"], rows=rows))
        moved = (co.received["all_gather"], co.counts["all_gather"])
        applies[name] = (y.asarray(),) + moved
    out["bj_applies"] = applies
    # the CA engines: one all_reduce an iteration (after the setup's
    # one), one an outer step of s-step
    os.environ["PYLOPS_MPI_TPU_TORCH_CA"] = "pipelined"
    try:
        run("pipe_cgls_normal", lambda: (lambda o: (o[0].asarray(), o[2],
                                                    o[5].numpy()))(
            pmtt.cgls(G, vec(d["y80"], G), niter=NITER, tol=0.0,
                      normal=True)), setup=1)
        run("pipe_ragged", lambda: (lambda o: (o[0].asarray(), o[2],
                                               o[5].numpy()))(
            pmtt.cgls(R, vec(d["y100"], R), niter=NITER, damp=d["damp"],
                      tol=0.0)), setup=1)
        os.environ["PYLOPS_MPI_TPU_TORCH_CA"] = "sstep"
        run("sstep_cg", lambda: (lambda o: (o[0].asarray(), o[1],
                                            o[2].numpy()))(
            pmtt.cg(S, vec(d["y48"], S), niter=NITER, tol=0.0)), setup=1)
        out["sstep_fallback"] = pmtt.solvers.ca.last_fallback()
    finally:
        os.environ.pop("PYLOPS_MPI_TPU_TORCH_CA", None)
    # the sparse product: a gather of x forward, a reduce-scatter back
    Sp = pmtt.MPISparseMatrixMult.from_dense(d["A"], device="cpu")
    co.reset_counts()
    fw = Sp.matvec(vec(d["x29"]))
    fw_bytes = co.received["all_gather"]
    co.reset_counts()
    ad = Sp.rmatvec(vec(d["y37"]))
    out["sparse_apply"] = (fw.asarray(), ad.asarray(), fw_bytes,
                           co.received["reduce_scatter"],
                           co.counts["reduce_scatter"])
    run("sparse_cgls", lambda: (lambda o: (o[0].asarray(), o[2],
                                           o[5].numpy()))(
        pmtt.cgls(Sp, vec(d["y37"]), niter=NITER, damp=0.1, tol=0.0)))
    # the serving pool, SPMD: every rank solves the same three requests
    # in the 4-bucket; then the daemon over the group: rank 0 admits the
    # same three requests one by one and the other ranks follow its
    # batches
    import torch
    from pylops_mpi_tpu_torch import serving
    pool = serving.WarmPool(buckets=(4,))
    pool.register(serving.FamilySpec("fam", G, solver="cgls", niter=NITER,
                                     dtype=torch.float64))
    res = pool.solve("fam", d["Ypool"])
    out["pool"] = (res.x, res.iiter, res.bucket)
    daemon = serving.SolveDaemon(pool, window_s=0.2)
    if pmtt.parallel.rank() == 0:
        daemon.start()
        tickets = [daemon.submit("fam", d["Ypool"][:, j]) for j in range(3)]
        out["daemon"] = np.stack([t.wait(timeout=60)["x"] for t in tickets],
                                 axis=1)
        daemon.drain()
    else:
        out["daemon"] = daemon.follow()
    return out


# ----------------------------------------------------------- reference

def _reference(n, d):
    import pylops_mpi_tpu as pmt
    from pylops_mpi_tpu.ops import precond as jpc
    from pylops_mpi_tpu.ops.local import MatrixMult as JM
    from pylops_mpi_tpu.ops.sparse import MPISparseMatrixMult as JSparse
    from pylops_mpi_tpu.solvers import block as jblock
    mesh = jax_mesh(n)
    J = pmt.DistributedArray

    def bd(blocks):
        return pmt.MPIBlockDiag([JM(b) for b in blocks], mesh=mesh)

    def vec(v):
        if np.ndim(v) == 2:
            y = J(global_shape=v.shape, mesh=mesh)
            y[:] = v
            return y
        return J.to_dist(v, mesh=mesh)

    def cg3(o):
        return np.asarray(o[0].asarray()), o[1], np.asarray(o[2])

    def cgls3(o):
        return np.asarray(o[0].asarray()), o[2], np.asarray(o[5])

    ref = {}
    R, G, S = bd(d["ragged"]), bd(d["rect"]), bd(d["spd"])
    ref["block_cgls"] = cgls3(jblock.block_cgls(R, vec(d["Y"]), niter=NITER,
                                                tol=0.0))
    MJ = jpc.JacobiPrecond(d["djac"], mesh=mesh)
    ref["pcgls_jacobi"] = cgls3(pmt.cgls(G, vec(d["y80"]), niter=NITER,
                                         damp=d["damp"], tol=0.0, M=MJ))
    MB = jpc.BlockJacobiPrecond(d["gram"], mesh=mesh)
    ref["pcgls_block"] = cgls3(pmt.cgls(G, vec(d["y80"]), niter=NITER,
                                        damp=d["damp"], tol=0.0, normal=True,
                                        M=MB))
    MS = jpc.BlockJacobiPrecond.from_operator(S, 8)
    ref["pcg_straddle"] = cg3(pmt.cg(S, vec(d["y48"]), niter=NITER, tol=0.0,
                                     M=MS))
    ref["bj_apply"] = np.asarray(MS.matvec(vec(d["v48"])).asarray())
    saved = os.environ.get("PYLOPS_MPI_TPU_CA")
    try:
        os.environ["PYLOPS_MPI_TPU_CA"] = "pipelined"
        pmt.clear_fused_cache()
        ref["pipe_cgls_normal"] = cgls3(pmt.cgls(G, vec(d["y80"]),
                                                 niter=NITER, tol=0.0,
                                                 normal=True))
        ref["pipe_ragged"] = cgls3(pmt.cgls(R, vec(d["y100"]), niter=NITER,
                                            damp=d["damp"], tol=0.0))
        os.environ["PYLOPS_MPI_TPU_CA"] = "sstep"
        pmt.clear_fused_cache()
        ref["sstep_cg"] = cg3(pmt.cg(S, vec(d["y48"]), niter=NITER, tol=0.0))
    finally:
        if saved is None:
            os.environ.pop("PYLOPS_MPI_TPU_CA", None)
        else:
            os.environ["PYLOPS_MPI_TPU_CA"] = saved
        pmt.clear_fused_cache()
    Sp = JSparse.from_dense(d["A"], mesh=mesh)
    ref["sparse_apply"] = (np.asarray(Sp.matvec(vec(d["x29"])).asarray()),
                           np.asarray(Sp.rmatvec(vec(d["y37"])).asarray()))
    ref["sparse_cgls"] = cgls3(pmt.cgls(Sp, vec(d["y37"]), niter=NITER,
                                        damp=0.1, tol=0.0))
    from pylops_mpi_tpu import serving as jserving
    from pylops_mpi_tpu.parallel import mesh as jmesh
    pool = jserving.WarmPool(buckets=(4,))
    pool.register(jserving.FamilySpec("fam", G, solver="cgls", niter=NITER,
                                      dtype=np.float64))
    saved = jmesh.default_mesh()
    jmesh.set_default_mesh(mesh)  # the pool's block lives on the default mesh
    try:
        ref["pool"] = pool.solve("fam", d["Ypool"]).x
    finally:
        jmesh.set_default_mesh(saved)
    return ref


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    d = make_data()
    out = {}
    for n in SIZES:
        res, ref = run_world(_tiers_rank, n, tmp_path_factory.mktemp(f"w{n}"),
                             d, during=lambda n=n: _reference(n, d))
        out[n] = (res, ref)
    return out


SOLVES = ["block_cgls", "pcgls_jacobi", "pcgls_block", "pcg_straddle",
          "pipe_cgls_normal", "pipe_ragged", "sstep_cg", "sparse_cgls"]
# all_reduce calls an iteration: classic CGLS 3 (q·q, r·z, |s|²) plus
# c·c and x·x when damped, plus 2 or 3 at setup; CG 2 plus 1 at setup
CALLS = {"block_cgls": 3.0, "pcgls_jacobi": 5 + 3 / NITER,
         "pcgls_block": 5 + 3 / NITER, "pcg_straddle": 2 + 1 / NITER,
         "pipe_cgls_normal": 1.0, "pipe_ragged": 1.0,
         "sstep_cg": 3 / NITER, "sparse_cgls": 5 + 3 / NITER}


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("key", SOLVES)
def test_solves_match_jax(worlds, n, key):
    res, ref = worlds[n]
    jx, jit, jcost = ref[key]
    for o in res:
        (x, it, cost), calls = o[key]
        assert it == jit == NITER
        close(x, jx, RTOL)
        close(cost, jcost, RTOL)
        assert calls == pytest.approx(CALLS[key]), (key, calls)
    if key == "sstep_cg":
        assert all(o["sstep_fallback"] is None for o in res)
    if key == "pcgls_block":  # the chunk's blocks: local applies
        assert all(o["pcgls_block_gathers"] == 1 for o in res)


@pytest.mark.parametrize("n", SIZES)
def test_warm_pool_matches_jax_and_daemon_refuses(worlds, n):
    """``WarmPool.solve`` under a group (every rank the same requests)
    against the JAX package's pool on a mesh of ``n`` devices; the daemon
    serves over the group (it no longer refuses one): rank 0's results
    match the pool's, and every other rank followed at least one
    batch."""
    res, ref = worlds[n]
    for r, o in enumerate(res):
        x, it, bucket = o["pool"]
        assert (it, bucket, x.shape) == (NITER, 4, (64, 3))
        close(x, ref["pool"], RTOL)
        if r == 0:
            close(o["daemon"], ref["pool"], RTOL)
        else:
            assert o["daemon"] >= 1


@pytest.mark.parametrize("n", SIZES)
def test_block_jacobi_apply_schedules(worlds, n):
    """Aligned shards solve locally; straddled ones gather ``x`` once;
    rows outside a rank's blocks take a second gather of the solves."""
    res, ref = worlds[n]
    want = {"default": 0 if n == 2 else 1, "blocks": 0 if n == 2 else 1,
            "odd": 2}
    for o in res:
        for name, (y, nbytes, calls) in o["bj_applies"].items():
            close(y, ref["bj_apply"], 1e-12)
            assert calls == want[name], (name, calls)
            assert (nbytes > 0) == (calls > 0)


@pytest.mark.parametrize("n", SIZES)
def test_sparse_applies(worlds, n):
    res, ref = worlds[n]
    for r, o in enumerate(res):
        fw, ad, fw_bytes, ad_bytes, rs_calls = o["sparse_apply"]
        close(fw, ref["sparse_apply"][0], 1e-12)
        close(ad, ref["sparse_apply"][1], 1e-12)
        # x comes whole (29 f64, padded to the largest shard) and the
        # adjoint's reduce-scatter delivers the other ranks' pieces
        width = -(-29 // n)
        assert fw_bytes == 8 * width * (n - 1)
        assert rs_calls == 1 and ad_bytes == 8 * width * (n - 1)
