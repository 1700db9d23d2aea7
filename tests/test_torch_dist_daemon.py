"""The solve daemon over a process group: gloo worlds of 2 ranks.

Rank 0 owns the admission queue and the dispatcher; for each batch it
packs, its pool sends the other ranks a header and the right-hand sides,
and every rank solves the batch (SPMD); the other ranks follow until
rank 0's drain sends the stop flag. Checked here:

- 16 requests over two families (CGLS and CG) from 4 threads on rank 0:
  every result equals the one-process daemon's (run in this process)
  within 1e-6 relative, and every batch a rank solved equals
  ``block_cgls``/``block_cg`` on the same columns over the same group;
  rank 0's stats count the 16 solves and the followers solved the same
  batches in the same order;
- ``worker_main`` over the group: rank 0 claims the spool's requests and
  banks their results, rank 1 follows; the banked results equal the
  one-process daemon's;
- a follower refuses ``start``, rank 0 ``follow``;
- a drain that gives up on the dispatcher while a batch runs still
  sends the stop flag only after that batch (its ticket resolves, the
  follower solved it), and afterwards a daemon only built leaves the
  pool alone: a direct ``WarmPool.solve`` on every rank (SPMD) sends no
  header and equals the ticket's result.

Sizes: two families of 8 blocks of 6×5 (f64), 10 iterations.
"""

import threading
import time

import numpy as np
import pytest

from test_torch_process_group import close, run_world

NREQ, THREADS, NITER = 16, 4, 10


def make_data():
    rng = np.random.default_rng(8)
    rect = [0.3 * rng.standard_normal((6, 5)) + 3 * np.eye(6, 5)
            for _ in range(8)]
    spd = []
    for _ in range(8):
        a = rng.standard_normal((5, 5))
        spd.append(a @ a.T * 0.2 + 3 * np.eye(5))
    reqs = [("ls", rng.standard_normal(48)) if i % 2 == 0
            else ("spd", rng.standard_normal(40)) for i in range(NREQ)]
    return dict(rect=rect, spd=spd, reqs=reqs)


def _pool(d, log=None, slow_s=0.0):
    import torch
    import pylops_mpi_tpu_torch as pmtt
    from pylops_mpi_tpu_torch import serving

    class Pool(serving.WarmPool):
        slow = slow_s

        def solve(self, name, Y):
            time.sleep(self.slow)   # a batch that is still running
            out = super().solve(name, Y)
            if log is not None:
                Y = np.asarray(Y)
                log.append((name, Y[:, None] if Y.ndim == 1 else Y, out.x))
            return out

    pool = Pool(buckets=(1, 2, 4))
    pool.register(serving.FamilySpec(
        "ls", pmtt.convert.blockdiag_from_numpy(d["rect"], device="cpu"),
        solver="cgls", niter=NITER, damp=0.1, dtype=torch.float64))
    pool.register(serving.FamilySpec(
        "spd", pmtt.convert.blockdiag_from_numpy(d["spd"], device="cpu"),
        solver="cg", niter=NITER, dtype=torch.float64))
    return pool


def _serve(d, pool):
    """Rank 0 (or the one process): 16 requests from 4 threads."""
    from pylops_mpi_tpu_torch import serving
    daemon = serving.SolveDaemon(pool, window_s=0.02).start()
    results = [None] * NREQ

    def client(t):
        for i in range(t, NREQ, THREADS):
            fam, y = d["reqs"][i]
            results[i] = daemon.submit(fam, y).wait(timeout=60)["x"]

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(THREADS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    stats = daemon.stats()
    assert daemon.drain()
    return results, stats


def _daemon_rank(d, spool_dir):
    import pylops_mpi_tpu_torch as pmtt
    from pylops_mpi_tpu_torch import DistributedArray as D
    from pylops_mpi_tpu_torch import serving
    from pylops_mpi_tpu_torch.solvers.block import block_cg, block_cgls
    r = pmtt.parallel.rank()
    log = []
    pool = _pool(d, log)
    out = {}
    if r == 0:
        out["results"], out["stats"] = _serve(d, pool)
        try:
            serving.SolveDaemon(pool).follow()
        except RuntimeError as e:
            out["refused"] = str(e)
    else:
        out["followed"] = serving.SolveDaemon(pool).follow()
        try:
            serving.SolveDaemon(pool).start()
        except RuntimeError as e:
            out["refused"] = str(e)
    # every batch again, by the block solvers over the same group
    out["batches"] = []
    for name, Y, x in log:
        spec = pool.family(name)
        yb = D.to_dist(Y, local_shapes=[(s[0], Y.shape[1])
                                        for s in spec.operator.local_shapes_n],
                       device="cpu")
        if spec.solver == "cg":
            xb = block_cg(spec.operator, yb, niter=NITER, tol=0.0)[0]
        else:
            xb = block_cgls(spec.operator, yb, niter=NITER, damp=0.1,
                            tol=0.0)[0]
        out["batches"].append((name, Y.shape[1], x,
                               xb.asarray()[:, :x.shape[1]]))
    # worker_main over the group: rank 0 claims and banks, rank 1 follows
    out["worker"] = serving.worker_main(spool_dir, _pool(d), prewarm=False,
                                        window_s=0.02, idle_exit_s=1.0)
    return out


def _drain_rank(d):
    import pylops_mpi_tpu_torch as pmtt
    from pylops_mpi_tpu_torch import serving
    from pylops_mpi_tpu_torch.serving import queue as squeue
    r = pmtt.parallel.rank()
    y = d["reqs"][0][1]
    pool = _pool(d, slow_s=0.5 if r == 0 else 0.0)
    out = {}
    if r == 0:
        # the drain gives up on the dispatcher at once, as it does after
        # its join timeout with a long batch running
        stop = squeue.Dispatcher.stop
        squeue.Dispatcher.stop = lambda self, timeout=5.0: stop(self, 0.0)
        daemon = serving.SolveDaemon(pool, window_s=0.01).start()
        ticket = daemon.submit("ls", y)
        while not daemon.dispatcher._inflight.is_set():
            time.sleep(0.005)
        out["drained"] = daemon.drain(timeout=0.0)
        out["ticket"] = ticket.wait(timeout=60)["x"]
        serving.SolveDaemon(pool)   # only built: the pool stays direct
        pool.slow = 0.0
    else:
        out["followed"] = serving.SolveDaemon(pool).follow()
    out["direct"] = pool.solve("ls", y).x[:, 0]
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from pylops_mpi_tpu_torch.serving import spool
    d = make_data()
    root = str(tmp_path_factory.mktemp("spool"))
    for i, (fam, y) in enumerate(d["reqs"]):
        spool.enqueue(root, fam, y, request_id=f"r{i:02d}")
    res, ref = run_world(_daemon_rank, 2, tmp_path_factory.mktemp("w2"),
                         d, root, during=lambda: _serve(d, _pool(d)))
    return d, root, res, ref


def test_daemon_over_group_matches_one_process(world):
    d, _, res, (ref, _) = world
    r0, r1 = res
    for got, want in zip(r0["results"], ref):
        close(got, want, 1e-6)
    assert r0["stats"]["solves"] == NREQ and r0["stats"]["failed"] == 0
    # the follower solved rank 0's batches, in order
    assert r1["followed"] == r0["stats"]["batches"]
    assert [b[:2] for b in r0["batches"]] == [b[:2] for b in r1["batches"]]
    for o in res:
        for name, k, x, xb in o["batches"]:
            close(x, xb, 1e-12)
    print("rank 0 stats:", r0["stats"])


def test_roles_are_refused_on_the_wrong_rank(world):
    _, _, (r0, r1), _ = world
    assert "ranks other than 0" in r0["refused"]
    assert "follow" in r1["refused"]


def test_worker_main_over_group(world):
    from pylops_mpi_tpu_torch.serving import spool
    d, root, (r0, r1), (ref, _) = world
    assert r0["worker"] == NREQ and r1["worker"] == 0
    assert sorted(spool.result_ids(root)) == [f"r{i:02d}"
                                              for i in range(NREQ)]
    for i in range(NREQ):
        close(spool.read_result(root, f"r{i:02d}")["x"], ref[i], 1e-6)


def test_drain_waits_for_the_running_batch_then_pool_is_direct(
        tmp_path_factory):
    d = make_data()
    (r0, r1), ref = run_world(
        _drain_rank, 2, tmp_path_factory.mktemp("drain"), d,
        during=lambda: _pool(d).solve("ls", d["reqs"][0][1]).x[:, 0])
    assert r0["drained"] is False   # the batch was still in flight
    assert r1["followed"] == 1
    close(r0["ticket"], ref, 1e-6)
    close(r0["direct"], r0["ticket"], 1e-12)
    close(r1["direct"], r0["ticket"], 1e-12)
