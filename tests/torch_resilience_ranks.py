"""Rank-side and worker-side code of the port's resilience tests
(``test_torch_segmented.py``, ``test_torch_supervisor.py``): it imports
numpy, torch and the port only, never the JAX package, so a spawned
rank or a supervised worker starts fast and touches no accelerator
plugin. Run as a script it is the supervised chaos worker (see
:func:`chaos_worker`)."""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import pylops_mpi_tpu_torch as pmtt  # noqa: E402
from pylops_mpi_tpu_torch.solvers.segmented import cgls_segmented  # noqa


class Kill(Exception):
    pass


def killer(at):
    """An ``on_epoch`` hook that raises :class:`Kill` after epoch
    ``at``, with its checkpoint written."""
    def on_epoch(info):
        if info["epoch"] == at:
            raise Kill
    return on_epoch


def seg_rank(blocks, y, path, backend, niter, kill_at):
    """A rank of the world that saves: the segmented solve, killed after
    ``kill_at`` epochs (its checkpoint stays)."""
    T = pmtt.convert.blockdiag_from_numpy(blocks, device="cpu")
    ty = pmtt.DistributedArray.to_dist(y, device="cpu")
    try:
        cgls_segmented(T, ty, niter=niter, tol=0.0, epoch=4,
                       checkpoint_path=path, backend=backend,
                       on_epoch=killer(kill_at))
    except Kill:
        pass
    return pmtt.parallel.world_size()


def resume_rank(blocks, y, path, backend, niter):
    T = pmtt.convert.blockdiag_from_numpy(blocks, device="cpu")
    ty = pmtt.DistributedArray.to_dist(y, device="cpu")
    res = cgls_segmented(T, ty, niter=niter, tol=0.0, epoch=4,
                         checkpoint_path=path, backend=backend)
    return res.x.asarray(), res.iiter, res.epochs




# ------------------------------------------------------ the chaos worker
def chaos_problem(device):
    """The seeded block-diagonal least-squares problem (24×24 blocks,
    diagonal lifted by 4, f64), identical in every process."""
    rng = np.random.default_rng(0)
    n, nb = 24, 8
    blocks = []
    for _ in range(nb):
        b = rng.standard_normal((n, n)) / np.sqrt(n)
        np.fill_diagonal(b, b.diagonal() + 4.0)
        blocks.append(b)
    xt = rng.standard_normal(nb * n)
    y = np.concatenate([b @ xt[i * n:(i + 1) * n]
                        for i, b in enumerate(blocks)])
    Op = pmtt.convert.blockdiag_from_numpy(blocks, device=device)
    return Op, pmtt.DistributedArray.to_dist(y, device=device)


def chaos_worker(ckpt, out, mark, device="cpu", sleep_s=0.3):
    """A supervised worker: join the attempt's gloo group (none for a
    world of one), run a segmented f64 CGLS with the shards backend,
    resuming from ``ckpt`` when it exists, and write rank 0's ``x`` to
    ``out``. After each saved epoch it touches ``mark`` (so the chaos
    test stops it mid-solve, outside a collective) and, in the first
    attempt, sleeps ``sleep_s``. It leaves with ``os._exit``: a group
    whose peer died would hang its shutdown."""
    from pylops_mpi_tpu_torch.resilience import elastic
    cfg = elastic.elastic_initialize(backend="gloo", device=device)
    Op, y = chaos_problem(device)

    def on_epoch(info):
        with open(mark, "w") as f:
            f.write(str(info["epoch"]))
        if cfg.attempt == 0:
            time.sleep(sleep_s)

    res = cgls_segmented(Op, y, niter=60, tol=0.0, epoch=5,
                         checkpoint_path=ckpt, backend="shards",
                         on_epoch=on_epoch)
    x = res.x.asarray()
    if pmtt.parallel.rank() == 0:
        np.save(out, x)
    print(f"CHAOS OK attempt={cfg.attempt} world={cfg.num_processes or 1} "
          f"iiter={res.iiter} epochs={res.epochs}", flush=True)
    sys.stdout.flush()
    os._exit(0)


if __name__ == "__main__":
    chaos_worker(*sys.argv[1:4], *sys.argv[4:5])
