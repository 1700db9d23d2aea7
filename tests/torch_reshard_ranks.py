"""Rank-side code of the resharding, spill, topology and in-place tests
(``test_torch_{reshard,spill,topology,inplace}.py``): numpy, torch and
the port only, never the JAX package, so spawned gloo ranks start fast.
Each function runs every case of its file in one world and returns plain
values (numpy arrays, numbers, strings) that the test holds against the
JAX package in the parent process."""

import os

import numpy as np
import torch

import pylops_mpi_tpu_torch as pmtt
from pylops_mpi_tpu_torch.diagnostics import metrics, trace
from pylops_mpi_tpu_torch.parallel import collectives, reshard as rs
from pylops_mpi_tpu_torch.parallel.partition import Partition
from pylops_mpi_tpu_torch.utils.decorators import reshaped

P = "PYLOPS_MPI_TPU_TORCH_"


def field(shape=(13, 7), seed=0):
    """The seeded field every case moves."""
    return np.random.default_rng(seed).standard_normal(shape)


def ragged(n, rows=13):
    """A ragged split of ``rows`` over ``n`` ranks: the last rank takes
    the most."""
    base = [max(1, rows // (2 * n))] * (n - 1)
    return base + [rows - sum(base)]


def _steps():
    return [e["args"] for e in trace.get_events()
            if e["name"] == "collective.reshard.step"]


def _fresh():
    collectives.reset_counts()
    trace.clear_events()
    metrics.clear_metrics()


def _move(name, fn, out):
    """Run one move with fresh counters and record what it left: the
    gathered value (members only), this rank's local shape, the counts,
    the bytes received and the largest staging of its steps."""
    _fresh()
    res = fn()
    rec = {"local_shape": tuple(res.local_shape) if hasattr(
        res, "local_shape") else tuple(res.local.shape),
        "counts": dict(collectives.counts),
        "received": dict(collectives.received),
        "max_scratch": max([s.get("scratch_bytes", 0) for s in _steps()],
                           default=0),
        "max_staged": max([s.get("staged_bytes", 0) for s in _steps()],
                          default=0),
        "n_steps": len(_steps()),
        "counters": dict(metrics.snapshot()["counters"])}
    mesh = res.mesh
    rec["member"] = bool(mesh.member)
    if mesh.member:
        rec["value"] = res.asarray()
    out[name] = rec
    return res


def reshard_rank(budget):
    """Every move of ``test_torch_reshard.py`` on this world (see there)."""
    os.environ[P + "TRACE"] = "spans"
    os.environ[P + "METRICS"] = "on"
    n = pmtt.parallel.world_size()
    g = field()
    out = {}
    x = pmtt.DistributedArray.to_dist(g, device="cpu")
    _move("redistribute", lambda: x.redistribute(1), out)
    _move("axis_budget", lambda: x.reshard(axis=1, budget=budget), out)
    rag = [(r, 7) for r in ragged(n)]
    xr = pmtt.DistributedArray.to_dist(g, local_shapes=rag, device="cpu")
    _move("ragged_budget", lambda: xr.reshard(budget=budget), out)
    _move("to_bcast", lambda: x.to_partition(Partition.BROADCAST), out)
    xb = pmtt.DistributedArray.to_dist(g, Partition.BROADCAST, device="cpu")
    _move("from_bcast", lambda: xb.to_partition(Partition.SCATTER, 1), out)
    small = pmtt.parallel.sub_mesh(range(max(1, n // 2)))
    s = _move("shrink", lambda: x.reshard(mesh=small, budget=budget), out)
    _move("grow", lambda: s.reshard(mesh=pmtt.parallel.default_mesh(),
                                    budget=budget), out)
    _move("place", lambda: rs.place_replica(g, budget=budget, device="cpu"),
          out)
    # a split axis shorter than the world: some shards hold zero rows
    xs = pmtt.DistributedArray.to_dist(g[:2], device="cpu")
    _move("short", lambda: xs.redistribute(1).redistribute(0), out)
    for ov in ("on", "off"):
        _move(f"spill_{ov}", lambda: rs.reshard(
            x, axis=1, budget=budget, spill="on", overlap=ov), out)
    try:
        rs.reshard(x, axis=1, budget=8, spill="off")
        out["refused"] = None
    except rs.ReshardError as e:
        out["refused"] = (e.min_budget, str(e))
    out["grad"] = grad_rank(g, budget)
    out["plots"] = plot_rank()
    out["n"] = n
    return out


def weights(shape, seed=3):
    """The seeded weights of the gradient cases' losses ``Σ W·y``."""
    return field(shape, seed)


def _weighted(y):
    """``Σ W·y`` over the whole of ``y`` with ``W`` :func:`weights` of its
    global shape: a SCATTER array's per-rank terms summed with
    ``all_reduce`` (its gradient, the move's adjoint applied to ``W``);
    a replicated one's, which every rank holds, counted once."""
    w = torch.as_tensor(weights(y.global_shape))
    if y.partition != Partition.SCATTER:
        return torch.sum(w * y.array)
    part = torch.sum(w[_cut(y)] * y.array).reshape(1)
    return collectives.all_reduce(part).sum()


def _cut(y):
    """This rank's index into ``y``'s global array."""
    from pylops_mpi_tpu_torch.parallel.partition import shard_offsets
    sl = [slice(None)] * y.ndim
    off = shard_offsets(y._axis_sizes())[y._me()]
    sl[y.axis] = slice(off, off + y.local_shape[y.axis])
    return tuple(sl)


def _grad_case(x, fn, out, name):
    """The gradient of ``Σ W·fn(x)`` with respect to this rank's shard of
    ``x``, the adjoint test's two sides (``Σ W·fn(x)`` against
    ``Σ_ranks ⟨x, gx⟩``, which agree as the move is linear), and the
    counts and bytes of the forward and the backward."""
    x.array.requires_grad_(True)
    collectives.reset_counts()
    loss = _weighted(fn(x))
    fwd = (dict(collectives.counts), dict(collectives.received))
    collectives.reset_counts()
    (gx,) = torch.autograd.grad(loss, x.array)
    bwd = (dict(collectives.counts), dict(collectives.received))
    x.array.requires_grad_(False)
    ip = torch.sum(x.array * gx).reshape(1)
    if x.partition == Partition.SCATTER:
        ip = collectives.all_reduce(ip)
    out[name] = dict(grad=gx.numpy(), fwd=fwd, bwd=bwd,
                     adjoint=(float(loss.detach()), float(ip.sum())))


def grad_rank(g, budget):
    """The moves, ``ghosted`` and ``reshaped`` of an array that requires
    grad (``test_torch_reshard.py``): each gradient and its adjoint test;
    ``place_replica``, ``to_host`` and a move onto a smaller world still
    refuse, saying why."""
    n = pmtt.parallel.world_size()
    D = pmtt.DistributedArray
    rag = [(r, 7) for r in ragged(n)]
    out = {}
    cases = (
        ("redistribute", D.to_dist(g, device="cpu"),
         lambda x: x.redistribute(1)),
        ("axis_budget", D.to_dist(g, device="cpu"),
         lambda x: x.reshard(axis=1, budget=budget)),
        ("ragged_budget", D.to_dist(g, local_shapes=rag, device="cpu"),
         lambda x: x.reshard(budget=budget)),
        ("to_bcast", D.to_dist(g, device="cpu"),
         lambda x: x.to_partition(Partition.BROADCAST)),
        ("from_bcast", D.to_dist(g, Partition.BROADCAST, device="cpu"),
         lambda x: x.to_partition(Partition.SCATTER, 1)),
        ("short", D.to_dist(g[:2], device="cpu"),
         lambda x: x.redistribute(1).redistribute(0)),
        ("ghosted", D.to_dist(g, device="cpu"), lambda x: x.ghosted(2, 1)),
        ("ghosted_ragged", D.to_dist(g, local_shapes=rag, device="cpu"),
         lambda x: x.ghosted(1, 1)),
        ("reshaped", D.to_dist(g.ravel(), device="cpu"),
         lambda x: RowSum(g.shape).matvec(x)),
        ("reshaped_stacking", D.to_dist(g.ravel(), device="cpu"),
         lambda x: RowScale(g.size, n).matvec(x)))
    for name, x, fn in cases:
        _grad_case(x, fn, out, name)
    for name, x in (("ghosted", D.to_dist(g, device="cpu")),
                    ("ghosted_ragged", D.to_dist(g, local_shapes=rag,
                                                 device="cpu"))):
        y = x.ghosted(2 if name == "ghosted" else 1, 1)
        out[name].update(value=y.array.numpy(), local_shapes=y.local_shapes,
                         global_shape=y.global_shape)
    for name, op in (("reshaped", RowSum(g.shape)),
                     ("reshaped_stacking", RowScale(g.size, n))):
        x = D.to_dist(g.ravel(), device="cpu")
        y, xa = op.matvec(x), op.rmatvec(x)
        out[name].update(value=y.asarray(), adjoint_value=xa.asarray(),
                         local_shapes=(y.local_shapes, xa.local_shapes))
    xg = D.to_dist(g, device="cpu")
    xg.array.requires_grad_(True)
    tg = torch.tensor(g, requires_grad=True)
    small = pmtt.parallel.sub_mesh(range(max(1, n // 2)))
    refused = {}
    for name, call in (
            ("to_host", lambda: xg.to_host()),
            ("place_replica", lambda: rs.place_replica(tg, device="cpu")),
            ("shrink", lambda: xg.reshard(mesh=small, budget=budget))):
        try:
            call()
            refused[name] = None
        except NotImplementedError as e:
            refused[name] = str(e)
    out["refused"] = refused
    return out


class RowSum(pmtt.MPILinearOperator):
    """A custom operator on an ``(nx, ny)`` field through ``@reshaped``:
    each row's running sum, the adjoint the running sum from the row's
    end. Its applies see the field sharded on axis 0."""

    def __init__(self, dims):
        self.dims = self.dimsd = tuple(dims)
        n = int(np.prod(dims))
        super().__init__(shape=(n, n), dtype=torch.float64)

    @reshaped
    def _matvec(self, x):
        return pmtt.DistributedArray._wrap(torch.cumsum(x.array, 1), x)

    @reshaped
    def _rmatvec(self, x):
        rev = torch.flip(torch.cumsum(torch.flip(x.array, (1,)), 1), (1,))
        return pmtt.DistributedArray._wrap(rev, x)


def stacking_shapes(size, n):
    """``RowScale``'s split: ragged, so that a vector in the default
    split is moved to it."""
    return [(s,) for s in ragged(n, size)]


class RowScale(pmtt.MPILinearOperator):
    """A custom operator through ``@reshaped(stacking=True)``: entry
    ``i`` of a flat vector split as its ``local_shapes_m`` scaled by
    ``i + 1`` (self-adjoint)."""

    def __init__(self, size, n):
        self.local_shapes_m = self.local_shapes_n = tuple(
            stacking_shapes(size, n))
        super().__init__(shape=(size, size), dtype=torch.float64)

    def _scale(self, x):
        w = np.arange(1.0, x.global_shape[0] + 1)
        return x * pmtt.DistributedArray.to_dist(
            w, local_shapes=x.local_shapes, device="cpu")

    @reshaped(stacking=True)
    def _matvec(self, x):
        return self._scale(x)

    @reshaped(stacking=True)
    def _rmatvec(self, x):
        return self._scale(x)


def plot_rank():
    """``plot_distributed_array`` and ``plot_local_arrays`` of the seeded
    field, 2-D and raveled, under the Agg backend: each axes' image and
    title."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from pylops_mpi_tpu_torch import plotting
    g = field()
    out = {}
    for name, arr in (("2d", pmtt.DistributedArray.to_dist(
            g, device="cpu")), ("1d", pmtt.DistributedArray.to_dist(
                g.ravel(), local_shapes=[(7 * r,) for r in ragged(
                    pmtt.parallel.world_size())], device="cpu"))):
        for kind, fn in (("layout", plotting.plot_distributed_array),
                         ("locals", plotting.plot_local_arrays)):
            fig, axs = fn(arr)
            out[f"{kind}_{name}"] = [
                (np.asarray(ax.images[0].get_array()), ax.get_title())
                for ax in np.atleast_1d(axs)]
            plt.close(fig)
    return out


def spill_rank(budget):
    """The spill tier on this world (``test_torch_spill.py``): to_host
    with overlap on and off, back to the card, and from the host to
    another axis; the bytes each rank staged."""
    os.environ[P + "TRACE"] = "spans"
    os.environ[P + "METRICS"] = "on"
    n = pmtt.parallel.world_size()
    g = field((11, 6), seed=1)
    rag = [(r, 6) for r in ragged(n, 11)]
    x = pmtt.DistributedArray.to_dist(g, local_shapes=rag, device="cpu")
    out = {"n": n}
    hs = {}
    for ov in ("on", "off"):
        hs[ov] = _move(f"to_host_{ov}", lambda: x.to_host(
            budget=budget, overlap=ov), out)
    out["host_local_equal"] = bool(torch.equal(hs["on"].local,
                                               hs["off"].local))
    _move("to_device", lambda: hs["on"].to_device(budget=budget), out)
    _move("to_device_spilled", lambda: hs["on"].to_device(
        budget=budget, spill="on"), out)
    _move("from_host_axis1", lambda: rs.reshard(
        hs["off"], axis=1, budget=budget, spill="on"), out)
    return out


def topology_rank():
    """Topology on a world of 4 with and without ``..._FABRIC=2x2``
    (``test_torch_topology.py``): the hybrid grid, keys and the byte
    split of the collectives."""
    from pylops_mpi_tpu_torch.parallel import topology
    from pylops_mpi_tpu_torch.tuning import plan as tplan
    from pylops_mpi_tpu_torch.aot.signature import compile_signature
    os.environ[P + "METRICS"] = "on"
    out = {}
    for label, fab in (("flat", ""), ("hybrid", "2x2")):
        os.environ[P + "FABRIC"] = fab
        grid = pmtt.parallel.make_mesh_hybrid()
        metrics.clear_metrics()
        t = torch.ones(4, dtype=torch.float64)
        collectives.all_reduce(t)
        collectives.all_reduce(t, group=grid.c)
        collectives.all_reduce(t, group=grid.r)
        os.environ[P + "TUNE"] = "on"
        try:
            key = tplan.get_plan("blockdiag", shape=(4, 8, 8),
                                 dtype=np.float32, device="cpu").key
        finally:
            del os.environ[P + "TUNE"]
        out[label] = {"shape": grid.shape, "coords": grid.coords,
                      "axis_names": grid.axis_names,
                      "fabrics": topology.mesh_fabrics(grid),
                      "key": topology.topology_key(grid),
                      "world_key": topology.world_key(),
                      "plan_key": key,
                      "signature": compile_signature()["topology"],
                      "counters": {k: v for k, v in metrics.snapshot()[
                          "counters"].items() if "all_reduce" in k}}
    os.environ[P + "FABRIC"] = ""
    try:
        pmtt.parallel.make_mesh_hybrid(dcn_size=3)
        out["bad"] = None
    except ValueError as e:
        out["bad"] = str(e)
    return out


def bank_rank(ckpt_dir):
    """A world of 2 banks a carry of every field kind and writes a
    checkpoint with both backends (``test_torch_inplace.py``); returns
    the bank's record, and a masked record."""
    from pylops_mpi_tpu_torch.resilience import elastic
    from pylops_mpi_tpu_torch.utils import checkpoint
    g = field((9, 4), seed=2)
    x = pmtt.DistributedArray.to_dist(g, device="cpu")
    xb = pmtt.DistributedArray.to_dist(g[0], Partition.BROADCAST,
                                       device="cpu")
    carry = {"x": x, "b": xb,
             "kold": torch.tensor([3.5], dtype=torch.float64),
             "iiter": torch.tensor([7], dtype=torch.int64),
             "niter": 60, "tol": 0.0}
    elastic.bank_carry("cgls", carry)
    masked = pmtt.DistributedArray.to_dist(g, mask=[0, 1], device="cpu")
    elastic.bank_carry("masked", {"x": masked})
    for backend in ("native", "shards"):
        checkpoint.save_pytree(os.path.join(ckpt_dir, backend),
                               {"x": x, "b": xb, "k": 3}, backend=backend)
    return {"cgls": elastic.banked_carry("cgls"),
            "masked": elastic.banked_carry("masked")}
