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
    out["grad"] = _grad_refusals(g, budget)
    out["n"] = n
    return out


def _grad_refusals(g, budget):
    """Each move of an array that requires grad, under grad mode: the
    error's text, or ``None`` when it went through (received pieces
    arrive detached, so every move between ranks must raise); and
    outside grad mode, whether the redistribute ran."""
    xg = pmtt.DistributedArray.to_dist(g, device="cpu")
    xg.array.requires_grad_(True)
    tg = torch.tensor(g, requires_grad=True)
    peer = (pmtt.parallel.rank() + 1) % pmtt.parallel.world_size()
    res = {}
    for name, call in (
            ("redistribute", lambda: xg.redistribute(1)),
            ("reshard", lambda: xg.reshard(axis=1, budget=budget)),
            ("to_partition", lambda: xg.to_partition(Partition.BROADCAST)),
            ("to_host", lambda: xg.to_host()),
            ("place_replica", lambda: rs.place_replica(tg, device="cpu")),
            ("exchange", lambda: collectives.exchange(
                "exchange", [(tg, peer)], [(tuple(g.shape), peer)],
                tg.dtype))):
        try:
            call()
            res[name] = None
        except NotImplementedError as e:
            res[name] = str(e)
    with torch.no_grad():
        res["no_grad"] = bool(np.array_equal(xg.redistribute(1).asarray(),
                                             g))
    return res


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
