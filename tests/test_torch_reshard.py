"""The port's bounded-memory resharding held against the JAX package.

Plans: ``plan_reshard`` is host math, so the port's plan must equal the
JAX package's field for field on the same inputs (ragged regrids, axis
changes, BROADCAST↔SCATTER, shrink 4→2 and grow, budgets from unbounded
down to ``min_budget`` and below it, forced chunk counts, a per-fabric
split from ``slice_ids`` of a 2x2 layout, spill ``auto``/``on``/``off``),
JAX's ``nbytes_ici``/``nbytes_dcn`` read as the port's ``nbytes_nvlink``/
``nbytes_ib``, and a refusal with the same minimum and message (the
knob's and the topology key's names mapped).

Moves: gloo worlds of 2, 3 and 4 ranks (spawned once each for the
module) run every move of ``torch_reshard_ranks.reshard_rank`` on a
seeded (13, 7) f64 field: the gathered value bitwise equal to the JAX
package's result of the same move on a mesh of as many devices, each
member's local shape equal to JAX's, the bytes each rank receives equal
to the plan's pair bytes (its column), as many exchanges as the plan has
chunks (with no budget: the one all_to_all ``redistribute`` always
issued), the largest staging a step recorded under the budget, and the
host-staged move's bytes summed over the ranks equal to the plan's.
"""

import numpy as np
import pytest
import torch

import pylops_mpi_tpu.parallel.reshard as jrs
from pylops_mpi_tpu.parallel.partition import Partition as JPart
import pylops_mpi_tpu_torch as pmtt
from pylops_mpi_tpu_torch.parallel import reshard as trs
from pylops_mpi_tpu_torch.parallel.partition import Partition as TPart

from test_torch_process_group import jax_mesh, run_world
from torch_reshard_ranks import field, ragged, reshard_rank

BUDGET = 320  # bytes: a few 56-byte rows of the (13, 7) f64 field
WORLDS = (2, 3, 4)


# ------------------------------------------------------------- plans
def _lay(pkg, spec):
    kind, a, b = spec
    if pkg == "jax":
        L, Part = jrs.Layout, JPart
    else:
        L, Part = trs.Layout, TPart
    if kind == "s":
        return L.scatter(a, b)
    return L.replicated(a, Part[b])


def _plan_fields(p, pkg):
    lay = lambda l: (l.partition.name, l.axis, tuple(l.sizes), l.n_shards)
    if pkg == "jax":
        nv, ib = p.nbytes_ici, p.nbytes_dcn
        steps = [(s.kind, s.chunk, s.lo, s.hi, s.nbytes, s.nbytes_ici,
                  s.nbytes_dcn, s.scratch_bytes, s.nbytes_h2d, s.nbytes_d2h)
                 for s in p.steps]
    else:
        nv, ib = p.nbytes_nvlink, p.nbytes_ib
        steps = [(s.kind, s.chunk, s.lo, s.hi, s.nbytes, s.nbytes_nvlink,
                  s.nbytes_ib, s.scratch_bytes, s.nbytes_h2d, s.nbytes_d2h)
                 for s in p.steps]
    return dict(global_shape=p.global_shape, itemsize=p.itemsize,
                src=lay(p.src), dst=lay(p.dst), move_axis=p.move_axis,
                kind=p.kind, chunks=p.chunks, steps=steps, nbytes=p.nbytes,
                nv=nv, ib=ib, peak=p.peak_scratch, min_budget=p.min_budget,
                budget=p.budget, spilled=p.spilled, host_dst=p.host_dst,
                h2d=p.nbytes_h2d, d2h=p.nbytes_d2h,
                dst_dev=p.dst_device_bytes, cost=p.cost_model())


PAIRS = [
    ((13, 7), 8, ("s", (3, 4, 6), 0), ("s", (5, 4, 4), 0)),      # ragged
    ((13, 7), 8, ("s", (5, 4, 4), 0), ("s", (3, 2, 2), 1)),      # axis
    ((13, 7), 4, ("s", (4, 3, 3, 3), 0), ("s", (7, 6), 0)),      # 4→2
    ((13, 7), 4, ("s", (7, 6), 0), ("s", (4, 3, 3, 3), 0)),      # 2→4
    ((13, 7), 8, ("s", (4, 3, 3, 3), 0), ("r", 4, "BROADCAST")),
    ((13, 7), 8, ("r", 4, "BROADCAST"), ("s", (2, 2, 2, 1), 1)),
    ((64, 32), 4, ("s", (16, 16, 16, 16), 0), ("s", (8, 8, 8, 8), 1)),
    ((10, 6, 5), 8, ("s", (2, 3, 5), 0), ("s", (2, 2, 2), 1)),
]
# (budget as a multiple of min_budget, None: unbounded; chunks; spill;
# slice_ids; src_host; dst_host)
VARIANTS = [
    (None, None, "auto", None, False, None),
    (3.0, None, "off", None, False, None),
    (1.0, None, "off", [0, 0, 1, 1], False, None),
    (0.5, None, "auto", None, False, None),     # the spill's reason
    (0.5, 3, "on", None, True, False),
]


@pytest.mark.parametrize("v", range(len(VARIANTS)))
@pytest.mark.parametrize("k", range(len(PAIRS)))
def test_plan_equals_jax(k, v):
    shape, item, s, d = PAIRS[k]
    mult, chunks, spill, sids, src_host, dst_host = VARIANTS[v]
    base = trs.plan_reshard(shape, item, _lay("torch", s), _lay("torch", d),
                            budget=None, spill="off")
    budget = None if mult is None else int(base.min_budget * mult)
    kw = dict(budget=budget, chunks=chunks, spill=spill, slice_ids=sids,
              src_host=src_host, dst_host=dst_host)
    try:
        got = _plan_fields(trs.plan_reshard(
            shape, item, _lay("torch", s), _lay("torch", d),
            topo_key="ib2xnvlink2", **kw), "torch")
    except trs.ReshardError as e:
        got = ("refused", e.min_budget, str(e))
    try:
        want = _plan_fields(jrs.plan_reshard(
            shape, item, _lay("jax", s), _lay("jax", d),
            topo_key="dcn2xici2", **kw), "jax")
    except jrs.ReshardError as e:
        want = ("refused", e.min_budget, _port_msg(str(e)))
    assert got == want


def _port_msg(msg):
    """A JAX refusal's message with the port's knob and topology key."""
    return msg.replace("PYLOPS_MPI_TPU_RESHARD_BUDGET",
                       "PYLOPS_MPI_TPU_TORCH_RESHARD_BUDGET").replace(
        "dcn2xici2", "ib2xnvlink2")


@pytest.mark.parametrize("k", range(len(PAIRS)))
def test_refusal_equals_jax(k):
    shape, item, s, d = PAIRS[k]
    base = trs.plan_reshard(shape, item, _lay("torch", s), _lay("torch", d),
                            budget=None, spill="off")
    for spill in ("off", "auto"):
        b = base.min_budget - 1 if spill == "off" else \
            max(1, base.itemsize) // 2
        with pytest.raises(trs.ReshardError) as got:
            trs.plan_reshard(shape, item, _lay("torch", s), _lay("torch", d),
                             budget=b, spill=spill, topo_key="ib2xnvlink2")
        with pytest.raises(jrs.ReshardError) as want:
            jrs.plan_reshard(shape, item, _lay("jax", s), _lay("jax", d),
                             budget=b, spill=spill, topo_key="dcn2xici2")
        assert got.value.min_budget == want.value.min_budget
        assert str(got.value) == _port_msg(str(want.value))


def test_budget_knob_parsing(monkeypatch):
    for raw, want in (("", None), ("8m", 8 << 20), ("2k", 2048),
                      ("1g", 1 << 30), ("4096", 4096)):
        monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_RESHARD_BUDGET", raw)
        monkeypatch.setenv("PYLOPS_MPI_TPU_RESHARD_BUDGET", raw)
        assert trs.reshard_budget() == jrs.reshard_budget() == want
    for bad in ("lots", "-3", "0"):
        monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_RESHARD_BUDGET", bad)
        with pytest.raises(ValueError):
            trs.reshard_budget()


# ------------------------------------------------------------- moves
def _jax_moves(n):
    """The JAX package's results of the moves the ranks make, on a mesh
    of ``n`` devices: global values and local shapes."""
    import pylops_mpi_tpu as pmt
    mesh = jax_mesh(n)
    g = field()
    x = pmt.DistributedArray.to_dist(g, mesh=mesh)
    out = {}

    def rec(name, y):
        out[name] = (np.asarray(y.asarray()), tuple(map(tuple,
                                                        y.local_shapes)))
    rec("redistribute", x.redistribute(1))
    rec("axis_budget", x.reshard(axis=1, budget=BUDGET))
    rag = [(r, 7) for r in ragged(n)]
    xr = pmt.DistributedArray.to_dist(g, mesh=mesh, local_shapes=rag)
    rec("ragged_budget", xr.reshard(budget=BUDGET))
    rec("to_bcast", x.to_partition(JPart.BROADCAST))
    small = jax_mesh(max(1, n // 2))
    s = x.reshard(mesh=small, budget=BUDGET)
    rec("shrink", s)
    rec("grow", s.reshard(mesh=mesh, budget=BUDGET))
    rec("place", jrs.place_replica(g, mesh, budget=BUDGET))
    xs = pmt.DistributedArray.to_dist(g[:2], mesh=mesh)
    rec("short", xs.redistribute(1).redistribute(0))
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = {}
    for n in WORLDS:
        tmp = tmp_path_factory.mktemp(f"reshard{n}")
        out[n] = run_world(reshard_rank, n, tmp, BUDGET,
                           during=lambda n=n: _jax_moves(n))
    return out


def _plan(n, name):
    """The plan the ranks ran for move ``name`` on a world of ``n``."""
    from pylops_mpi_tpu_torch.parallel.partition import local_split
    sh = field().shape

    def bal(m, ax):
        return tuple(s[ax] for s in local_split(sh, m, TPart.SCATTER, ax))
    L = trs.Layout
    src = L.scatter(bal(n, 0), 0)
    half = max(1, n // 2)
    spec = {
        "redistribute": (src, L.scatter(bal(n, 1), 1), None),
        "axis_budget": (src, L.scatter(bal(n, 1), 1), BUDGET),
        "ragged_budget": (L.scatter(tuple(ragged(n)), 0), src, BUDGET),
        "to_bcast": (src, L.replicated(n), None),
        "shrink": (src, L.scatter(bal(half, 0), 0), BUDGET),
        "grow": (L.scatter(bal(half, 0), 0), src, BUDGET),
        "spill_on": (src, L.scatter(bal(n, 1), 1), BUDGET),
    }[name]
    return trs.plan_reshard(sh, 8, spec[0], spec[1], budget=spec[2],
                            spill="on" if name == "spill_on" else "off")


def _column(plan, r):
    """Bytes the plan has shard ``r`` of the destination receive."""
    g = field()
    B = trs._pair_bytes(g.size * 8, plan.src, plan.dst, plan.move_axis,
                        g.shape, 8)
    np.fill_diagonal(B, 0.0)
    if r >= B.shape[1]:
        return 0
    return int(round(B[:, r].sum()))


MOVES = ("redistribute", "axis_budget", "ragged_budget", "to_bcast",
         "shrink", "grow", "place", "short")


@pytest.mark.parametrize("name", MOVES)
@pytest.mark.parametrize("n", WORLDS)
def test_move_matches_jax(worlds, n, name):
    ranks, ref = worlds[n]
    want, want_shapes = ref[name]
    g = field()
    np.testing.assert_array_equal(want, g[:2] if name == "short" else g)
    for r, out in enumerate(ranks):
        rec = out[name]
        if rec["member"]:
            assert rec["value"].tobytes() == want.tobytes()
            assert rec["local_shape"] == want_shapes[r]
        else:
            # off the mesh: zero rows, the same metadata
            assert rec["local_shape"][0] == 0
        assert rec["max_scratch"] <= BUDGET or name in (
            "redistribute", "to_bcast", "short")


@pytest.mark.parametrize("name", ("redistribute", "axis_budget",
                                  "ragged_budget", "to_bcast", "shrink",
                                  "grow"))
@pytest.mark.parametrize("n", WORLDS)
def test_move_bytes_and_exchanges_match_plan(worlds, n, name):
    ranks, _ = worlds[n]
    plan = _plan(n, name)
    kind = plan.kind
    for r, out in enumerate(ranks):
        rec = out[name]
        assert rec["received"].get(kind, 0) == _column(plan, r), (r, rec)
        assert rec["counts"] == {kind: plan.chunks}, rec["counts"]
    if name == "redistribute":
        assert plan.chunks == 1 and kind == "all_to_all"


@pytest.mark.parametrize("n", WORLDS)
def test_spilled_move_overlap_and_staging(worlds, n):
    ranks, _ = worlds[n]
    plan = _plan(n, "spill_on")
    assert plan.spilled
    g = field()
    for ov in ("on", "off"):
        d2h = h2d = 0
        for out in ranks:
            rec = out[f"spill_{ov}"]
            assert rec["value"].tobytes() == g.tobytes()
            c = rec["counters"]
            d2h += c.get("collective.reshard.bytes_d2h", 0)
            h2d += c.get("collective.reshard.bytes_h2d", 0)
            assert "collective.reshard.bytes" not in c
            assert rec["n_steps"] == plan.chunks
        assert (d2h, h2d) == (plan.nbytes_d2h, plan.nbytes_h2d)


@pytest.mark.parametrize("n", WORLDS)
def test_refusal_in_world_names_minimum(worlds, n):
    ranks, _ = worlds[n]
    sh = field().shape
    want = jrs.plan_reshard(
        sh, 8, jrs.Layout.scatter(
            [s[0] for s in jrs.local_split(sh, n, JPart.SCATTER, 0)], 0),
        jrs.Layout.scatter(
            [s[1] for s in jrs.local_split(sh, n, JPart.SCATTER, 1)], 1),
        budget=None, spill="off").min_budget
    for out in ranks:
        mb, msg = out["refused"]
        assert mb == want and f"at least {want}" in msg


@pytest.mark.parametrize("n", WORLDS)
def test_moves_refuse_a_gradient(worlds, n):
    """Under grad mode, a move of an array that requires grad raises
    rather than hand back pieces cut from the graph, naming the ROADMAP
    item that owes the adjoint, as ``collectives.all_to_all`` does;
    outside grad mode the move runs."""
    ranks, _ = worlds[n]
    for out in ranks:
        res = dict(out["grad"])
        assert res.pop("no_grad") is True
        for name, msg in res.items():
            assert msg is not None, name
            assert "no autograd rule" in msg and "item 6" in msg, msg


def test_world_of_one_move_keeps_the_gradient():
    """Without a process group a move copies the rank's own rows, which
    keep their gradient (as ``redistribute`` did before the planner)."""
    g = field()
    x = pmtt.DistributedArray.to_dist(g, device="cpu")
    x.array.requires_grad_(True)
    y = x.redistribute(1)
    (gx,) = torch.autograd.grad(torch.sum(y.array * 2.0), x.array)
    np.testing.assert_array_equal(gx.numpy(), np.full(g.shape, 2.0))
