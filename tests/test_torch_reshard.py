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

Gradients (the same worlds): the gradient of ``Σ W·y`` (seeded weights)
through each move of an array that requires grad, through ``ghosted`` on
even and ragged splits and through a custom operator decorated with
``reshaped`` (with and without ``stacking``), equal to ``jax.grad``
through the JAX package's on a mesh of as many devices (1e-12: a move's
sums add at most three terms), the adjoint test of each at 1e-12, and
the backward of a redistribute an ``all_to_all_adjoint`` per chunk of
the inverse plan that receives what the forward sent.
``place_replica``, ``to_host`` and a move onto a smaller world still
refuse. ``ghosted`` and ``reshaped`` values and local shapes, and the
plots of ``plotting`` (image arrays and titles, Agg backend), equal the
JAX package's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pylops_mpi_tpu as pmt
import pylops_mpi_tpu.parallel.reshard as jrs
from pylops_mpi_tpu.utils import decorators as jdecorators
from pylops_mpi_tpu.parallel.partition import Partition as JPart
import pylops_mpi_tpu_torch as pmtt
from pylops_mpi_tpu_torch.parallel import reshard as trs
from pylops_mpi_tpu_torch.parallel.partition import Partition as TPart

from test_torch_process_group import close, jax_mesh, run_world
from torch_reshard_ranks import (field, ragged, reshard_rank,
                                 stacking_shapes, weights)

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


class JRowSum(pmt.MPILinearOperator):
    """``torch_reshard_ranks.RowSum`` in the JAX package."""

    def __init__(self, dims):
        self.dims = self.dimsd = tuple(dims)
        n = int(np.prod(dims))
        super().__init__(shape=(n, n), dtype=np.float64)

    @jdecorators.reshaped
    def _matvec(self, x):
        return pmt.DistributedArray._wrap(jnp.cumsum(x._arr, axis=1), x)

    @jdecorators.reshaped
    def _rmatvec(self, x):
        rev = jnp.flip(jnp.cumsum(jnp.flip(x._arr, 1), axis=1), 1)
        return pmt.DistributedArray._wrap(rev, x)


class JRowScale(pmt.MPILinearOperator):
    """``torch_reshard_ranks.RowScale`` in the JAX package."""

    def __init__(self, size, n):
        self.local_shapes_m = self.local_shapes_n = tuple(
            stacking_shapes(size, n))
        super().__init__(shape=(size, size), dtype=np.float64)

    def _scale(self, x):
        w = np.arange(1.0, x.global_shape[0] + 1)
        return x * pmt.DistributedArray.to_dist(
            w, mesh=x.mesh, local_shapes=x.local_shapes)

    @jdecorators.reshaped(stacking=True)
    def _matvec(self, x):
        return self._scale(x)

    @jdecorators.reshaped(stacking=True)
    def _rmatvec(self, x):
        return self._scale(x)


def _jax_grads(n):
    """``jax.grad`` of ``Σ W·y`` through the JAX package's counterpart of
    every gradient case of ``torch_reshard_ranks.grad_rank``, each
    gradient as its shards; ``ghosted``'s and ``reshaped``'s values."""
    import jax
    J = pmt.DistributedArray
    mesh = jax_mesh(n)
    g = field()
    rag = [(r, 7) for r in ragged(n)]

    def grad(x, fn):
        """The gradient's shards, and ``fn(x)`` (one compile of both)."""
        seen = []

        def loss(a):
            y = fn(J._wrap(a, x))
            seen.append(y)
            w = jnp.asarray(weights(y.global_shape))
            return jnp.sum(w * y.array), y._arr
        (_, arr), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            x._arr)
        return J._wrap(g, x).local_arrays(), J._wrap(arr, seen[0])

    out = {}
    for name, x, fn in (
            ("redistribute", J.to_dist(g, mesh=mesh),
             lambda x: x.redistribute(1)),
            ("axis_budget", J.to_dist(g, mesh=mesh),
             lambda x: x.reshard(axis=1, budget=BUDGET)),
            ("ragged_budget", J.to_dist(g, mesh=mesh, local_shapes=rag),
             lambda x: x.reshard(budget=BUDGET)),
            ("to_bcast", J.to_dist(g, mesh=mesh),
             lambda x: x.to_partition(JPart.BROADCAST)),
            ("from_bcast", J.to_dist(g, mesh=mesh,
                                     partition=JPart.BROADCAST),
             lambda x: x.to_partition(JPart.SCATTER, 1)),
            ("short", J.to_dist(g[:2], mesh=mesh),
             lambda x: x.redistribute(1).redistribute(0)),
            ("ghosted", J.to_dist(g, mesh=mesh), lambda x: x.ghosted(2, 1)),
            ("ghosted_ragged", J.to_dist(g, mesh=mesh, local_shapes=rag),
             lambda x: x.ghosted(1, 1)),
            ("reshaped", J.to_dist(g.ravel(), mesh=mesh),
             lambda x: JRowSum(g.shape).matvec(x)),
            ("reshaped_stacking", J.to_dist(g.ravel(), mesh=mesh),
             lambda x: JRowScale(g.size, n).matvec(x))):
        gx, y = grad(x, fn)
        out[name] = dict(grad=gx)
        if name.startswith("ghosted"):
            out[name].update(value=y.local_arrays(),
                             local_shapes=y.local_shapes,
                             global_shape=y.global_shape)
    for name, op in (("reshaped", JRowSum(g.shape)),
                     ("reshaped_stacking", JRowScale(g.size, n))):
        x = J.to_dist(g.ravel(), mesh=mesh)
        y, xa = op.matvec(x), op.rmatvec(x)
        out[name].update(value=y.asarray(), adjoint_value=xa.asarray(),
                         local_shapes=(y.local_shapes, xa.local_shapes))
    return out


def _jax_plots(n):
    """``_plot_rank``'s plots of the JAX package's arrays."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from pylops_mpi_tpu import plotting
    mesh = jax_mesh(n)
    g = field()
    out = {}
    for name, arr in (("2d", pmt.DistributedArray.to_dist(g, mesh=mesh)),
                      ("1d", pmt.DistributedArray.to_dist(
                          g.ravel(), mesh=mesh,
                          local_shapes=[(7 * r,) for r in ragged(n)]))):
        for kind, fn in (("layout", plotting.plot_distributed_array),
                         ("locals", plotting.plot_local_arrays)):
            fig, axs = fn(arr)
            out[f"{kind}_{name}"] = [
                (np.asarray(ax.images[0].get_array()), ax.get_title())
                for ax in np.atleast_1d(axs)]
            plt.close(fig)
    return out


def _jax_reference(n):
    return dict(_jax_moves(n), grads=_jax_grads(n), plots=_jax_plots(n))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = {}
    for n in WORLDS:
        tmp = tmp_path_factory.mktemp(f"reshard{n}")
        out[n] = run_world(reshard_rank, n, tmp, BUDGET,
                           during=lambda n=n: _jax_reference(n))
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


GRAD_CASES = ("redistribute", "axis_budget", "ragged_budget", "to_bcast",
              "from_bcast", "short", "ghosted", "ghosted_ragged", "reshaped",
              "reshaped_stacking")


@pytest.mark.parametrize("n", WORLDS)
def test_moves_refuse_a_gradient(worlds, n):
    """Moves that the JAX package differentiates carry the gradient now
    (their rule ported): each rank's gradient is its shard of
    ``jax.grad``'s (the whole of it for a BROADCAST source), and each
    passes the adjoint test. Those it stages through numpy, and a move
    between device sets, which ``jax.grad`` refuses under its trace,
    still refuse, saying so."""
    ranks, ref = worlds[n]
    for r, out in enumerate(ranks):
        res = out["grad"]
        for name in GRAD_CASES:
            close(res[name]["grad"], ref["grads"][name]["grad"][r], 1e-12)
            lhs, rhs = res[name]["adjoint"]
            assert rhs == pytest.approx(lhs, rel=1e-12), name
        msgs = res["refused"]
        assert "JAX package stages it through numpy" in msgs["to_host"]
        assert "JAX package stages the value through numpy" in \
            msgs["place_replica"]
        if n > 1:
            assert "between device sets" in msgs["shrink"]
        assert not any("item 6" in m for m in msgs.values() if m)


@pytest.mark.parametrize("name", ("redistribute", "axis_budget"))
@pytest.mark.parametrize("n", WORLDS)
def test_move_gradient_runs_the_inverse_plan(worlds, n, name):
    """The backward of an axis change is the inverse plan's chunks, each
    an ``all_to_all_adjoint`` exchange, and every rank receives in it
    the bytes it sent in the forward."""
    ranks, _ = worlds[n]
    plan = _plan(n, name)
    inverse = trs.plan_reshard(field().shape, 8, plan.dst, plan.src,
                               budget=plan.budget, spill="off")
    B = trs._pair_bytes(field().size * 8, plan.src, plan.dst,
                        plan.move_axis, field().shape, 8)
    np.fill_diagonal(B, 0.0)
    for r, out in enumerate(ranks):
        fwd, bwd = (out["grad"][name][k] for k in ("fwd", "bwd"))
        assert fwd[0]["all_to_all"] == plan.chunks
        assert bwd[0] == {"all_to_all_adjoint": inverse.chunks}
        assert bwd[1]["all_to_all_adjoint"] == int(round(B[r, :].sum()))


@pytest.mark.parametrize("n", WORLDS)
def test_ghosted_matches_jax(worlds, n):
    """``ghosted`` on the balanced and a ragged split: each shard, the
    local shapes and the global shape are the JAX package's."""
    ranks, ref = worlds[n]
    for name in ("ghosted", "ghosted_ragged"):
        want = ref["grads"][name]
        for r, out in enumerate(ranks):
            got = out["grad"][name]
            assert got["local_shapes"] == want["local_shapes"]
            assert got["global_shape"] == want["global_shape"]
            np.testing.assert_array_equal(got["value"], want["value"][r])


@pytest.mark.parametrize("n", WORLDS)
def test_reshaped_matches_jax(worlds, n):
    """A custom operator decorated with ``reshaped`` in each package,
    with and without ``stacking``: forward and adjoint values and the
    output splits."""
    ranks, ref = worlds[n]
    for name in ("reshaped", "reshaped_stacking"):
        want = ref["grads"][name]
        for out in ranks:
            got = out["grad"][name]
            close(got["value"], want["value"])
            close(got["adjoint_value"], want["adjoint_value"])
            assert got["local_shapes"] == want["local_shapes"]


@pytest.mark.parametrize("n", WORLDS)
def test_plots_match_jax(worlds, n):
    """Every rank draws the JAX package's figures: the same images and
    titles, every shard's panel on every rank."""
    ranks, ref = worlds[n]
    want = ref["plots"]
    for out in ranks:
        got = out["plots"]
        assert sorted(got) == sorted(want)
        for key, panels in want.items():
            assert len(got[key]) == len(panels), key
            for (gi, gt), (wi, wt) in zip(got[key], panels):
                assert gt == wt
                np.testing.assert_array_equal(gi, wi)


def test_world_of_one_move_keeps_the_gradient():
    """Without a process group a move copies the rank's own rows, which
    keep their gradient (as ``redistribute`` did before the planner)."""
    g = field()
    x = pmtt.DistributedArray.to_dist(g, device="cpu")
    x.array.requires_grad_(True)
    y = x.redistribute(1)
    (gx,) = torch.autograd.grad(torch.sum(y.array * 2.0), x.array)
    np.testing.assert_array_equal(gx.numpy(), np.full(g.shape, 2.0))
