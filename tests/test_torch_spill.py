"""The port's host spill tier held against the JAX package.

In one process: ``to_host`` and back with overlap ``on`` and ``off``
bitwise equal to each other and to the JAX package's round trip of the
same data, the bytes staged (``collective.reshard.bytes_d2h``/
``.bytes_h2d``) equal to the plan's, the plan itself equal to JAX's,
the spill knob's parsing, the banked chunk and overlap hints, and the
kill seams' counters (one spill step a staged chunk) and their SIGKILL
in a child process.

Across ranks: one gloo world of 3 (a ragged split of an (11, 6) f64
field): ``to_host`` with overlap on and off (each rank parks its own
shard), ``to_device`` plain and host-staged, and a move from the host
to the other axis, each gathered value bitwise equal to JAX's and the
staged bytes summed over the ranks equal to the plan's.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import pylops_mpi_tpu_torch as pmtt
from pylops_mpi_tpu_torch.diagnostics import metrics
from pylops_mpi_tpu_torch.parallel import reshard as trs
from pylops_mpi_tpu_torch.parallel import spill as tsp
from pylops_mpi_tpu_torch.parallel.partition import Partition as TPart
from pylops_mpi_tpu_torch.resilience import faults
from pylops_mpi_tpu_torch.utils import deps

from test_torch_process_group import jax_mesh, run_world
from torch_reshard_ranks import field, ragged, spill_rank

BUDGET = 100  # bytes: two 48-byte rows of the (11, 6) f64 field
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _metrics_on(monkeypatch):
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_METRICS", "on")
    metrics.clear_metrics()
    yield
    metrics.clear_metrics()


def _counter(name):
    return metrics.snapshot()["counters"].get(name, 0)


@pytest.mark.parametrize("overlap", ["on", "off"])
def test_round_trip_matches_jax(overlap):
    import pylops_mpi_tpu as pmt
    from pylops_mpi_tpu.parallel import spill as jsp
    g = field((11, 6), seed=1)
    x = pmtt.DistributedArray.to_dist(g, device="cpu")
    h = x.to_host(budget=BUDGET, overlap=overlap)
    plan = trs.plan_reshard(g.shape, 8, trs._layout_of(x),
                            trs._layout_of(x), budget=BUDGET, spill="on",
                            dst_host=True)
    assert plan.spilled and plan.chunks == 6
    assert _counter("collective.reshard.bytes_d2h") == plan.nbytes_d2h
    assert _counter("collective.reshard.bytes_h2d") == plan.nbytes_h2d == 0
    back = h.to_device(budget=BUDGET, spill="on", overlap=overlap)
    assert _counter("collective.reshard.bytes_h2d") == g.nbytes
    jx = pmt.DistributedArray.to_dist(g, mesh=jax_mesh(1))
    jh = jsp.to_host(jx, budget=BUDGET, overlap=overlap)
    jback = jh.to_device(budget=BUDGET)
    for got in (h.asarray(), back.asarray()):
        assert got.tobytes() == np.asarray(jh.asarray()).tobytes()
        assert got.tobytes() == np.asarray(jback.asarray()).tobytes()
    assert isinstance(h, tsp.HostArray) and h.local.shape == g.shape
    assert back.local_shapes == tuple(map(tuple, jback.local_shapes))


def test_overlap_on_off_bitwise_and_plan_equals_jax():
    from pylops_mpi_tpu.parallel import reshard as jrs
    g = field((11, 6), seed=1).astype(np.float32)
    x = pmtt.DistributedArray.to_dist(g, device="cpu")
    hs = [x.to_host(budget=BUDGET, overlap=ov).local for ov in ("on", "off")]
    assert torch.equal(hs[0], hs[1])
    got = trs.plan_reshard(g.shape, 4, trs._layout_of(x), trs._layout_of(x),
                           budget=BUDGET, spill="on", dst_host=True)
    want = jrs.plan_reshard(g.shape, 4, jrs.Layout.scatter((11,), 0),
                            jrs.Layout.scatter((11,), 0), budget=BUDGET,
                            spill="on", dst_host=True)
    assert [(s.lo, s.hi, s.nbytes_d2h, s.nbytes_h2d, s.scratch_bytes)
            for s in got.steps] == [(s.lo, s.hi, s.nbytes_d2h, s.nbytes_h2d,
                                     s.scratch_bytes) for s in want.steps]
    assert (got.min_budget, got.nbytes_d2h, got.host_dst) == \
        (want.min_budget, want.nbytes_d2h, want.host_dst)


def test_over_budget_destination_stays_on_host():
    g = field((11, 6), seed=1)
    x = pmtt.DistributedArray.to_dist(g, device="cpu")
    # 48-byte rows: a budget of one row spills, and the 528-byte
    # destination does not fit it, so it stays in host RAM
    out = trs.reshard(x, partition=TPart.BROADCAST, budget=48, spill="on")
    assert isinstance(out, tsp.HostArray)
    assert out.asarray().tobytes() == g.tobytes()
    # on one rank the move is local: it needs one row, not two
    assert not isinstance(trs.reshard(x, partition=TPart.BROADCAST,
                                      budget=48), tsp.HostArray)
    with pytest.raises(trs.ReshardError, match="at least 48"):
        trs.reshard(x, partition=TPart.BROADCAST, budget=20)


def test_spill_mode_matches_jax(monkeypatch):
    from pylops_mpi_tpu.utils import deps as jdeps
    for raw in ("", "auto", "on", "OFF", "default"):
        monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_SPILL", raw)
        monkeypatch.setenv("PYLOPS_MPI_TPU_SPILL", raw)
        assert deps.spill_mode() == jdeps.spill_mode()
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_SPILL", "sideways")
    monkeypatch.setattr(deps, "_warned_spill", False)
    with pytest.warns(UserWarning, match="PYLOPS_MPI_TPU_TORCH_SPILL"):
        assert deps.spill_mode() == "auto"


def test_tuned_chunks_and_overlap(tmp_path, monkeypatch):
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_TUNE_CACHE",
                       str(tmp_path / "plans.json"))
    assert tsp.chunk_hint_spill(11, 1) is None  # tuning off
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_TUNE", "on")
    assert tsp.chunk_hint_spill(11, 1) is None  # nothing banked
    tsp.record_spill_plan(11, 1, chunks=4, overlap="off",
                          path=str(tmp_path / "plans.json"))
    assert tsp.chunk_hint_spill(11, 1) == 4
    assert tsp.overlap_hint_spill(11, 1) == "off"
    plan = trs.plan_reshard((11, 6), 8, trs.Layout.scatter((11,)),
                            trs.Layout.scatter((11,)), budget=None,
                            spill="on", dst_host=True)
    assert plan.chunks == 4
    with pytest.raises(ValueError, match="overlap"):
        tsp._resolve_overlap("sideways", 11, 1)


def test_kill_seams_count_steps():
    g = field((11, 6), seed=1)
    x = pmtt.DistributedArray.to_dist(g, device="cpu")
    faults.reset_spill_steps()
    faults.reset_reshard_steps()
    x.to_host(budget=BUDGET)
    assert faults.spill_steps() == 6 and faults.reshard_steps() == 6
    faults.reset_reshard_steps()
    x.reshard(axis=1, budget=2 * 88)  # 88-byte rows of axis 1: 2 a chunk
    plan = trs.plan_reshard(g.shape, 8, trs._layout_of(x),
                            trs.Layout.scatter((6,), 1), budget=2 * 88,
                            spill="off")
    assert faults.reshard_steps() == len(plan.steps) == plan.chunks == 3


def test_kill_seam_sigkills():
    code = ("import os, sys; sys.path.insert(0, %r)\n"
            "import numpy as np, pylops_mpi_tpu_torch as pmtt\n"
            "x = pmtt.DistributedArray.to_dist(np.ones((8, 2)), device='cpu')\n"
            "x.to_host(budget=32)\n"
            "print('survived')\n" % ROOT)
    env = dict(os.environ, PYLOPS_MPI_TPU_TORCH_FAULT_KILL_SPILL="2")
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == -9 and "survived" not in r.stdout


# ------------------------------------------------------------- ranks
@pytest.fixture(scope="module")
def world3(tmp_path_factory):
    def jax_side():
        import pylops_mpi_tpu as pmt
        from pylops_mpi_tpu.parallel import reshard as jrs
        from pylops_mpi_tpu.parallel import spill as jsp
        g = field((11, 6), seed=1)
        rag = [(r, 6) for r in ragged(3, 11)]
        x = pmt.DistributedArray.to_dist(g, mesh=jax_mesh(3),
                                         local_shapes=rag)
        h = jsp.to_host(x, budget=BUDGET)
        moved = jrs.reshard(h, axis=1, budget=BUDGET, spill="on")
        return {"host": np.asarray(h.asarray()),
                "device": np.asarray(h.to_device(budget=BUDGET).asarray()),
                "axis1": np.asarray(moved.asarray()),
                "axis1_shapes": tuple(map(tuple, moved.local_shapes))}
    return run_world(spill_rank, 3, tmp_path_factory.mktemp("spill3"),
                     BUDGET, during=jax_side)


@pytest.mark.parametrize("name,ref", [
    ("to_host_on", "host"), ("to_host_off", "host"),
    ("to_device", "device"), ("to_device_spilled", "device"),
    ("from_host_axis1", "axis1")])
def test_ranks_match_jax(world3, name, ref):
    ranks, want = world3
    for r, out in enumerate(ranks):
        assert out[name]["value"].tobytes() == want[ref].tobytes()
        if name == "from_host_axis1":
            assert out[name]["local_shape"] == want["axis1_shapes"][r]
    assert all(out["host_local_equal"] for out in ranks)


def _rank_plan(name):
    """The plan the ranks ran for ``name`` (host math, one for every
    rank)."""
    from pylops_mpi_tpu_torch.parallel.partition import local_split
    sh = (11, 6)
    src = trs.Layout.scatter(tuple(ragged(3, 11)), 0)
    ax1 = trs.Layout.scatter(tuple(s[1] for s in local_split(
        sh, 3, TPart.SCATTER, 1)), 1)
    if name.startswith("to_host"):
        return trs.plan_reshard(sh, 8, src, src, budget=BUDGET, spill="on",
                                dst_host=True)
    dst = ax1 if name == "from_host_axis1" else src
    return trs.plan_reshard(sh, 8, trs.Layout.replicated(1), dst,
                            budget=BUDGET, spill="on", src_host=True,
                            dst_host=None if name == "from_host_axis1"
                            else False)


@pytest.mark.parametrize("name", ["to_host_on", "to_host_off",
                                  "to_device_spilled", "from_host_axis1"])
def test_ranks_staging_sums_to_plan(world3, name):
    ranks, _ = world3
    plan = _rank_plan(name)
    got_d = sum(o[name]["counters"].get("collective.reshard.bytes_d2h", 0)
                for o in ranks)
    got_h = sum(o[name]["counters"].get("collective.reshard.bytes_h2d", 0)
                for o in ranks)
    assert (got_d, got_h) == (plan.nbytes_d2h, plan.nbytes_h2d)
    # the host-to-host move (its destination over budget) stages nothing
    total = field((11, 6), seed=1).nbytes
    assert plan.spilled and got_d + got_h == (
        0 if name == "from_host_axis1" else total)
    for o in ranks:
        assert o[name]["max_scratch"] <= BUDGET
