"""The port's in-place elastic recovery held against the JAX package.

In one process: the mode knob and its arming, the quorum knob, the
reconfig file's lifecycle (torn, stale, consumed), ``reform_mesh``
(several survivors refuse, one detaches to a world of one), the
segmented solve's poll (``ElasticReconfig`` at an epoch boundary) and
bank (before the checkpoint), and ``cgls_segmented(normal=True)`` bit
for bit the fused ``cgls(normal=True)``.

A gloo world of 2 (spawned once) banks a carry of every field kind and
writes a checkpoint with both backends; here, as the survivor's world of
one, the bank is restored (bitwise the JAX package's ``restore_carry``
of the same banked values), its refusals raise (a stacked vector, a mask
across worlds, a budget under one row), and the budgeted checkpoint
restore (``PYLOPS_MPI_TPU_TORCH_RESHARD_BUDGET``, plain and host-staged)
is bitwise the unbudgeted one.

Supervised jobs (workers run ``tests/torch_resilience_ranks.py``, torch
and the port only): a job without ``inplace`` drops an outer job's
reconfig assignment, ``inplace=True`` hands a lone survivor its
reconfig; two gloo workers on the JAX elastic worker's
problem (8 blocks of 24x24, f64, 60 iterations, epochs of 5), one
SIGKILLed mid-solve, the survivor finishing in place with no checkpoint
read in its trace and x within 1e-10 relative of the JAX package's
uninterrupted ``cgls_segmented``; a 3-worker job that loses one falls
back to the relaunch; and a survivor SIGKILLed by the reshard seam
(``PYLOPS_MPI_TPU_TORCH_FAULT_KILL_RESHARD=1``) leads to the relaunch,
which finishes from the checkpoint.
"""

import json
import os
import signal
import sys

import numpy as np
import pytest
import torch

import pylops_mpi_tpu_torch as pmtt
from pylops_mpi_tpu_torch.diagnostics import trace
from pylops_mpi_tpu_torch.parallel import mesh as tmesh
from pylops_mpi_tpu_torch.parallel import reshard as trs
from pylops_mpi_tpu_torch.resilience import elastic
from pylops_mpi_tpu_torch.resilience.elastic import worker_config
from pylops_mpi_tpu_torch.resilience.supervisor import launch_job
from pylops_mpi_tpu_torch.solvers.segmented import cgls_segmented
from pylops_mpi_tpu_torch.utils import checkpoint as ckpt

from test_torch_process_group import jax_mesh, run_world
from torch_reshard_ranks import bank_rank, field
from torch_resilience_ranks import chaos_problem

HERE = os.path.dirname(os.path.abspath(__file__))
P = "PYLOPS_MPI_TPU_TORCH_"
_ENV = tuple(P + k for k in (
    "INPLACE", "QUORUM", "RECONFIG_FILE", "NUM_PROCESSES", "PROCESS_ID",
    "ATTEMPT", "COORDINATOR", "HEARTBEAT_FILE", "RESHARD_BUDGET", "SPILL",
    "TRACE"))


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in _ENV:
        # set first, so that teardown restores the variable even when a
        # test (apply_reconfig) writes it directly
        monkeypatch.setenv(name, "")
        monkeypatch.delenv(name)
    elastic.clear_carry()
    yield
    elastic.clear_carry()
    elastic.stop_heartbeat()


# ------------------------------------------------------------- knobs
def test_inplace_mode_and_arming(monkeypatch):
    assert elastic.inplace_mode() == "auto"
    assert not elastic.inplace_armed()
    monkeypatch.setenv(P + "RECONFIG_FILE", "/tmp/rc.json")
    assert elastic.inplace_armed()
    # the mode is the supervisor's switch (test_launch_job_reads_the_
    # knobs); a worker is armed by its reconfig file alone
    for m in ("off", "on"):
        monkeypatch.setenv(P + "INPLACE", m)
        assert elastic.inplace_mode() == m and elastic.inplace_armed()
    monkeypatch.delenv(P + "RECONFIG_FILE")
    assert not elastic.inplace_armed()
    monkeypatch.setenv(P + "INPLACE", "sideways")
    monkeypatch.setattr(elastic, "_warned_ip", False)
    with pytest.warns(UserWarning, match=P + "INPLACE"):
        assert elastic.inplace_mode() == "auto"


def test_quorum_fraction_matches_jax(monkeypatch):
    from pylops_mpi_tpu.resilience import elastic as jel
    for raw in ("0.5", "0.75", "7", "junk", "0", "-1"):
        monkeypatch.setenv(P + "QUORUM", raw)
        monkeypatch.setenv("PYLOPS_MPI_TPU_QUORUM", raw)
        assert elastic.quorum_fraction() == jel.quorum_fraction()


def test_pending_reconfig_lifecycle(tmp_path, monkeypatch):
    rcf = str(tmp_path / "rc.json")
    monkeypatch.setenv(P + "RECONFIG_FILE", rcf)
    assert elastic.pending_reconfig() is None
    with open(rcf, "w") as f:
        f.write("{not json")
    assert elastic.pending_reconfig() is None
    with open(rcf, "w") as f:
        json.dump({"attempt": 0}, f)
    assert elastic.pending_reconfig() is None
    doc = {"attempt": 1, "num_processes": 1, "process_id": 0,
           "coordinator": None, "lost_slot": 1}
    with open(rcf, "w") as f:
        json.dump(doc, f)
    assert elastic.pending_reconfig() == doc
    cfg = elastic.apply_reconfig(doc)
    assert (cfg.num_processes, cfg.process_id, cfg.attempt) == (1, 0, 1)
    assert elastic.pending_reconfig() is None


def test_reform_mesh(monkeypatch):
    monkeypatch.setenv(P + "NUM_PROCESSES", "2")
    with pytest.raises(RuntimeError, match="checkpoint"):
        elastic.reform_mesh(worker_config())
    monkeypatch.setenv(P + "NUM_PROCESSES", "1")
    monkeypatch.setattr(tmesh, "_DETACHED", False)
    m = elastic.reform_mesh(worker_config(), device="cpu")
    assert (m.size, m.rank, m.group, m.device) == (1, 0, None,
                                                   torch.device("cpu"))
    assert not tmesh.initialized() and tmesh.world_size() == 1


# ------------------------------------------------- the segmented solve
def _small(device="cpu"):
    return chaos_problem(device)


def test_normal_segmented_is_fused_normal_and_refuses_other_schedule(
        tmp_path):
    Op, y = _small()
    fused = pmtt.cgls(Op, y, niter=20, tol=0.0, normal=True)[0]
    path = str(tmp_path / "carry")
    seg = cgls_segmented(Op, y, niter=20, tol=0.0, epoch=6, normal=True,
                         checkpoint_path=path)
    assert torch.equal(seg.x.array, fused.array) and seg.epochs == 4
    with pytest.raises(ValueError, match="normal"):
        cgls_segmented(Op, y, niter=20, tol=0.0, epoch=6,
                       checkpoint_path=path)


def test_armed_solve_banks_before_checkpoint_and_polls(tmp_path,
                                                        monkeypatch):
    Op, y = _small()
    rcf = str(tmp_path / "rc.json")
    monkeypatch.setenv(P + "RECONFIG_FILE", rcf)
    monkeypatch.setenv(P + "TRACE", "spans")
    trace.clear_events()
    seen = []

    def on_epoch(info):
        rec = elastic.banked_carry("cgls")
        seen.append(int(rec["fields"]["iiter"]["value"]))
        if info["epoch"] == 2:
            with open(rcf, "w") as f:
                json.dump({"attempt": 1, "num_processes": 1,
                           "process_id": 0, "coordinator": None}, f)

    with pytest.raises(elastic.ElasticReconfig) as rc:
        cgls_segmented(Op, y, niter=60, tol=0.0, epoch=5,
                       checkpoint_path=str(tmp_path / "carry"),
                       on_epoch=on_epoch)
    assert seen == [5, 10] and rc.value.config["attempt"] == 1
    names = [e["name"] for e in trace.get_events()]
    banks = [i for i, n in enumerate(names)
             if n == "resilience.carry_banked"]
    saves = [i for i, n in enumerate(names) if n == "solver.checkpoint"]
    assert len(banks) == len(saves) == 2
    assert all(b < s for b, s in zip(banks, saves))
    # resuming from the bank replays the uninterrupted solve bit for bit
    monkeypatch.setenv(P + "ATTEMPT", "1")  # the reconfig is consumed
    state = elastic.restore_carry("cgls", device="cpu")
    res = cgls_segmented(Op, y, niter=60, tol=0.0, epoch=5, resume=False,
                         resume_state=state)
    ref = cgls_segmented(Op, y, niter=60, tol=0.0, epoch=5)
    assert torch.equal(res.x.array, ref.x.array) and res.epochs == 10


# ------------------------------------------------- bank and checkpoints
@pytest.fixture(scope="module")
def banked(tmp_path_factory):
    d = tmp_path_factory.mktemp("bank2")
    recs = run_world(bank_rank, 2, d, str(d))
    return recs, str(d)


def _jax_restore():
    """The JAX package's ``restore_carry`` of the same banked values
    (banked on a mesh of 2 devices, restored on 1)."""
    import jax.numpy as jnp
    import pylops_mpi_tpu as pmt
    from pylops_mpi_tpu.parallel.partition import Partition as JP
    from pylops_mpi_tpu.resilience import elastic as jel
    g = field((9, 4), seed=2)
    m2 = jax_mesh(2)
    jel.bank_carry("cgls", {
        "x": pmt.DistributedArray.to_dist(g, mesh=m2),
        "b": pmt.DistributedArray.to_dist(g[0], mesh=m2,
                                          partition=JP.BROADCAST),
        "kold": jnp.asarray([3.5]), "iiter": jnp.asarray([7]),
        "niter": 60, "tol": 0.0})
    try:
        return jel.restore_carry("cgls", jax_mesh(1))
    finally:
        jel.clear_carry("cgls")


def test_restore_every_field_kind_matches_jax(banked):
    recs, _ = banked
    # both ranks banked the same whole values
    r0, r1 = recs[0]["cgls"]["fields"], recs[1]["cgls"]["fields"]
    assert torch.equal(r0["x"]["value"], r1["x"]["value"])
    elastic._BANK["cgls"] = recs[0]["cgls"]
    got = elastic.restore_carry("cgls", device="cpu")
    want = _jax_restore()
    for k in ("x", "b"):
        assert got[k].asarray().tobytes() == \
            np.asarray(want[k].asarray()).tobytes()
        assert got[k].local_shapes == tuple(map(tuple,
                                                want[k].local_shapes))
        assert got[k].partition.name == want[k].partition.name
    assert float(got["kold"][0]) == float(np.asarray(want["kold"])[0])
    assert int(got["iiter"][0]) == int(np.asarray(want["iiter"])[0])
    assert got["iiter"].dtype == torch.int64
    assert (got["niter"], got["tol"]) == (want["niter"], want["tol"])


def test_restore_refusals(banked, monkeypatch):
    recs, _ = banked
    with pytest.raises(TypeError, match="stacked"):
        x = pmtt.DistributedArray.to_dist(np.ones(4), device="cpu")
        elastic.bank_carry("s", {"v": pmtt.StackedDistributedArray([x, x])})
    elastic._BANK["masked"] = recs[0]["masked"]
    with pytest.raises(trs.ReshardError, match="mask"):
        elastic.restore_carry("masked", device="cpu")
    elastic._BANK["cgls"] = recs[0]["cgls"]
    monkeypatch.setenv(P + "SPILL", "off")
    # a (9, 4) f64 row is 32 bytes: 16 cannot hold one
    with pytest.raises(trs.ReshardError, match="at least 32") as e:
        elastic.restore_carry("cgls", budget=16, device="cpu")
    assert e.value.min_budget == 32
    with pytest.raises(KeyError):
        elastic.restore_carry("nothing", device="cpu")


@pytest.mark.parametrize("backend", ["native", "shards"])
@pytest.mark.parametrize("budget,spill", [("64", "auto"), ("40", "on")])
def test_budgeted_restore_is_unbudgeted_restore(banked, monkeypatch,
                                                backend, budget, spill):
    _, d = banked
    path = os.path.join(d, backend)
    plain = ckpt.load_pytree(path, device="cpu")
    monkeypatch.setenv(P + "RESHARD_BUDGET", budget)
    monkeypatch.setenv(P + "SPILL", spill)
    monkeypatch.setenv(P + "TRACE", "spans")
    trace.clear_events()
    got = ckpt.load_pytree(path, device="cpu")
    steps = [e["args"] for e in trace.get_events()
             if e["name"] == "collective.reshard.step"]
    assert steps and all(s["kind"] in ("dynamic_slice", "host_stage")
                         for s in steps)
    for k in ("x", "b"):
        assert torch.equal(got[k].array, plain[k].array)
        assert got[k].local_shapes == plain[k].local_shapes
    assert got["k"] == plain["k"] == 3


def test_malformed_budget_refuses_the_restore(banked, monkeypatch):
    """A typo in the budget raises rather than restore unbounded."""
    _, d = banked
    monkeypatch.setenv(P + "RESHARD_BUDGET", "12 parsecs")
    with pytest.raises(ValueError, match="RESHARD_BUDGET"):
        ckpt.load_pytree(os.path.join(d, "shards"), device="cpu")


# ------------------------------------------------------ supervised jobs
def _job(argv, n, **kw):
    kw.setdefault("heartbeat_interval", 0.3)
    kw.setdefault("job_timeout_s", 120)
    return launch_job(argv, n, **kw)


def test_outer_assignment_not_passed_without_inplace(monkeypatch):
    monkeypatch.setenv(P + "RECONFIG_FILE", "/outer/job.reconfig.json")
    r = _job([sys.executable, "-c",
              "import os; print('RCF', os.environ.get('"
              + P + "RECONFIG_FILE'))"], 1)
    assert r.ok and "RCF None" in r.outputs[0]


def test_lone_survivor_gets_its_reconfig(tmp_path):
    code = (
        "import os, sys, time, json\n"
        f"rcf = os.environ['{P}RECONFIG_FILE']\n"
        f"if os.environ['{P}PROCESS_ID'] == '1':\n"
        "    sys.exit(3)\n"
        "for _ in range(1200):\n"
        "    if os.path.exists(rcf):\n"
        "        print('RECONFIG', json.dumps(json.load(open(rcf))))\n"
        "        sys.exit(0)\n"
        "    time.sleep(0.05)\n"
        "sys.exit(9)\n")
    r = _job([sys.executable, "-c", code], 2, inplace=True,
             logdir=str(tmp_path))
    assert r.ok, r.failures
    assert r.attempts == 2 and r.world_size == 1
    assert [f.kind for f in r.failures] == ["exit"]
    doc = json.loads(r.outputs[0].split("RECONFIG ", 1)[1])
    assert doc == {"attempt": 1, "num_processes": 1, "process_id": 0,
                   "coordinator": None, "lost_slot": 1}


def test_several_survivors_take_the_relaunch(tmp_path):
    code = (
        "import os, sys, time\n"
        f"if os.environ['{P}ATTEMPT'] == '0':\n"
        f"    if os.environ['{P}PROCESS_ID'] == '2':\n"
        "        sys.exit(3)\n"
        "    time.sleep(120)\n"
        "sys.exit(0)\n")
    r = _job([sys.executable, "-c", code], 3, inplace=True,
             logdir=str(tmp_path))
    assert r.ok and r.attempts == 2 and r.world_size == 2
    assert not [p for p in os.listdir(tmp_path)
                if p.endswith(".reconfig.json")]


_RCF_CODE = ("import os; print('RCF', os.environ.get('"
             + P + "RECONFIG_FILE'))")


def test_launch_job_reads_the_knobs(tmp_path, monkeypatch):
    """``inplace=None`` follows ``..._INPLACE`` (``on``: the in-place
    path), ``off`` overrides ``inplace=True``, and ``quorum=None`` reads
    ``..._QUORUM``: at 1.0 a lone survivor of two is below it and takes
    the relaunch."""
    monkeypatch.setenv(P + "INPLACE", "on")
    r = _job([sys.executable, "-c", _RCF_CODE], 1, logdir=str(tmp_path / "a"))
    assert r.ok and "reconfig.json" in r.outputs[0]
    monkeypatch.setenv(P + "INPLACE", "off")
    r = _job([sys.executable, "-c", _RCF_CODE], 1, inplace=True,
             logdir=str(tmp_path / "b"))
    assert r.ok and "RCF None" in r.outputs[0]
    monkeypatch.delenv(P + "INPLACE")
    monkeypatch.setenv(P + "QUORUM", "1.0")
    code = (
        "import os, sys, time\n"
        f"if os.environ['{P}ATTEMPT'] == '0':\n"
        f"    if os.environ['{P}PROCESS_ID'] == '1':\n"
        "        sys.exit(3)\n"
        "    time.sleep(120)\n"
        "sys.exit(0)\n")
    r = _job([sys.executable, "-c", code], 2, inplace=True,
             logdir=str(tmp_path / "c"))
    assert r.ok and r.attempts == 2 and r.world_size == 1
    assert not [p for p in os.listdir(tmp_path / "c")
                if p.endswith(".reconfig.json")]


def test_survivor_missing_its_deadline_takes_the_relaunch(tmp_path):
    """A survivor that beats on but never resumes (wedged in a
    collective) is a ``reconfig_timeout`` after ``reconfig_deadline_s``;
    its slot is kept and relaunched (from the checkpoint, in a real
    job), with ``shrink`` at its default."""
    code = (
        "import json, os, sys, time\n"
        f"att, hb = os.environ['{P}ATTEMPT'], os.environ['{P}HEARTBEAT_FILE']\n"
        "if att != '0':\n"
        "    print('RELAUNCHED', att)\n"
        "    sys.exit(0)\n"
        f"if os.environ['{P}PROCESS_ID'] == '1':\n"
        "    sys.exit(3)\n"
        "for _ in range(1200):\n"
        "    with open(hb, 'w') as f:\n"
        "        json.dump({'attempt': 0}, f)\n"
        "    time.sleep(0.1)\n"
        "sys.exit(9)\n")
    r = _job([sys.executable, "-c", code], 2, inplace=True,
             reconfig_deadline_s=1.0, logdir=str(tmp_path))
    assert r.ok, (r.failures, r.outputs)
    assert [(f.kind, f.slot) for f in r.failures] == [
        ("exit", 1), ("reconfig_timeout", 0)]
    assert r.attempts == 3 and r.world_size == 1
    assert "RELAUNCHED 1" in r.outputs[0]


def _trace_names(path):
    with open(path) as f:
        return [json.loads(line).get("name", "") for line in f if line.strip()]


def _chaos(tmp_path, env=None, sleep_s="1.0", **kw):
    out, mark = str(tmp_path / "x.npy"), str(tmp_path / "mark")
    killed = []

    def on_poll(attempt, workers):
        # SIGKILL slot 1 in the nap after an epoch was banked and saved,
        # outside a collective (with sleep_s="mid" worker 1 dies inside
        # one by itself)
        if sleep_s != "mid" and not killed and os.path.exists(mark):
            for w in workers:
                if w.slot == 1 and w.alive():
                    w.proc.send_signal(signal.SIGKILL)
                    killed.append(1)

    argv = [os.path.join(HERE, "torch_resilience_ranks.py"), "--inplace",
            str(tmp_path / "carry"), out, mark,
            str(tmp_path / "trace.attempt{attempt}.rank{rank}.jsonl"),
            "cpu", sleep_s]
    r = launch_job(argv, 2, heartbeat_interval=0.4, stale_factor=2.0,
                   grace_s=60.0, job_timeout_s=150, on_poll=on_poll,
                   inplace=True, logdir=str(tmp_path / "logs"),
                   env=dict({P + "TRACE": "spans", "OMP_NUM_THREADS": "1"},
                            **(env or {})), **kw)
    return r, out


def _jax_reference():
    import pylops_mpi_tpu as pmt
    from pylops_mpi_tpu.ops.local import MatrixMult
    from pylops_mpi_tpu.solvers.segmented import cgls_segmented as jseg
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
    Op = pmt.MPIBlockDiag([MatrixMult(b, dtype=np.float64) for b in blocks])
    res = jseg(Op, pmt.DistributedArray.to_dist(y),
               x0=pmt.DistributedArray.to_dist(np.zeros_like(xt)),
               niter=60, tol=0.0, epoch=5)
    return np.asarray(res.x.asarray())


def test_killed_worker_survivor_finishes_in_place(tmp_path):
    r, out = _chaos(tmp_path)
    assert r.ok, (r.failures, r.outputs)
    assert r.attempts == 2 and r.world_size == 1
    assert [(f.kind, f.slot) for f in r.failures] == [("signal", 1)]
    assert "INPLACE OK how=inplace attempt=1 world=1 iiter=60" in \
        r.outputs[0]
    assert "INPLACE FALLBACK" not in r.outputs[0]
    names = _trace_names(str(tmp_path / "trace.attempt0.rank0.jsonl"))
    for ev in ("resilience.carry_banked", "resilience.mesh_reformed",
               "resilience.inplace_recovery", "collective.reshard.step"):
        assert ev in names
    assert "checkpoint.load" not in names
    ref = _jax_reference()
    got = np.load(out)
    assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) <= 1e-10


def test_killed_mid_epoch_survivor_finishes_in_place(tmp_path):
    """Worker 1 dies inside a collective of epoch 3 (no nap): the
    survivor's all-reduce raises, it takes the reconfig from there and
    resumes from the carry banked at epoch 2, with no checkpoint read."""
    r, out = _chaos(tmp_path, sleep_s="mid")
    assert r.ok, (r.failures, r.outputs)
    assert r.attempts == 2 and r.world_size == 1
    assert [(f.kind, f.slot) for f in r.failures] == [("signal", 1)]
    assert "INPLACE OK how=inplace attempt=1 world=1 iiter=60" in \
        r.outputs[0]
    names = _trace_names(str(tmp_path / "trace.attempt0.rank0.jsonl"))
    assert "resilience.peer_lost" in names
    assert "resilience.inplace_recovery" in names
    assert "checkpoint.load" not in names
    ref = _jax_reference()
    got = np.load(out)
    assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) <= 1e-10


def test_kill_mid_reshard_takes_the_relaunch(tmp_path):
    r, out = _chaos(tmp_path, env={P + "FAULT_KILL_RESHARD": "1"},
                    shrink=False, max_relaunches=2)
    assert r.ok, (r.failures, r.outputs)
    # launch, in-place reconfig, then the survivor's own death and the
    # checkpoint relaunch at a world of one
    assert r.attempts == 3 and r.world_size == 1
    assert [(f.kind, f.slot) for f in r.failures] == [("signal", 1),
                                                      ("signal", 0)]
    assert "INPLACE OK how=relaunch attempt=1 world=1 iiter=60" in \
        r.outputs[0]
    names = _trace_names(str(tmp_path / "trace.attempt1.rank0.jsonl"))
    assert "checkpoint.load" in names
    assert "resilience.inplace_recovery" not in names
    ref = _jax_reference()
    got = np.load(out)
    assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) <= 1e-10
