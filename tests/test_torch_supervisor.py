"""The port's supervision held against the JAX package's contract: the
worker contract and placeholders, failure classification (exit, signal,
stale heartbeat) with shrinking and same-size relaunches, a terminal
timeout, an exhausted budget, kept logs, the collective watchdog, the
process group's watched and retried bring-up, ``serve_job``'s requeue of
a dead worker's claims, and one chaos run: a SIGSTOPped gloo worker
classified ``stale_heartbeat`` and the job finished on a world of one
from the checkpoint. ``inplace=True`` is accepted and arms its workers;
the in-place recovery itself is ``test_torch_inplace.py``'s.

The launch tests run tiny ``python -c`` workers that import nothing of
torch, so the classify/relaunch loop runs in milliseconds; the chaos run
starts ``tests/torch_resilience_ranks.py`` (torch and the port, never
the JAX package). Tolerance of the chaos run: the resumed x within 1e-6
of the uninterrupted solve with no group, relative to its largest entry
(the JAX chaos test's bar); the detection bound is the JAX test's, 2×
the beat interval plus 1 s.
"""

import os
import re
import signal
import sys
import time

import numpy as np
import pytest

from pylops_mpi_tpu_torch.diagnostics import trace
from pylops_mpi_tpu_torch.diagnostics.profiler import STAGE_BUDGETS
from pylops_mpi_tpu_torch.resilience import elastic
from pylops_mpi_tpu_torch.resilience.elastic import (
    WatchdogTimeout, watched_call, watchdog_enabled, watchdog_mode,
    watchdog_timeout, worker_config)
from pylops_mpi_tpu_torch.resilience.supervisor import launch_job

from test_torch_process_group import close

HERE = os.path.dirname(os.path.abspath(__file__))
P = "PYLOPS_MPI_TPU_TORCH_"
_ENV = tuple(P + k for k in (
    "COORDINATOR", "NUM_PROCESSES", "PROCESS_ID", "ATTEMPT",
    "HEARTBEAT_FILE", "HEARTBEAT", "WATCHDOG", "WATCHDOG_TIMEOUT",
    "RETRIES", "RETRY_BACKOFF", "TRACE"))


@pytest.fixture(autouse=True)
def _unsupervised(monkeypatch):
    for name in _ENV:
        monkeypatch.delenv(name, raising=False)
    elastic.stop_heartbeat()
    yield
    elastic.stop_heartbeat()


def _job(argv, n, **kw):
    kw.setdefault("heartbeat_interval", 0.2)
    kw.setdefault("job_timeout_s", 60)
    return launch_job(argv, n, **kw)


def env_is(name, value):
    return f"os.environ['{P}{name}']=='{value}'"


# ------------------------------------------------------ worker contract
def test_worker_config_and_unsupervised_bring_up(monkeypatch):
    assert worker_config().coordinator is None
    cfg = elastic.elastic_initialize()  # a world of one: no group
    assert cfg.num_processes is None and cfg.attempt == 0
    monkeypatch.setenv(P + "COORDINATOR", "127.0.0.1:777")
    monkeypatch.setenv(P + "NUM_PROCESSES", "3")
    monkeypatch.setenv(P + "PROCESS_ID", "2")
    monkeypatch.setenv(P + "ATTEMPT", "1")
    cfg = worker_config()
    assert cfg.coordinator == "127.0.0.1:777"
    assert (cfg.num_processes, cfg.process_id, cfg.attempt) == (3, 2, 1)


def test_launch_job_env_contract_and_placeholders():
    code = ("import os; print(os.environ['" + P + "PROCESS_ID'],"
            "os.environ['" + P + "NUM_PROCESSES'],"
            "os.environ['" + P + "ATTEMPT'],"
            "os.environ['" + P + "COORDINATOR'], '{rank}/{world}@{attempt}')")
    r = _job([sys.executable, "-c", code], 2)
    assert r.ok and r.attempts == 1 and r.world_size == 2 and not r.failures
    for rank in (0, 1):
        rk, world, attempt, coord, ph = r.outputs[rank].split()
        assert (int(rk), int(world), int(attempt)) == (rank, 2, 0)
        assert re.match(r"127\.0\.0\.1:\d+", coord)
        assert ph == f"{rank}/2@0"


# ------------------------------------------------------ classification
def test_exit_classified_and_shrunk():
    code = ("import os, sys; sys.exit(3 if " + env_is("PROCESS_ID", 1)
            + " and " + env_is("ATTEMPT", 0) + " else 0)")
    r = _job([sys.executable, "-c", code], 2)
    assert r.ok and r.attempts == 2 and r.world_size == 1
    f = r.failures[0]
    assert (f.kind, f.returncode, f.slot) == ("exit", 3, 1)


def test_signal_classified():
    code = ("import os, signal; " + env_is("ATTEMPT", 0) + " and "
            + env_is("PROCESS_ID", 1)
            + " and os.kill(os.getpid(), signal.SIGKILL)")
    r = _job([sys.executable, "-c", code], 2, max_relaunches=1)
    assert r.ok and r.attempts == 2 and r.world_size == 1
    f = r.failures[0]
    assert f.kind == "signal" and f.returncode == -9 and "SIGKILL" in f.detail


def test_stale_heartbeat_sigstop():
    hb = 0.2
    code = ("import os, time\n"
            f"hb = os.environ['{P}HEARTBEAT_FILE']\n"
            f"iv = float(os.environ['{P}HEARTBEAT'])\n"
            f"if os.environ['{P}ATTEMPT'] == '0':\n"
            "    while True:\n"
            "        with open(hb, 'w') as f:\n"
            "            f.write('beat')\n"
            "        time.sleep(iv)\n")
    stopped = []

    def on_poll(attempt, workers):
        w = workers[0]
        if attempt == 0 and not stopped and os.path.exists(w.heartbeat_path):
            w.proc.send_signal(signal.SIGSTOP)
            stopped.append(1)

    r = _job([sys.executable, "-c", code], 2, on_poll=on_poll,
             heartbeat_interval=hb, stale_factor=2.0)
    assert r.ok and r.attempts == 2 and r.world_size == 1
    f = r.failures[0]
    assert f.kind == "stale_heartbeat" and f.slot == 0
    m = re.search(r"no heartbeat for ([\d.]+)s", f.detail)
    assert m and float(m.group(1)) <= 2 * hb + 1.0


def test_no_shrink_keeps_world():
    code = ("import os, sys; sys.exit(1 if " + env_is("ATTEMPT", 0)
            + " and " + env_is("PROCESS_ID", 0) + " else 0)")
    r = _job([sys.executable, "-c", code], 2, shrink=False)
    assert r.ok and r.attempts == 2 and r.world_size == 2


def test_timeout_terminal_and_budget_exhausted():
    r = _job([sys.executable, "-c", "import time; time.sleep(60)"], 1,
             job_timeout_s=1.0, grace_s=30.0)
    assert not r.ok and r.attempts == 1 and r.failures[-1].kind == "timeout"
    r = _job([sys.executable, "-c", "import sys; sys.exit(2)"], 2,
             max_relaunches=1)
    assert not r.ok and len(r.failures) == 2
    assert all(f.kind == "exit" for f in r.failures)


def test_logs_and_report_kept(tmp_path):
    r = _job([sys.executable, "-c", "print('hello from worker')"], 1,
             logdir=str(tmp_path))
    assert r.ok and "hello from worker" in r.outputs[0]
    assert r.logdir == str(tmp_path)
    names = os.listdir(tmp_path)
    assert any(n.endswith(".log") for n in names)
    assert "job_report.json" in names


def test_inplace_and_aot_cache_refused():
    # aot_cache stays refused; inplace=True is accepted (next test)
    with pytest.raises(ValueError, match="aot_cache"):
        launch_job([sys.executable, "-c", "pass"], 1, aot_cache="/bank")


def test_inplace_accepted_writes_reconfig_path_and_arms(tmp_path,
                                                        monkeypatch):
    code = ("import os; print('RCF', os.environ['"
            "PYLOPS_MPI_TPU_TORCH_RECONFIG_FILE'])")
    r = _job([sys.executable, "-c", code], 1, inplace=True,
             logdir=str(tmp_path))
    assert r.ok and r.attempts == 1
    rcf = r.outputs[0].split("RCF ", 1)[1].strip()
    assert rcf == str(tmp_path / "worker0.attempt0.reconfig.json")
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_RECONFIG_FILE", rcf)
    assert elastic.inplace_armed()


# ------------------------------------------------------ the watchdog
def test_watchdog_modes(tmp_path, monkeypatch):
    assert watchdog_mode() == "auto" and not watchdog_enabled()
    monkeypatch.setenv(P + "TRACE", "spans")
    trace.clear_events()
    assert watched_call(lambda a: a * 2, 21, stage="checkpoint_io") == 42
    assert not [e for e in trace.get_events()
                if e["name"].startswith("resilience.watchdog")]
    monkeypatch.setenv(P + "HEARTBEAT_FILE", str(tmp_path / "x.hb"))
    assert watchdog_enabled()  # auto: armed under a supervisor
    monkeypatch.setenv(P + "WATCHDOG", "off")
    assert not watchdog_enabled()
    monkeypatch.setenv(P + "WATCHDOG", "sideways")
    monkeypatch.setattr(elastic, "_warned_wd", False)
    with pytest.warns(UserWarning, match="WATCHDOG"):
        assert watchdog_mode() == "auto"


def test_watchdog_timeout_relay_and_nesting(monkeypatch):
    import threading
    monkeypatch.setenv(P + "WATCHDOG", "on")
    monkeypatch.setenv(P + "TRACE", "spans")
    trace.clear_events()
    with pytest.raises(WatchdogTimeout, match="multihost_init"):
        watched_call(time.sleep, 10.0, stage="multihost_init",
                     timeout_s=0.2)
    assert "resilience.watchdog_timeout" in [e["name"]
                                             for e in trace.get_events()]
    assert watched_call(lambda: "done", stage="checkpoint_io") == "done"
    with pytest.raises(ZeroDivisionError):
        watched_call(lambda: 1 / 0, stage="checkpoint_io")
    seen = {}

    def outer():
        seen["outer"] = threading.get_ident()
        return watched_call(threading.get_ident, stage="checkpoint_io")

    assert watched_call(outer, stage="multihost_init") == seen["outer"]
    assert watchdog_timeout("multihost_init") == \
        STAGE_BUDGETS["multihost_init"]["tpu"]
    monkeypatch.setenv(P + "WATCHDOG_TIMEOUT", "7.5")
    assert watchdog_timeout("checkpoint_io") == 7.5


def test_group_bring_up_is_retried_and_watched(monkeypatch):
    import torch.distributed as dist
    import pylops_mpi_tpu_torch as pmtt
    from pylops_mpi_tpu_torch.resilience import faults
    monkeypatch.setenv(P + "RETRIES", "1")
    monkeypatch.setenv(P + "RETRY_BACKOFF", "0")
    flaky = faults.flaky(lambda *a, **k: None, failures=5)
    monkeypatch.setattr(dist, "init_process_group", flaky)
    with pytest.raises(TimeoutError):
        pmtt.parallel.init(backend="gloo", init_method="tcp://x:1", rank=0,
                           world_size=2, device="cpu")
    assert flaky.calls == 2  # one try and the one retry
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **k: time.sleep(5))
    monkeypatch.setenv(P + "WATCHDOG", "on")
    monkeypatch.setenv(P + "WATCHDOG_TIMEOUT", "0.2")
    with pytest.raises(WatchdogTimeout, match="multihost_init"):
        pmtt.parallel.init(backend="gloo", init_method="tcp://x:1", rank=0,
                           world_size=2, device="cpu")


# ------------------------------------------------------ serve_job
def test_serve_job_requeues_dead_claims(tmp_path):
    from pylops_mpi_tpu_torch.serving import serve_job, spool
    root = str(tmp_path / "spool")
    spool.init_spool(root)
    spool.enqueue(root, "fam", np.zeros(4, dtype=np.float32),
                  request_id="r0")
    # the first attempt claims the request and dies holding it; the
    # relaunch finds it pending again and exits clean
    code = (f"import os, sys\n"
            f"root = {root!r}\n"
            f"if os.environ['{P}ATTEMPT'] == '0':\n"
            "    p = os.path.join(root, 'pending')\n"
            "    n = sorted(os.listdir(p))[0]\n"
            "    os.rename(os.path.join(p, n),"
            " os.path.join(root, 'claimed', n))\n"
            "    sys.exit(9)\n"
            "print(sorted(os.listdir(os.path.join(root, 'pending'))))\n")
    r = serve_job([sys.executable, "-c", code], 1, root, max_relaunches=1,
                  heartbeat_interval=0.2, job_timeout_s=60, shrink=False)
    assert r.ok and r.attempts == 2 and r.failures[0].kind == "exit"
    assert "r0.a1.npz" in r.outputs[0]
    assert spool.pending_count(root) == 1 and spool.claimed_count(root) == 0


# ------------------------------------------------------ chaos
def test_chaos_sigstop_stale_heartbeat_resume(tmp_path):
    ckpt, out = str(tmp_path / "carry"), str(tmp_path / "x.npy")
    mark = str(tmp_path / "mark")
    hb = 0.5
    stopped = []

    def on_poll(attempt, workers):
        if attempt == 0 and not stopped and os.path.exists(mark):
            workers[0].proc.send_signal(signal.SIGSTOP)
            stopped.append(1)

    r = launch_job([os.path.join(HERE, "torch_resilience_ranks.py"), ckpt,
                    out, mark, "cpu"], 2, heartbeat_interval=hb,
                   stale_factor=2.0, grace_s=60.0, job_timeout_s=150,
                   on_poll=on_poll, env={"OMP_NUM_THREADS": "1"})
    assert r.ok, r.outputs
    assert r.attempts == 2 and r.world_size == 1 and stopped
    f = r.failures[0]
    assert f.kind == "stale_heartbeat" and f.slot == 0
    m = re.search(r"no heartbeat for ([\d.]+)s", f.detail)
    assert m and float(m.group(1)) <= 2 * hb + 1.0
    assert "CHAOS OK attempt=1 world=1 iiter=60" in r.outputs[0]
    from torch_resilience_ranks import chaos_problem
    from pylops_mpi_tpu_torch.solvers.segmented import cgls_segmented
    Op, y = chaos_problem("cpu")
    ref = cgls_segmented(Op, y, niter=60, tol=0.0, epoch=5)
    close(np.load(out), ref.x.asarray(), rtol=1e-6)
