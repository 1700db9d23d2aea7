"""The port's fleet trace aggregator
(``pylops_mpi_tpu_torch.diagnostics.aggregate`` and its CLI) held
against the JAX package's ``pylops_mpi_tpu.diagnostics.aggregate``.

- The same synthetic per-rank JSONLs (seed 37: ranks with their own
  clock offsets, one late rank, a truncated last line, an open span of a
  killed rank) give equal offsets, skews, stragglers, merged events and
  critical paths in both packages (exact).
- A gloo world of two port ranks (one of them late by 0.3 s) dumps its
  traces: every collective under the group is a ``collective.<name>``
  span with ``seq``, the CLI's last line is ``{"ok": true, ...}``, every
  matched collective carries ``skew_us``, the late rank is the
  straggler of the first collective after its pause, and the critical
  path names ``solver.cgls``. Both packages aggregate those files alike.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

from pylops_mpi_tpu.diagnostics import aggregate as jagg
from pylops_mpi_tpu_torch.diagnostics import aggregate as tagg

from test_torch_process_group import run_world
import torch_resilience_ranks as ranks

ROOT = Path(__file__).resolve().parents[1]


def _synthetic(tmp_path):
    """Three ranks' traces of one solve: the same collectives (names and
    seq) entered at each rank's own clock, rank 2 late at seq 3."""
    rng = np.random.default_rng(37)
    offsets = {0: 0.0, 1: 1.5e6, 2: -4.2e5}
    files = []
    for r in range(3):
        t = 1000.0 + offsets[r]
        lines = []
        for seq in range(6):
            late = 2.5e4 if (r == 2 and seq == 3) else 0.0
            ts = t + 100.0 * seq + late + float(rng.uniform(0, 3))
            lines.append({"name": "collective.all_reduce", "ph": "X",
                          "ts": ts, "dur": 12.0, "pid": 100 + r, "tid": 1,
                          "cat": "collective",
                          "args": {"seq": seq, "bytes": 8, "depth": 2,
                                   "parent": "MPIBlockDiag.matvec"}})
            lines.append({"name": "MPIBlockDiag.matvec", "ph": "X",
                          "ts": ts - 5, "dur": 40.0 + seq, "pid": 100 + r,
                          "tid": 1, "cat": "operator",
                          "args": {"depth": 1, "parent": "solver.cgls"}})
        lines.append({"name": "solver.cgls", "ph": "X", "ts": t - 10,
                      "dur": 900.0, "pid": 100 + r, "tid": 1,
                      "cat": "solver", "args": {"depth": 0}})
        text = "\n".join(json.dumps(ev) for ev in lines) + "\n"
        if r == 1:  # a killed rank: an open span and a cut last line
            text += json.dumps({"name": "solver.cg", "ph": "B",
                                "ts": t + 950.0, "pid": 101, "tid": 1,
                                "cat": "solver",
                                "args": {"depth": 0, "open": True}})
            text += "\n" + '{"name": "collective.all_reduce", "ts": 1'
        path = tmp_path / f"trace.rank{r}.jsonl"
        path.write_text(text)
        files.append(str(path))
    return files


def test_synthetic_traces_equal_jax(tmp_path):
    files = _synthetic(tmp_path)
    j = jagg.aggregate_files(files)
    t = tagg.aggregate_files(files)
    assert t == j
    assert t["ranks"] == [0, 1, 2]
    worst = max(t["collectives"], key=lambda c: c["skew_us"])
    assert (worst["seq"], worst["straggler_rank"]) == (3, 2)
    assert worst["skew_us"] > 2e4
    assert all("skew_us" in c for c in t["collectives"])
    assert abs(t["offsets_us"][1] + 1.5e6) < 10
    assert [c["solver"] for c in t["critical_path"]].count(
        "solver.cgls") == 3
    for path in files + [str(tmp_path / "missing.jsonl")]:
        assert tagg.load_events(path) == jagg.load_events(path)
        assert tagg.guess_rank(path) == jagg.guess_rank(path)


def test_two_gloo_ranks_aggregate_ok(tmp_path):
    out = tmp_path / "traces"
    out.mkdir()
    xs = run_world(ranks.trace_rank, 2, tmp_path, str(out), 1, 0.3)
    np.testing.assert_array_equal(xs[0], xs[1])
    evs = tagg.load_events(str(out / "trace.rank0.jsonl"))
    coll = [e for e in evs if e.get("cat") == "collective"]
    assert coll and all(isinstance(e["args"].get("seq"), int)
                        and "bytes" in e["args"] for e in coll)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PYLOPS_MPI_TPU")}
    r = subprocess.run(
        [sys.executable, "-m", "pylops_mpi_tpu_torch.diagnostics",
         "aggregate", str(out), "--out", str(tmp_path / "merged.json"),
         "--summary-out", str(tmp_path / "summary.json")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["ranks"] == [0, 1]
    assert last["n_collectives_matched"] > 10
    assert any(c["solver"] == "solver.cgls" for c in last["critical_path"])
    full = json.loads((tmp_path / "summary.json").read_text())
    assert all("skew_us" in c for c in full["collectives"])
    # the first collective after rank 1's pause waited for rank 1
    first = min((c for c in full["collectives"]
                 if c["skew_us"] > 1e5), key=lambda c: min(
                     c["entries_us"].values()))
    assert first["straggler_rank"] == 1
    files = tagg.discover_trace_files([str(out)])
    assert tagg.aggregate_files(files) == jagg.aggregate_files(files)
    m = subprocess.run(
        [sys.executable, "-m", "pylops_mpi_tpu_torch.diagnostics",
         "metrics", str(out)], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120)
    last = json.loads(m.stdout.strip().splitlines()[-1])
    assert m.returncode == 0 and last["ok"] and len(last["files"]) == 2
