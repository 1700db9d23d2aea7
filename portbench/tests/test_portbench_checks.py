"""The comparison that decides ``correct``: the control (the reference at
TF32) and every fault the cells can have come out not correct, a sound run
comes out correct, and a run that cannot measure prints no result."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from helpers import ROOT, TINY, run_cell
from portbench.harness import runner, spec
from portbench.harness import trace as tr

CELLS = {w["name"]: w["config"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_run_is_correct(cell):
    rc, line, err = run_cell(cell, CELLS[cell])
    assert rc == 0, err
    assert line["correct"] and line["failed"] == 0, line
    assert list(line)[-1] == "checks"
    assert err.strip().splitlines()[-1].startswith("check iters_short")


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_is_not_correct(cell):
    """The reference computed at TF32 in the program's place fails the
    cell's own limits, at three seeds."""
    c = spec.cell(cell)
    c.config.update(TINY[c.config_name])
    for seed in (11, 12, 13):
        n_rhs = int(c.traffic["n_rhs"])
        data = _data(c, seed)
        record = {"data_rows": data, "iters": [],
                  "kept_ids": [], "kept_costs": []}
        assert data.shape[0] == n_rhs
        out = runner.judge(c, seed, record, "cpu", control=True)
        assert not out["correct"], out


def _data(c, seed):
    mod = spec.problem_module(c.config)
    import pylops_mpi_tpu_torch as pmtt
    return mod.build(c.config, c.traffic, seed, "cpu", pmtt).data_rows


FAULTS = [(c, f) for c in sorted(CELLS)
          for f in ("frozen_step", "half_batch", "altered_answer")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_fault_is_not_correct(cell, fault):
    rc, line, err = run_cell(cell, CELLS[cell],
                             env={"PORTBENCH_FAULT": fault})
    assert rc == 0, err
    assert line is not None and not line["correct"], line


def test_no_card_no_result():
    """Without a card the command exits with another code than 0 and
    prints no result."""
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "blockdiag-normal", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert p.returncode != 0
    assert not [l for l in p.stdout.splitlines() if l.startswith("{")]


def test_benchmark_files_alone_give_no_result(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's files the
    command fails and prints no result."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "blockdiag-normal", "--seed", "1", "--seconds", "1",
                        "--trace", "0", "--test-cpu",
                        json.dumps({"config": TINY["blockdiag_4096x128"]})],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=300, env={"PATH": "/usr/bin:/bin"})
    assert p.returncode != 0
    assert not [l for l in p.stdout.splitlines() if l.startswith("{")]


def _copy(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return tmp_path, bench


def test_a_reference_that_loads_jax_gives_no_result(tmp_path):
    """The look for the JAX side comes after the reference has run, so a
    module that the reference loads is found too."""
    root, bench = _copy(tmp_path)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    ref = root / "portbench/reference/blockdiag.py"
    ref.write_text(ref.read_text()
                   + "\nimport sys as _sys\n_sys.modules['jax'] = _sys\n")
    rc, line, err = run_cell("blockdiag-normal", "blockdiag_4096x128",
                             root=root)
    assert rc != 0 and line is None
    assert "jax" in err


def test_a_cell_on_four_cards_gives_no_result(tmp_path):
    """The harness runs one card; a cell that asks for four is refused."""
    root, bench = _copy(tmp_path)
    bench["workloads"].append({"name": "blockdiag-normal-4card",
                               "config": "blockdiag_4096x128",
                               "traffic": "cgls_normal", "chips": 4,
                               "why": "a dummy cell"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "portbench/limits/blockdiag-normal-4card.json").write_text(
        (ROOT / "portbench/limits/blockdiag-normal.json").read_text())
    rc, line, err = run_cell("blockdiag-normal-4card", "blockdiag_4096x128",
                             root=root)
    assert rc != 0 and line is None, err


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "pylops_mpi_tpu_torch_x", object())
    assert runner.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert runner.forbidden_modules() == ["jax"]


def test_trace_summary_by_hand():
    """Two solves of 10 µs each; the range's kernel is the one launched
    inside it; idle time named by the host operation over it."""
    us = 1.0

    def ev(cat, name, ts, dur, corr=None):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e
    events = [
        ev("user_annotation", "portbench.solve", 0, 10 * us),
        ev("user_annotation", "portbench.solve", 10, 10 * us),
        ev("user_annotation", "portbench.normal_apply", 1, 2 * us),
        ev("cuda_runtime", "cudaLaunchKernel", 1.5, 0.5, corr=7),
        ev("cuda_runtime", "cudaLaunchKernel", 5, 0.5, corr=8),
        ev("cpu_op", "aten::mul", 4, 4),
        ev("kernel", "normal_kernel", 2, 6, corr=7),
        ev("kernel", "dot_kernel", 9, 4, corr=8),
        ev("gpu_memset", "Memset", 14, 1),
    ]
    s = tr.summarize(events)
    assert s["span_s"] == pytest.approx(20e-6)
    # [2, 8], [9, 13] and [14, 15]
    assert s["busy_s"] == pytest.approx(11e-6)
    assert s["kernels"] == 2
    assert s["ranges"]["portbench.normal_apply"] == {
        "calls": 1, "device_s": pytest.approx(6e-6)}
    idle = dict(s["idle_gaps"])
    assert sum(idle.values()) == pytest.approx(9e-6)
    assert idle["user_annotation:portbench.normal_apply"] == \
        pytest.approx(2e-6)   # [0, 2]: inside the range, the innermost
