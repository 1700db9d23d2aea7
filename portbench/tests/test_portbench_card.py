"""On the card: each one-card cell at its full size, a short window, comes
out correct, and its control (the reference at TF32) does not. Skips
without a card; run on a machine with an H100 with
``python3 -m pytest -m cuda portbench/tests/test_portbench_card.py``."""

import json
import subprocess
import sys

import pytest
import torch

from helpers import ROOT
from portbench.harness import runner, spec

CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]
         if w["chips"] == 1]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct(card, cell):
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        cell, "--seed", "2900000001", "--seconds", "3",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"], line
    assert line["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_full_size(card, cell):
    import pylops_mpi_tpu_torch as pmtt
    c = spec.cell(cell)
    seed = 2900000002
    problem = spec.problem_module(c.config).build(c.config, c.traffic, seed,
                                                  card, pmtt)
    record = {"data_rows": problem.data_rows.cpu(), "iters": [],
              "kept_ids": [], "kept_costs": []}
    del problem
    torch.cuda.empty_cache()
    out = runner.judge(c, seed, record, card, control=True)
    assert not out["correct"], out
