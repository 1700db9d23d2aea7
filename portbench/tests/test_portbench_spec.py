"""BENCHMARK.json against the contract's shapes, every name resolving to
its files, the import rule, and a new cell that needs only new files."""

import ast
import json
import shutil
from pathlib import Path

import pytest

from helpers import ROOT, run_cell
from portbench.harness import spec

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
FORBIDDEN = {"jax", "jaxlib", "flax", "pylops_mpi_tpu", "chip_smoke"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"]
                         + BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert spec.NAME_RE.match(entry["name"])
    if "unit" in entry:
        assert spec.UNIT_RE.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("config", "traffic"):
        if key in entry:
            assert spec.NAME_RE.match(entry[key])
    for key in entry.get("reduced", []):
        assert spec.NAME_RE.match(key)
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200
            assert "\n" not in entry[key] and "\t" not in entry[key]


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
    names = [m["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for m in BENCH[k]]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_resolves_to_its_files(w):
    cell = spec.cell(w["name"])
    assert cell.chips == w["chips"]
    assert spec.problem_module(cell.config).build
    assert spec.reference_module(cell.config).solve
    assert set(cell.limits) == {"x_gap", "cost_rel_gap"}
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert spec.metric_reader(m["name"]).read
    for m in cell.per_layer:
        assert m["moves"] in e2e


def test_config_files_are_the_ones_run():
    for c in BENCH["configs"]:
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted((ROOT / "portbench").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_side_import(path):
    assert not set(_imports(path)) & FORBIDDEN


def test_a_new_cell_needs_only_new_files(tmp_path):
    """A copy of the benchmark gains a cell, a traffic mix and a per-layer
    metric by new files and new entries; no file of the copy changes, and
    the new cell runs with the new metric in its line."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*")
              if p.is_file()}
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "blockdiag-normal-8rhs",
                               "config": "blockdiag_4096x128",
                               "traffic": "cgls_normal_8rhs", "chips": 1,
                               "why": "a dummy cell"})
    bench["per_layer"].append({"name": "solves_done", "unit": "solves",
                               "better": "higher", "source": "host_clock",
                               "layer": "L5 solver and L2 vectors",
                               "moves": "iters_per_s",
                               "workloads": ["blockdiag-normal-8rhs"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = json.loads((ROOT / "portbench/traffic/cgls_normal.json")
                         .read_text())
    traffic["n_rhs"] = 8
    (tmp_path / "portbench/traffic/cgls_normal_8rhs.json").write_text(
        json.dumps(traffic))
    (tmp_path / "portbench/limits/blockdiag-normal-8rhs.json").write_text(
        (ROOT / "portbench/limits/blockdiag-normal.json").read_text())
    (tmp_path / "portbench/metrics/solves_done.py").write_text(
        "def read(ctx):\n    return len(ctx.times)\n")
    rc, line, err = run_cell("blockdiag-normal-8rhs", "blockdiag_4096x128",
                             trace=1, root=tmp_path)
    assert rc == 0, err
    assert line["correct"], line
    assert line["metrics"]["solves_done"]["value"] == line["attempted"]
    for p, data in before.items():
        assert p.read_bytes() == data
