"""What a run measures, read from ``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, one traffic mix or one metric
lives in a file of its own, found by its name:

- ``configs/<config>.json``: the deployment's sizes; its ``problem`` key
  names the builder ``problems/<problem>.py`` and the plain reference
  ``reference/<problem>.py``;
- ``traffic/<traffic>.json``: the solves a run makes (solver schedule,
  iterations, right-hand sides, what is checked and traced);
- ``metrics/<metric>.py``: one reader per metric, end to end or per layer;
- ``limits/<cell>.json``: the limits of the cell's comparison with the plain
  reference, with the readings they were set from.

A new cell, configuration or metric is new files and new entries in
``BENCHMARK.json``; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict
    traffic: dict
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)
    limits: Dict[str, float] = field(default_factory=dict)


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, cell: str, reported: Optional[set] = None) -> bool:
    """Whether ``cell`` reports ``metric``: it is listed under the metric's
    ``workloads``, or the metric lists none and the cell reports the
    end-to-end metric it moves (``reported``; ``None`` for end-to-end
    metrics themselves)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric.get("moves") in reported


def cell(name: str, root: Path = ROOT, bench: Optional[dict] = None) -> Cell:
    """The cell ``name`` with its configuration, traffic and metrics."""
    bench = load_benchmark(root) if bench is None else bench
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    base = root / BENCH_DIR.name
    cfg_entry = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    with open(root / cfg_entry["file"]) as f:
        config = json.load(f)
    with open(base / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    with open(base / "limits" / f"{name}.json") as f:
        limits = {k: float(v) for k, v in json.load(f).items()
                  if k != "readings"}
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"],
                traffic_name=w["traffic"], config=config, traffic=traffic,
                end_to_end=e2e, per_layer=layer, limits=limits)


def _load(path: Path, modname: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def problem_module(config: dict, root: Path = ROOT) -> ModuleType:
    """``problems/<problem>.py``: builds the system under test."""
    name = config["problem"]
    return _load(root / BENCH_DIR.name / "problems" / f"{name}.py",
                 f"portbench_problem_{name}")


def reference_module(config: dict, root: Path = ROOT) -> ModuleType:
    """``reference/<problem>.py``: the plain reference."""
    name = config["problem"]
    return _load(root / BENCH_DIR.name / "reference" / f"{name}.py",
                 f"portbench_reference_{name}")


def metric_reader(name: str, root: Path = ROOT) -> ModuleType:
    """``metrics/<name>.py``, whose ``read(ctx)`` gives the metric's value
    or ``None`` where it finds nothing to read."""
    fname = name.replace(".", "_").replace("-", "_")
    return _load(root / BENCH_DIR.name / "metrics" / f"{fname}.py",
                 f"portbench_metric_{fname}")
