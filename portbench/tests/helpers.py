"""Runs of the benchmark's command on the CPU at tiny sizes, for the
tests."""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

# tiny sizes of each configuration, and limits that a sound program meets
# at them (the cells' own limits were set at the full sizes, on the card)
TINY = {
    "blockdiag_4096x128": {"nblk": 8, "n": 64, "chunk": 2},
    "poststack_65536x1024": {"nx": 64, "nt0": 128},
}
TINY_LIMITS = {"x_gap": 2e-4, "cost_rel_gap": 1e-4}


def run_cell(cell, config, seed=123, seconds=0.5, trace=0, env=None,
             limits=TINY_LIMITS, root=ROOT, traffic=None):
    """``(returncode, result line or None, stderr)`` of one run on the CPU."""
    test = {"config": TINY[config], "limits": limits}
    if traffic:
        test["traffic"] = traffic
    cmd = [sys.executable, str(root / "portbench" / "run.py"),
           "--workload", cell, "--seed", str(seed), "--seconds",
           str(seconds), "--trace", str(trace), "--test-cpu",
           json.dumps(test)]
    full_env = dict(os.environ, PYTHONPATH=str(ROOT))
    full_env.update(env or {})
    p = subprocess.run(cmd, capture_output=True, text=True, env=full_env,
                       cwd=root, timeout=600)
    lines = [l for l in p.stdout.splitlines() if l.startswith("{")]
    last = json.loads(lines[-1]) if lines else None
    return p.returncode, last, p.stderr
