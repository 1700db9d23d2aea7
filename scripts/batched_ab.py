#!/usr/bin/env python3
"""``batched_solve`` in two checkouts, in turns, on one GPU.

    python3 scripts/batched_ab.py OTHER_CHECKOUT [--rounds 1] [--calls 5]

Each turn is a fresh interpreter that imports ``pylops_mpi_tpu_torch``
and ``chip_smoke.py`` from one checkout (OTHER_CHECKOUT, or the one
holding this script) and runs chip_smoke's phase 24.4 problem: a family
of 4 ``MPIBlockDiag`` members ``A + s I`` built from chip_smoke's 32 x
4096x4096 f32 blocks, 30 CGLS iterations. After one warm call of each,
it times ``--calls`` cached ``batched_solve`` calls and as many runs of
the 4 members' sequential ``cgls``, alternating, each wall closed by a
device synchronize, and holds each lane against its own ``cgls``. Turns
run other, this, this, other per round, so both checkouts meet the same
card and host. It prints the card (name and power limit), one JSON line
per turn, and a summary JSON line.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent

CHILD = r"""
import json, sys, time
root, calls = sys.argv[1], int(sys.argv[2])
sys.path.insert(0, root)
import torch
import chip_smoke as cs
import pylops_mpi_tpu_torch as pmtt
from pylops_mpi_tpu_torch.ops.local import MatrixMult
from pylops_mpi_tpu_torch.solvers import block as blk
assert pmtt.__file__.startswith(root), pmtt.__file__
dev = torch.device("cuda")
D = pmtt.DistributedArray
A, xtrue, _ = cs.make_problem(torch, dev)
ops, ys = [], []
for s in cs.SHIFTS_24:
    As = A.clone()
    As.diagonal(dim1=1, dim2=2).add_(s)
    ops.append(pmtt.MPIBlockDiag([MatrixMult(As[i])
                                  for i in range(cs.NBLK)]))
    ys.append(ops[-1].matvec(D.to_dist(xtrue)))
    del As
del A
torch.cuda.empty_cache()
idx = list(range(len(ops)))
niter = cs.NITER_B24


def batched():
    return blk.batched_solve(lambda b: ops[b], idx, ys, solver="cgls",
                             niter=niter, tol=0.0)


def sequential():
    return [pmtt.cgls(op, yv, niter=niter, tol=0.0)[0].array
            for op, yv in zip(ops, ys)]


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


batched(), sequential()
bw, sw = [], []
for _ in range(calls):
    res, w = timed(batched)
    bw.append(w)
    solo, w = timed(sequential)
    sw.append(w)
gaps = [cs.rel_norm(res.xs[b].array, solo[b]) for b in idx]
print(json.dumps({"root": root, "batched_s": bw, "sequential_s": sw,
                  "lane_gaps": gaps, "iiter": res.iiter.tolist()}),
      flush=True)
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--calls", type=int, default=5)
    args = ap.parse_args()
    other = args.other.resolve()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    turns = {str(other): [], str(HERE): []}
    for _ in range(args.rounds):
        for root in (other, HERE, HERE, other):
            run = subprocess.run([sys.executable, "-c", CHILD, str(root),
                                  str(args.calls)],
                                 capture_output=True, text=True, timeout=600)
            if run.returncode != 0:
                print(run.stdout + run.stderr, file=sys.stderr)
                return run.returncode
            line = run.stdout.strip().splitlines()[-1]
            print(line, flush=True)
            turns[str(root)].append(json.loads(line))
    summary = {"card": card}
    for root, rows in turns.items():
        summary[root] = {key: sorted(v for r in rows for v in r[key])
                         for key in ("batched_s", "sequential_s")}
        summary[root]["max_lane_gap"] = max(g for r in rows
                                            for g in r["lane_gaps"])
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
