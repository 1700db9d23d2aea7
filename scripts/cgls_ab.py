#!/usr/bin/env python3
"""The port's CGLS main path in two checkouts, in turns, on one GPU.

    python3 scripts/cgls_ab.py OTHER_CHECKOUT [--rounds 2]

Each turn is a fresh interpreter that imports ``pylops_mpi_tpu_torch``
and ``chip_smoke.py`` from one checkout (OTHER_CHECKOUT, or the one
holding this script), builds its kernels there, makes chip_smoke's
32 x 4096x4096 problem from the same seed and times 50 iterations of
``cgls(normal=True)`` with f32 and with bf16 storage and of the classic
schedule with f32 storage, best of three, as chip_smoke's phase 3 does,
plus the normal kernel alone (mean of 20 calls, CUDA events), and, in a
checkout that has ``block_cgls``, 30 iterations of it on 16 columns
(best of three). Turns run other, this, this, other per round, so both
checkouts meet the same card and host. It prints the card (name and
power limit), one JSON line per turn, and a summary JSON line.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent

CHILD = r"""
import json, sys, time
root = sys.argv[1]
sys.path.insert(0, root)
import torch
import chip_smoke as cs
import pylops_mpi_tpu_torch as pmtt
from pylops_mpi_tpu_torch.ops import _build
from pylops_mpi_tpu_torch.ops import normal_kernels as nk
from pylops_mpi_tpu_torch.ops.local import MatrixMult
assert pmtt.__file__.startswith(root), pmtt.__file__
_build.build_all()
dev = torch.device("cuda")
A, xtrue, y_t = cs.make_problem(torch, dev)
y = pmtt.DistributedArray.to_dist(y_t)
out = {"root": root}


def best(fn, n=3):
    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return res, walls


for label, cdt, normal in (("normal_f32", None, True),
                           ("normal_bf16", torch.bfloat16, True),
                           ("classic_f32", None, False)):
    Op = pmtt.MPIBlockDiag([MatrixMult(A[i]) for i in range(cs.NBLK)],
                           compute_dtype=cdt)
    pmtt.cgls(Op, y, niter=2, tol=0.0, normal=normal)
    torch.cuda.synchronize()
    x, walls = best(lambda: pmtt.cgls(Op, y, niter=cs.NITER, tol=0.0,
                                      normal=normal)[0])
    err = float(torch.linalg.vector_norm(x.array - xtrue)
                / torch.linalg.vector_norm(xtrue))
    out[label] = dict(iters_per_s=cs.NITER / min(walls), wall_s=walls,
                      rel_err=err)
    if normal:
        Ab = Op._batched
        X = torch.randn(Ab.shape[0], Ab.shape[2], device=dev)
        out[label]["kernel_ms"] = cs.cuda_ms(
            lambda: nk.normal_matvec(Ab, X))
    if label == "normal_f32" and hasattr(pmtt, "block_cgls"):
        Y = pmtt.DistributedArray.to_dist(torch.randn(
            y_t.shape[0], 16, generator=torch.Generator(
                device=dev).manual_seed(1), device=dev))
        pmtt.block_cgls(Op, Y, niter=2, tol=0.0)
        torch.cuda.synchronize()
        _, walls = best(lambda: pmtt.block_cgls(Op, Y, niter=30, tol=0.0))
        out["block_cgls_16"] = dict(iters_per_s=30 / min(walls),
                                    wall_s=walls)
        del Y
    del Op, x
    torch.cuda.empty_cache()
print(json.dumps(out), flush=True)
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    other = args.other.resolve()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    turns = {str(other): [], str(HERE): []}
    for _ in range(args.rounds):
        for root in (other, HERE, HERE, other):
            run = subprocess.run([sys.executable, "-c", CHILD, str(root)],
                                 capture_output=True, text=True, timeout=900)
            if run.returncode != 0:
                print(run.stdout + run.stderr, file=sys.stderr)
                return run.returncode
            line = run.stdout.strip().splitlines()[-1]
            print(line, flush=True)
            turns[str(root)].append(json.loads(line))
    summary = {"card": card}
    for root, rows in turns.items():
        summary[root] = {
            label: {key: sorted(r[label][key] for r in rows)
                    for key in ("iters_per_s", "kernel_ms")
                    if key in rows[0][label]}
            for label in rows[0] if label != "root"}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
