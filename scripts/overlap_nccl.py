#!/usr/bin/env python3
"""The pipelined (overlap) collectives across two cards under NCCL, the
one setting where ``PYLOPS_MPI_TPU_TORCH_OVERLAP=auto`` turns them on.

    python3 scripts/overlap_nccl.py

Needs two cards (it takes cards 0 and 1). It builds the kernels, then
spawns two NCCL ranks, one card each, three times:

1. with the knob unset: ``auto`` resolves on for the derivative, the
   halo, the stack, SUMMA and the FFT, and the tuner's cost-model pick
   for each family carries the overlap and chunk count of the
   constructors' default (``tuning.space.rank`` against
   ``default_params``);
2. chip_smoke.py's 28.2: the post-stack CGLS at full width, overlap on
   against off, the tap kernel on the overlap path's interior;
3. chip_smoke.py's 28.3: SUMMA's rings, the stack's ring adjoint, the
   chunked FFT, the sparse ring adjoint, ``MPIHalo`` and the gradient
   through the derivative's ghosts, overlap on against off.

The checks are chip_smoke.py's. It prints the card's name and power limit
first and a JSON summary last, and exits with 1 if a check fails.
"""

import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))

import chip_smoke as cs  # noqa: E402

# the tuner's contexts of the auto check: two ranks, f32
_FAMILIES = {
    "derivative": dict(shape=(65536, 1024), extra={}),
    "halo": dict(shape=(2048, 1024), extra={}),
    "stack": dict(shape=(8192, 1024), extra={}),
    "fft": dict(shape=(256, 256, 128), extra={}),
    "matrixmult": dict(shape=(4096, 2048, 64), extra={"grid": (1, 2)}),
}


def _auto_rank(torch, pmtt, dev):
    """With the knob unset: what ``auto`` resolves to in each consumer,
    and the tuner's default and cost-model pick for each family."""
    from pylops_mpi_tpu_torch.ops.local import MatrixMult
    from pylops_mpi_tpu_torch.tuning import space
    from pylops_mpi_tpu_torch.utils import deps
    os.environ.pop("PYLOPS_MPI_TPU_TORCH_OVERLAP", None)
    n = pmtt.parallel.world_size()
    A = torch.ones((64, 32), device=dev)
    ops = {
        "derivative": pmtt.MPIFirstDerivative((64, 16), dtype=torch.float32),
        "halo": pmtt.MPIHalo((64, 16), (1, 1), (n, 1)),
        "stack": pmtt.MPIVStack([MatrixMult(A) for _ in range(n)]),
        "matrixmult": pmtt.MPIMatrixMult(A, 8, kind="summa", grid=(1, n),
                                         device=dev),
        "fft": pmtt.MPIFFTND((16, 16, 8), axes=(0, 1, 2),
                             dtype=torch.complex64),
    }
    out = dict(rank=pmtt.parallel.rank(),
               enabled=deps.overlap_enabled(None, dev),
               resolved={k: bool(op._overlap) for k, op in ops.items()},
               tuner={})
    for fam, c in _FAMILIES.items():
        ctx = dict(op=fam, platform="cuda", chip=torch.cuda.get_device_name(),
                   n_dev=n, dtype="float32", **c)
        sp = space.SPACES[fam]
        d = space.default_params(sp, ctx)
        top = space.rank(sp, ctx)[0]
        out["tuner"][fam] = dict(default=d, pick=top)
    return out


def main() -> int:
    import torch
    card = cs.card_name()
    print(card, flush=True)
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("overlap_nccl.py: needs two cards", file=sys.stderr)
        return 1
    from pylops_mpi_tpu_torch.ops import _build
    t = time.perf_counter()
    _build.build_all()
    summary = dict(card=card, build_s=time.perf_counter() - t)
    t = time.perf_counter()
    ranks = cs.spawn_shared_card(2, HERE, _auto_rank, backend="nccl")
    for o in ranks:
        print(f"auto, rank {o['rank']}: enabled {o['enabled']}; resolved "
              f"{o['resolved']}; tuner {o['tuner']}", flush=True)
        bad = [k for k, v in o["tuner"].items()
               if v["default"].get("overlap") != "on"
               or any(v["pick"].get(a) != v["default"].get(a)
                      for a in ("overlap", "comm_chunks"))]
        if not o["enabled"] or not all(o["resolved"].values()) or bad:
            raise RuntimeError(f"auto under NCCL, rank {o['rank']}: {o}")
    summary["auto_s"] = time.perf_counter() - t
    post = cs.overlap28_post(HERE, backend="nccl")
    summary["post"] = dict(x_rel_err=post["x_rel_err"],
                           seconds=post["seconds"],
                           walls=[(o["wall_on_s"], o["wall_off_s"])
                                  for o in post["ranks"]],
                           launches=[o["launches"] for o in post["ranks"]])
    t = time.perf_counter()
    cases = cs.overlap28_cases(HERE, backend="nccl")
    summary["cases"] = {k: v["err"] for k, v in cases.items()
                        if isinstance(v, dict) and "err" in v}
    summary["cases_s"] = time.perf_counter() - t
    print(json.dumps(summary, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
