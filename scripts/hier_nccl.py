#!/usr/bin/env python3
"""The two-level (hierarchical) collectives across four cards under NCCL,
declared 2 hosts of 2 (``PYLOPS_MPI_TPU_TORCH_FABRIC=2x2``).

    python3 scripts/hier_nccl.py

Needs four cards (it takes cards 0 to 3). It builds the kernels, then
spawns four NCCL ranks, one card each, once, and runs chip_smoke.py's
phase 29 there:

1. 29.2: the Gradient-regularized post-stack CGLS at full width with the
   knob on against off, x bitwise and against the solve in one process,
   the tap kernel's launches a rank and its last call on ghost rows
   against the plain version, and each rank's ghost bytes split by the
   fabric of their sender;
2. 29.3: the host-blocked ring, the two-level reduce-scatter, gather and
   pencil transposes against the flat collectives, and the stack's
   adjoint, SUMMA's rings and the FFT, on against off.

The checks are chip_smoke.py's: a correctness check across cards, not a
speed. Overlap is pinned off in the ranks, so the derivatives exchange
their ghosts in bulk, as on the gloo ranks of phase 29 (``auto`` would
turn the overlap family on under NCCL). It prints the card's name and
power limit first and a JSON summary last, and exits with 1 if a check
fails.
"""

import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch
    card = cs.card_name()
    print(card, flush=True)
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        print("hier_nccl.py: needs four cards", file=sys.stderr)
        return 1
    import pylops_mpi_tpu_torch as pmtt
    from pylops_mpi_tpu_torch.ops import _build
    t = time.perf_counter()
    _build.build_all()
    summary = dict(card=card, build_s=time.perf_counter() - t)
    x_one = cs.hier29_one_process(torch, pmtt, torch.device("cuda"))
    torch.cuda.empty_cache()
    os.environ["PYLOPS_MPI_TPU_TORCH_OVERLAP"] = "off"
    t = time.perf_counter()
    ranks = cs.hier29_world(HERE, backend="nccl")
    summary["world_s"] = time.perf_counter() - t
    post = cs.hier29_post_check(ranks, x_one, backend="nccl")
    summary["post"] = dict(x_bitwise=post["x_bitwise"],
                           x_vs_one_process=post["x_vs_one_process"],
                           tap_max_err=[o["tap"]["max_err"]
                                        for o in post["ranks"]],
                           summed=post["summed"],
                           walls=[(o["wall_on_s"], o["wall_off_s"])
                                  for o in post["ranks"]],
                           launches=[o["launches"] for o in post["ranks"]])
    cases = cs.hier29_cases_check(ranks, backend="nccl")
    summary["cases"] = {k: v["err"] for k, v in cases.items()
                        if isinstance(v, dict) and "err" in v}
    print(json.dumps(summary, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
