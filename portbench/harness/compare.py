"""The comparison that decides ``correct``: each answer of the window's
sample against the plain reference's answer to the same data.

- ``x_gap``: ``max |x − x_ref| / max |x_ref|`` over the sampled solves;
- ``cost_rel_gap``: ``max_k |cost_k − cost_ref_k| / cost_ref_k`` over the
  iterations whose reference residual is still above ``RESOLVED`` of the
  first (below it the program's machine-precision floor holds the
  recurrence still, so the history there reads the floor, not the solve);
- ``iters_short``: how many iterations the shortest solve of the window
  lacked (every solve runs all of its iterations: ``tol = 0``), limit 0.

The limits of a cell are in ``limits/<cell>.json``, with the readings they
were set from.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

# the share of the first residual norm above which an iteration's residual
# is compared entry by entry
RESOLVED = 1e-3
def _finite(v: float):
    return v if math.isfinite(v) else None


def checks(answers: List[Tuple[int, torch.Tensor, torch.Tensor]],
           X_ref: torch.Tensor, C_ref: torch.Tensor, iters: List[int],
           niter: int, lim: Dict[str, float]) -> dict:
    """``{"correct", "failed", "numbers"}`` for ``answers``, each
    ``(rhs index, x, cost history)``, and the iterations of every solve."""
    x_gap = rel_gap = 0.0
    failed = 0
    for j, x, cost in answers:
        xr, cr = X_ref[j].double(), C_ref[j].double()
        x = x.double()
        xg = float((x - xr).abs().max() / xr.abs().max())
        n = min(cost.shape[0], cr.shape[0])
        diff = (cost[:n].double() - cr[:n]).abs()
        live = cr[:n] >= RESOLVED * cr[0]
        rg = float((diff[live] / cr[:n][live]).max())
        if not (xg <= lim["x_gap"] and rg <= lim["cost_rel_gap"]):
            failed += 1
        x_gap = xg if not math.isfinite(xg) else max(x_gap, xg)
        rel_gap = rg if not math.isfinite(rg) else max(rel_gap, rg)
    short = max((niter - int(i) for i in iters), default=niter)
    failed += sum(1 for i in iters if int(i) != niter)
    numbers = {
        "x_gap": {"value": _finite(x_gap), "limit": lim["x_gap"]},
        "cost_rel_gap": {"value": _finite(rel_gap),
                         "limit": lim["cost_rel_gap"]},
        "iters_short": {"value": short, "limit": 0},
    }
    correct = bool(answers) and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in numbers.values())
    return {"correct": correct, "failed": failed, "numbers": numbers}
