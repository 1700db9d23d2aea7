"""Plain CGLS (PyLops ``optimization/cls_basic.py``, ``CGLS``) over a
batch of right-hand sides, each with its own scalars, from ``x0 = 0`` and
for a fixed number of iterations (``tol = 0``). Plain PyTorch; the
precision is the dtype of the vectors the operator returns.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

Apply = Callable[[torch.Tensor], torch.Tensor]


def _dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (u * v).sum(dim=1)


def cgls(forward: Apply, adjoint: Apply, Y: torch.Tensor, niter: int,
         damp: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(X, cost)`` for the rows of ``Y``: the models after ``niter``
    iterations and the residual-norm histories ``||y - A x_k||`` (the
    recurrence's ``s``), ``(K, niter + 1)``."""
    damp2 = damp ** 2
    s = Y.clone()
    r = adjoint(s)
    x = torch.zeros_like(r)
    c = r.clone()
    kold = _dot(r, r)
    cost = [torch.linalg.vector_norm(s, dim=1)]
    for _ in range(niter):
        q = forward(c)
        qq = _dot(q, q)
        a = kold / (qq + damp2 * _dot(c, c) if damp2 else qq)
        x = x + a[:, None] * c
        s = s - a[:, None] * q
        r = adjoint(s) - damp2 * x
        k = _dot(r, r)
        c = r + (k / kold)[:, None] * c
        kold = k
        cost.append(torch.linalg.vector_norm(s, dim=1))
    return x, torch.stack(cost, dim=1)
