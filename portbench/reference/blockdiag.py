"""Plain reference of the block-diagonal deployment: CGLS (:mod:`.cgls`)
on ``torch.bmm`` over the blocks, which it draws again from the seed
(:mod:`portbench.inputs.blockdiag`), given the data the program was given.
Imports nothing of the program under test."""

from __future__ import annotations

import torch

from portbench.inputs import blockdiag as inputs
from portbench.reference.cgls import cgls
from portbench.reference.precision import no_tf32, operand


def operator(A: torch.Tensor, precision: str):
    """``(forward, adjoint)`` on ``(K, nblk·n)`` rows at ``precision``."""
    A = operand(A, precision)
    nblk, m, n = A.shape
    At = A.transpose(1, 2)

    def apply(M, rows, cols):
        def f(V):
            K = V.shape[0]
            X = operand(V, precision).reshape(K, nblk, cols).permute(1, 2, 0)
            return torch.bmm(M, X).permute(2, 0, 1).reshape(K, nblk * rows)
        return f
    return apply(A, m, n), apply(At, n, m)


def solve(cfg: dict, seed: int, Y: torch.Tensor, niter: int, damp: float,
          device, precision: str = "f64"):
    """``(X, cost)`` of plain CGLS on the rows of ``Y`` (the data the
    program was given), at ``precision``."""
    nchunks = int(cfg["nblk"]) // int(cfg["chunk"])
    with no_tf32():
        A = inputs.blocks(cfg, seed, range(nchunks), device)
        fwd, adj = operator(A, precision)
        del A
        Yp = operand(Y.to(device), precision)
        return cgls(fwd, adj, Yp, niter, damp)
