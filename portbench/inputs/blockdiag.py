"""Inputs of the block-diagonal deployment, made on the device from the seed.

``nblk`` dense blocks of ``n × n``, each diagonally dominant
(``randn / √n + 4·I``), drawn in chunks of ``chunk`` blocks from a generator
seeded by the seed and the chunk's index, so that a rank that holds some of
the chunks draws exactly the blocks a single card draws. Each right-hand
side ``j`` is ``y_j = A x_j`` for a known model ``x_j`` drawn from its own
generator. Plain PyTorch: the program under test is not imported.
"""

from __future__ import annotations

import math

import torch

from portbench.harness.seeding import generator

_A, _X = 1, 2


def blocks(cfg: dict, seed: int, chunk_ids, device,
           dtype=torch.float32) -> torch.Tensor:
    """The blocks of the chunks ``chunk_ids``, stacked: ``(len·chunk, n,
    n)``."""
    n, chunk = int(cfg["n"]), int(cfg["chunk"])
    out = torch.empty((len(chunk_ids) * chunk, n, n), dtype=torch.float32,
                      device=device)
    for i, c in enumerate(chunk_ids):
        part = out[i * chunk:(i + 1) * chunk]
        torch.randn(part.shape, generator=generator(seed, _A, c, device),
                    device=device, out=part)
        part.mul_(1.0 / math.sqrt(n))
        part.diagonal(dim1=1, dim2=2).add_(4.0)
    return out.to(dtype)


def models(cfg: dict, seed: int, n_rhs: int, device) -> torch.Tensor:
    """The known models ``(n_rhs, nblk·n)``, f32."""
    N = int(cfg["nblk"]) * int(cfg["n"])
    return torch.stack([
        torch.randn(N, generator=generator(seed, _X, j, device),
                    device=device) for j in range(n_rhs)])


def data(A: torch.Tensor, X: torch.Tensor, first_block: int) -> torch.Tensor:
    """``y = A x`` over the blocks ``A`` (which start at block
    ``first_block``) for every model row of ``X``: ``(n_rhs, rows)``, f32
    with TF32 off."""
    nb, m, n = A.shape
    xs = X[:, first_block * n:(first_block + nb) * n].reshape(-1, nb, n)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        y = torch.bmm(A, xs.permute(1, 2, 0))  # (nb, m, n_rhs)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return y.permute(2, 0, 1).reshape(X.shape[0], nb * m).contiguous()
