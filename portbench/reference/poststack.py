"""Plain reference of the post-stack deployment: CGLS (:mod:`.cgls`) on
``[0.5·W·D; ε·∇]``, given the data the program was given, with the
published definitions written out (PyLops ``FirstDerivative``,
``Convolve1D`` and ``Gradient``; PyLops-MPI ``tutorials/poststack.py``):

- ``D``: the centred first derivative along time, one-sided at both ends
  (``edge=True``);
- ``W``: the convolution along time with the wavelet centred on its middle
  sample, ``(W x)[i] = Σ_k h[k] x[i + c - k]``, ``c = len(h) // 2``;
- ``∇``: the centred first derivatives along traces and along time, zero
  at the ends (``edge=False``), stacked.

The products are the convolution's; at ``tf32`` their operands are rounded.
Imports nothing of the program under test."""

from __future__ import annotations

import torch

from portbench.inputs import poststack as inputs
from portbench.reference.cgls import cgls
from portbench.reference.precision import dtype, no_tf32, operand


def centred(x: torch.Tensor, axis: int, edge: bool) -> torch.Tensor:
    """Centred first derivative of ``x`` along ``axis`` (unit sampling)."""
    x = x.movedim(axis, -1)
    y = torch.zeros_like(x)
    y[..., 1:-1] = 0.5 * (x[..., 2:] - x[..., :-2])
    if edge:
        y[..., 0] = x[..., 1] - x[..., 0]
        y[..., -1] = x[..., -1] - x[..., -2]
    return y.movedim(-1, axis)


def centred_adjoint(y: torch.Tensor, axis: int, edge: bool) -> torch.Tensor:
    y = y.movedim(axis, -1)
    x = torch.zeros_like(y)
    x[..., :-2] -= 0.5 * y[..., 1:-1]
    x[..., 2:] += 0.5 * y[..., 1:-1]
    if edge:
        x[..., 0] -= y[..., 0]
        x[..., 1] += y[..., 0]
        x[..., -2] -= y[..., -1]
        x[..., -1] += y[..., -1]
    return x.movedim(-1, axis)


def convolve(x: torch.Tensor, h: torch.Tensor, adjoint: bool) -> torch.Tensor:
    """``W x`` (or ``Wᴴ x``) along the last axis, as a sum of shifted
    copies, zero outside the trace."""
    nh, n = h.shape[0], x.shape[-1]
    c = nh // 2
    y = torch.zeros_like(x)
    for k in range(nh):
        s = (k - c) if adjoint else (c - k)  # y[i] += h[k]·x[i + s]
        lo, hi = max(0, -s), min(n, n - s)
        if lo < hi:
            y[..., lo:hi] += h[k] * x[..., lo + s:hi + s]
    return y


def operator(cfg: dict, precision: str):
    """``(forward, adjoint)`` on ``(K, nx·nt0)`` rows; the forward returns
    the three stacked outputs side by side."""
    nx, nt0 = int(cfg["nx"]), int(cfg["nt0"])
    eps = float(cfg["eps_r"])
    h = None

    def wav(device):
        nonlocal h
        if h is None:
            h = operand(torch.as_tensor(inputs.wavelet(cfg), device=device),
                        precision)
        return h

    def forward(V):
        K = V.shape[0]
        m = V.reshape(K, nx, nt0)
        d = 0.5 * convolve(operand(centred(m, 2, True), precision),
                           wav(V.device), False)
        g0, g1 = centred(m, 1, False), centred(m, 2, False)
        return torch.cat([d.reshape(K, -1), eps * g0.reshape(K, -1),
                          eps * g1.reshape(K, -1)], dim=1)

    def adjoint(U):
        K, npts = U.shape[0], nx * nt0
        d, g0, g1 = (U[:, i * npts:(i + 1) * npts].reshape(K, nx, nt0)
                     for i in range(3))
        m = centred_adjoint(
            0.5 * convolve(operand(d, precision), wav(U.device), True),
            2, True)
        m = m + eps * centred_adjoint(g0, 1, False) \
            + eps * centred_adjoint(g1, 2, False)
        return m.reshape(K, -1)
    return forward, adjoint


def data(cfg: dict, m: torch.Tensor) -> torch.Tensor:
    """``0.5·W·D m`` of a model ``(nx, nt0)`` at ``m``'s precision (f64 for
    the inputs)."""
    h = torch.as_tensor(inputs.wavelet(cfg), device=m.device, dtype=m.dtype)
    return 0.5 * convolve(centred(m, 1, True), h, False)


def solve(cfg: dict, seed: int, Y: torch.Tensor, niter: int, damp: float,
          device, precision: str = "f64"):
    """``(X, cost)`` of plain CGLS on the data rows ``Y`` (``(K, nx·nt0)``,
    the regularization's data zero), at ``precision``."""
    K, npts = Y.shape
    with no_tf32():
        fwd, adj = operator(cfg, precision)
        full = torch.zeros((K, 3 * npts), dtype=dtype(precision),
                           device=device)
        full[:, :npts] = Y.to(device)
        return cgls(fwd, adj, full, niter, damp)
