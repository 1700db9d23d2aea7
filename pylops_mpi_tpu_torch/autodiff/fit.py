"""A small training driver for differentiable solves.

PyTorch counterpart of ``pylops_mpi_tpu/autodiff/fit.py``. The loss
closes over a solve of :mod:`.implicit` (``cgls_solve`` and the like),
its parameters are tensors the operator holds (a block stack, sparse
values, the 0-d factor ``ε`` of a scaled regularizer), and each step
costs one forward and one backward solve. The update rules are the JAX
package's own Adam and SGD, written out (``fit.py:65-137``), not
``torch.optim``, so that the loss trajectories of the two packages can
be compared step for step.

Parameters are updated **in place** (under ``no_grad``): an operator
built once over them keeps its ``id``, its tensors' addresses and so
its captured graphs, and the next step's replay reads the new values.
Integer tensors (sparse indices) are structural and left alone. For a
complex parameter the step follows torch's gradient, which is the
conjugate of ``jax.grad``'s (:func:`~..convert.grad_to_jax`).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import numpy as np
import torch

__all__ = ["fit", "trainable_leaves", "param_count"]


def _leaves(params) -> List[Any]:
    if isinstance(params, dict):
        return [v for k in sorted(params, key=str) for v in _leaves(params[k])]
    if isinstance(params, (list, tuple)):
        return [v for p in params for v in _leaves(p)]
    return [params]


def _is_trainable(leaf) -> bool:
    return isinstance(leaf, torch.Tensor) and (leaf.is_floating_point()
                                               or leaf.is_complex())


def trainable_leaves(params) -> list:
    """The floating and complex tensors of ``params`` (a tensor, or lists,
    tuples and dicts of them): what :func:`fit` updates. Integer tensors
    and other leaves are structural and skipped."""
    return [leaf for leaf in _leaves(params) if _is_trainable(leaf)]


def param_count(params) -> int:
    """The number of trainable scalars in ``params``."""
    return int(sum(leaf.numel() for leaf in trainable_leaves(params)))


def fit(loss_fn: Callable, params: Any, *, steps: int = 100,
        lr: float = 1e-2, optimizer: str = "adam", beta1: float = 0.9,
        beta2: float = 0.999, eps: float = 1e-8,
        callback: Optional[Callable] = None):
    """Minimize ``loss_fn(params)`` by Adam (default) or plain SGD.

    ``loss_fn`` returns a real scalar tensor. Each step evaluates it with
    grad on, takes the gradients of :func:`trainable_leaves` ``(params)``
    by ``torch.autograd.grad`` and updates them in place. Returns
    ``(params, losses)``: the same objects, and a ``(steps,)`` numpy array
    of the loss at each step's parameters before its update.
    ``callback(step, loss, params)`` runs on the host after each step."""
    if optimizer not in ("adam", "sgd"):
        raise ValueError(f"optimizer={optimizer!r}: expected 'adam' or "
                         "'sgd'")
    leaves = trainable_leaves(params)
    for p in leaves:
        if not p.requires_grad:
            p.requires_grad_(True)
    m = [torch.zeros_like(p) for p in leaves]
    v = [torch.zeros_like(p, dtype=p.real.dtype if p.is_complex()
                          else p.dtype) for p in leaves]
    losses = np.zeros(steps, dtype=np.float64)
    for step in range(steps):
        with torch.enable_grad():
            loss = loss_fn(params)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        losses[step] = float(loss.detach())
        t = step + 1
        bc1 = 1.0 - beta1 ** t
        bc2 = 1.0 - beta2 ** t
        with torch.no_grad():
            for i, (p, g) in enumerate(zip(leaves, grads)):
                if g is None:
                    continue
                g = g.to(p.dtype)
                if optimizer == "sgd":
                    p.sub_(lr * g)
                    continue
                m[i] = beta1 * m[i] + (1.0 - beta1) * g
                v[i] = beta2 * v[i] + (1.0 - beta2) * torch.abs(g) ** 2
                p.sub_(lr * ((m[i] / bc1) / (torch.sqrt(v[i] / bc2) + eps)))
        if callback is not None:
            callback(step, losses[step], params)
    return params, losses
