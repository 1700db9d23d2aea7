"""Implicit differentiation through the fused solves.

PyTorch counterpart of ``pylops_mpi_tpu/autodiff/implicit.py``. A
converged Krylov solve is differentiated at its fixed point, not through
its iterations, so the backward pass is one more solve with the same
operator, never a tape of every iterate.

CG (Hermitian positive definite ``A``), fixed point ``A x* = y``: with
torch's conjugated cotangents, ``y.grad = A⁻ᴴ g = λ`` where ``A λ = g``,
and the parameter cotangent is minus the pullback of ``θ ↦ A(θ) x*`` at
``λ`` (:func:`~.rules.param_cotangent`).

CGLS, fixed point ``N x* = Aᴴ y`` with ``N = AᴴA + damp²``: ``N λ = g``
by one CG solve on the normal operator, ``y.grad = μ = A λ``, and the
parameter cotangent is the pullback of ``θ ↦ A(θ)ᴴ r*`` at ``λ`` minus
that of ``θ ↦ A(θ) x*`` at ``μ``, ``r* = y − A x*``.

Each solve is one ``torch.autograd.Function`` whose inputs are the
tensors of ``y``, of ``x0`` and of :func:`operator_params` ``(Op)``. Its
forward runs the port's fused loop under ``no_grad``, as a plain solve
does: the CA engine, ``M=``, and with ``PYLOPS_MPI_TPU_TORCH_AOT=on``
the graph bank (same ``id(Op)``, same keys), CGLS in the classic
two-sweep schedule (``normal=False``, JAX ``implicit.py:161``; the
normal kernel has no backward). The backward's CG solve runs the same
way: on ``Op`` for CG, on the memoised normal operator for CGLS (one
instance per ``(id(Op), damp)``, at most 16, so its bank entries are
reused from step to step). Only the operator applies of the parameter
cotangents take grad, outside any capture.

Guards are excluded (the fixed point is differentiated, not the loop's
breakdown handling); ``M`` changes the iteration, not the fixed point,
and is transparent; ``x0``'s cotangent is zero; ``iiter`` and ``cost``
carry no gradient. An operator with an unregistered node
(:func:`~..linearoperator.params_registered`) gives no parameter
gradients, and is refused if one of its tensors requires grad.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import List

import torch

from ..diagnostics import metrics as _metrics
from ..linearoperator import (MPILinearOperator, operator_params,
                              params_registered)
from .rules import _flat, _rebuild, param_cotangent

__all__ = ["cg_solve", "cgls_solve", "block_cg_solve", "block_cgls_solve",
           "should_intercept", "entry_cg", "entry_cgls", "entry_block_cg",
           "entry_block_cgls"]


def _all_tensors(Op) -> List[torch.Tensor]:
    from ..aot.signature import _tensors
    out: List = []
    _tensors(Op, out, set(), leaf=lambda t: t)
    return out


def _op_tensors(Op) -> List[torch.Tensor]:
    """The operator's parameters, or every tensor it holds when a node is
    unregistered."""
    return operator_params(Op) if params_registered(Op) else _all_tensors(Op)


def should_intercept(Op, y, x0=None) -> bool:
    """Grad mode is on and one of ``y``, ``x0`` or the operator's
    tensors requires grad: the solve must go through the implicit rule
    (the classic entries' reroute predicate). Other solves never
    intercept."""
    if not torch.is_grad_enabled():
        return False
    ts = _flat(y) + (_flat(x0) if x0 is not None else []) + _op_tensors(Op)
    return any(t.requires_grad for t in ts)


class _NormalOperator(MPILinearOperator):
    """``v ↦ AᴴA v + damp² v``: the normal system the CGLS backward solves
    (two sweeps; block vectors go through ``A``'s own applies)."""

    accepts_block = True

    def __init__(self, Op, damp: float):
        n = int(Op.shape[1])
        self.dims = self.dimsd = (n,)
        self.local_shapes_m = self.local_shapes_n = Op.local_shapes_m
        super().__init__(shape=(n, n), dtype=Op.dtype)
        self._Op = Op
        self._damp2 = float(damp) * float(damp)

    @property
    def device(self):
        return getattr(self._Op, "device", None)

    def _matvec(self, x):
        v = self._Op.rmatvec(self._Op.matvec(x))
        return v + x * self._damp2 if self._damp2 else v

    _rmatvec = _matvec


_NORMAL_MEMO: OrderedDict = OrderedDict()
_NORMAL_MEMO_MAX = 16


def _normal_operator(Op, damp: float) -> _NormalOperator:
    """The normal operator of ``(Op, damp)``, built once per pair so that
    repeated gradient steps reuse its graph-bank entries (``id`` keyed,
    JAX ``implicit.py:102-122``)."""
    key = (id(Op), float(damp))
    hit = _NORMAL_MEMO.get(key)
    if hit is not None and hit[0] is Op:
        _NORMAL_MEMO.move_to_end(key)
        return hit[1]
    Nop = _NormalOperator(Op, damp)
    _NORMAL_MEMO[key] = (Op, Nop)
    while len(_NORMAL_MEMO) > _NORMAL_MEMO_MAX:
        _NORMAL_MEMO.popitem(last=False)
    return Nop


def _zeros_like_vec(v):
    return _rebuild(v, [torch.zeros_like(t) for t in _flat(v)])


def _default_x0(Op, y, block: bool):
    if block:
        from ..solvers.block import _zero_block_model
        return _zero_block_model(Op, y)
    from ..solvers.basic import _zero_like_model
    return _zero_like_model(Op, y)


# ------------------------------------------------------- the fused solves
def _forward_cg(Op, y, x0, niter, tol, M, block):
    """One fused CG solve under ``no_grad``: ``(x, iiter, cost)``."""
    from ..solvers import basic as _b
    from ..solvers import block as _blk
    with torch.no_grad():
        if block:
            return _blk.block_cg(Op, y, x0, niter=niter, tol=tol,
                                 guards=False, M=M)
        x, iiter, cost, _ = _b._solve_cg(Op, y, x0, niter, tol, M, False)
        return x, iiter, cost


def _forward_cgls(Op, y, x0, niter, damp, tol, M, block):
    """One fused CGLS solve (classic schedule) under ``no_grad``: the
    entry's ``(x, istop, iiter, kold, r2norm, cost)``."""
    from ..solvers import basic as _b
    from ..solvers import block as _blk
    with torch.no_grad():
        if block:
            return _blk.block_cgls(Op, y, x0, niter=niter, damp=damp,
                                   tol=tol, guards=False, M=M)
        x, iiter, cost, cost1, kold, _ = _b._solve_cgls(
            Op, y, x0, niter, damp, tol, False, M, False)
        istop = 1 if float(kold) < tol else 2
        return x, istop, iiter, kold, cost1[-1], cost


def _cg_backward(Op, xstar, g, niter, tol, M, block, want_params):
    """``A λ = g`` by one more CG solve: ``(y cotangent, parameter
    cotangents)``."""
    _metrics.inc("autodiff.backward_solves")
    lam = _forward_cg(Op, g, _zeros_like_vec(g), niter, tol, M, block)[0]
    gp = None
    if want_params:
        gp = [None if c is None else -c
              for c in param_cotangent(Op, xstar, lam)]
    return lam, gp


def _cgls_backward(Op, y, xstar, g, niter, damp, tol, M, block,
                   want_params):
    """``N λ = g`` by one CG solve on the normal operator, ``μ = A λ``:
    ``(y cotangent μ, parameter cotangents)``."""
    _metrics.inc("autodiff.backward_solves")
    Nop = _normal_operator(Op, damp)
    lam = _forward_cg(Nop, g, _zeros_like_vec(g), niter, tol, M, block)[0]
    with torch.no_grad():
        mu = Op.matvec(lam)
    gp = None
    if want_params:
        with torch.no_grad():
            rstar = y - Op.matvec(xstar)
        t1 = param_cotangent(Op, rstar, lam, "rmatvec")
        t2 = param_cotangent(Op, xstar, mu, "matvec")
        gp = [None if a is None else a - b for a, b in zip(t1, t2)]
    return mu, gp


class _Spec:
    """A solve's settings and the structures of its vectors."""

    def __init__(self, kind, Op, niter, damp, tol, M, block, nparams,
                 ytmpl, x0tmpl):
        self.kind = kind
        self.Op = Op
        self.niter = niter
        self.damp = damp
        self.tol = tol
        self.M = M
        self.block = block
        self.nparams = nparams
        self.ny = len(_flat(ytmpl))
        self.ytmpl = ytmpl
        self.x0tmpl = x0tmpl
        self.outs = None


class _SolveFn(torch.autograd.Function):
    """One fused solve with its fixed-point backward (module
    docstring)."""

    @staticmethod
    def forward(ctx, spec, *tensors):
        n0, n1 = spec.nparams, spec.nparams + spec.ny
        y = _rebuild(spec.ytmpl, tensors[n0:n1])
        x0 = _rebuild(spec.x0tmpl, tensors[n1:])
        if spec.kind == "cg":
            outs = _forward_cg(spec.Op, y, x0, spec.niter, spec.tol, spec.M,
                               spec.block)
        else:
            outs = _forward_cgls(spec.Op, y, x0, spec.niter, spec.damp,
                                 spec.tol, spec.M, spec.block)
        spec.outs = outs
        xs = [t.clone() if any(t is u for u in tensors) else t
              for t in _flat(outs[0])]
        ctx.spec = spec
        ctx.save_for_backward(*tensors[n0:n1], *xs)
        return tuple(xs)

    @staticmethod
    def backward(ctx, *gx):
        spec = ctx.spec
        saved = ctx.saved_tensors
        y = _rebuild(spec.ytmpl, saved[:spec.ny])
        xstar = _rebuild(spec.outs[0], saved[spec.ny:])
        g = _rebuild(spec.outs[0], gx)
        want = spec.nparams > 0 and any(
            ctx.needs_input_grad[1:1 + spec.nparams])
        if spec.kind == "cg":
            gy, gp = _cg_backward(spec.Op, xstar, g, spec.niter, spec.tol,
                                  spec.M, spec.block, want)
        else:
            gy, gp = _cgls_backward(spec.Op, y, xstar, g, spec.niter,
                                    spec.damp, spec.tol, spec.M, spec.block,
                                    want)
        if gp is None:
            gp = [None] * spec.nparams
        gx0 = [torch.zeros_like(t) for t in _flat(spec.x0tmpl)]
        return (None, *gp, *_flat(gy), *gx0)


def _solve(kind, Op, y, x0, niter, damp, tol, M, block):
    """The differentiable solve: the entry's outputs with ``x`` attached
    to the autograd graph."""
    if x0 is None:
        x0 = _default_x0(Op, y, block)
    if params_registered(Op):
        params = operator_params(Op)
    else:
        if any(t.requires_grad for t in _all_tensors(Op)):
            raise TypeError(
                f"{type(Op).__name__} holds tensors that require grad but "
                "is not registered with "
                "linearoperator.register_operator_params: its gradient "
                "cannot be given, and is not dropped silently")
        params = []
    spec = _Spec(kind, Op, int(niter), float(damp), float(tol), M, block,
                 len(params), y, x0)
    xs = _SolveFn.apply(spec, *params, *_flat(y), *_flat(x0))
    x = _rebuild(spec.outs[0], xs)
    return (x,) + tuple(spec.outs[1:])


# --------------------------------------------------------------- user API
def cg_solve(Op, y, x0=None, *, niter: int = 10, tol: float = 1e-4,
             M=None):
    """Differentiable fused CG: returns ``x``, with the implicit
    fixed-point backward (one more CG solve with the same operator and
    preconditioner). Gradients reach ``y`` and the operator's
    parameters; ``x0``'s is zero."""
    return _solve("cg", Op, y, x0, niter, 0.0, tol, M, False)[0]


def cgls_solve(Op, y, x0=None, *, niter: int = 10, damp: float = 0.0,
               tol: float = 1e-4, M=None):
    """Differentiable fused CGLS: returns ``x``; the backward is one CG
    solve on ``AᴴA + damp²`` (see :func:`cg_solve`)."""
    return _solve("cgls", Op, y, x0, niter, damp, tol, M, False)[0]


def block_cg_solve(Op, y, x0=None, *, niter: int = 10, tol: float = 1e-4,
                   M=None):
    """Differentiable block CG over ``(n, K)`` vectors: one block
    backward solve covers the K cotangent columns."""
    return _solve("cg", Op, y, x0, niter, 0.0, tol, M, True)[0]


def block_cgls_solve(Op, y, x0=None, *, niter: int = 10, damp: float = 0.0,
                     tol: float = 1e-4, M=None):
    """Differentiable block CGLS over ``(n, K)`` vectors (see
    :func:`block_cg_solve`, :func:`cgls_solve`)."""
    return _solve("cgls", Op, y, x0, niter, damp, tol, M, True)[0]


# ------------------------------------------------ the classic-entry shims
# The classic entries' reroute targets: the entries' return contracts,
# with x differentiable.
def entry_cg(Op, y, x0, niter, tol, M):
    return _solve("cg", Op, y, x0, niter, 0.0, tol, M, False)


def entry_cgls(Op, y, x0, niter, damp, tol, M):
    return _solve("cgls", Op, y, x0, niter, damp, tol, M, False)


def entry_block_cg(Op, y, x0, niter, tol, M):
    return _solve("cg", Op, y, x0, niter, 0.0, tol, M, True)


def entry_block_cgls(Op, y, x0, niter, damp, tol, M):
    return _solve("cgls", Op, y, x0, niter, damp, tol, M, True)
