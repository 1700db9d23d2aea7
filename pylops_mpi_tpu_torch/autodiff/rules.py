"""Adjoint autograd rules for ``MPILinearOperator`` applies.

PyTorch counterpart of ``pylops_mpi_tpu/autodiff/rules.py``. autograd
could tape straight through an operator's ``matvec`` (its tensor ops,
the collectives' and the tap kernel's own Functions), but a linear
operator does not need the tape: the cotangent of ``y = A x`` with
respect to ``x`` is ``Aᴴ v``, which the operator already implements as
``rmatvec``, the same code path the solvers run. :class:`DifferentiableOperator`
puts that rule on each apply as one ``torch.autograd.Function``:

- its ``backward`` is the operator's own ``rmatvec`` (``matvec`` for the
  adjoint direction). torch's cotangents are conjugated already
  (``x.grad = Aᴴ y.grad``), so unlike the JAX package's rule no
  conjugation wraps it;
- its ``jvp`` (``mode="jvp"``, for ``torch.autograd.forward_ad``) is one
  more apply ``A dx``; a Function with both keeps their saved tensors
  apart (``save_for_backward``/``save_for_forward``);
- with ``params=True`` the operator's tensors (:func:`operator_params`)
  are inputs too. Their cotangent is :func:`param_cotangent`: one
  ``torch.autograd.grad`` of the apply with the vector held fixed, so the
  apply is traced once in the parameter direction only. Integer tensors
  (sparse rows and columns) get ``None``.

Complex convention: torch's ``.grad`` of a real loss with respect to a
complex tensor is the conjugate of ``jax.grad``'s
(:func:`~..convert.grad_to_jax` converts).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..linearoperator import (MPILinearOperator, operator_params,
                              params_registered, register_operator_params,
                              with_params)

__all__ = ["DifferentiableOperator", "make_differentiable",
           "transpose_apply", "param_cotangent", "zero_op_cotangent"]


def _flat(v) -> List[torch.Tensor]:
    from ..aot.graphs import _flat as flat
    return flat(v)


def _rebuild(template, tensors):
    from ..aot.graphs import _rebuild as rebuild
    return rebuild(template, iter(tensors))


def _apply(Op, x, direction: str):
    return Op.matvec(x) if direction == "matvec" else Op.rmatvec(x)


def _inexact(t: torch.Tensor) -> bool:
    return t.is_floating_point() or t.is_complex()


def transpose_apply(Op, v, direction: str = "matvec"):
    """The cotangent of one apply with respect to its vector, in torch's
    convention: ``Opᴴ v`` (``Op.rmatvec(v)``) for ``direction="matvec"``,
    ``Op v`` for ``"rmatvec"``. (The JAX package's ``transpose_apply``
    returns the unconjugated ``Opᵀ v``, the conjugate of this.)"""
    return Op.rmatvec(v) if direction == "matvec" else Op.matvec(v)


def param_cotangent(Op, x, v, direction: str = "matvec") -> list:
    """The cotangent of ``θ ↦ A(θ) x`` (``x`` held fixed) at ``v``: one
    ``torch.autograd.grad`` of the apply over detached copies of
    :func:`operator_params` ``(Op)``, returned in that order, with
    ``None`` for integer tensors. The only place the rules trace through
    an apply, and only in the parameter direction."""
    params = operator_params(Op)
    probes = [p.detach().requires_grad_(True) if _inexact(p) else p.detach()
              for p in params]
    wanted = [q for q in probes if q.requires_grad]
    if not wanted:
        return [None] * len(params)
    xd = _rebuild(x, [t.detach() for t in _flat(x)])
    with torch.enable_grad():
        y = _apply(with_params(Op, probes), xd, direction)
        # the components that do not depend on the parameters (a stack's
        # other operators) hold no graph
        pairs = [(o, g) for o, g in zip(_flat(y), _flat(v))
                 if o.requires_grad]
        grads = (torch.autograd.grad([o for o, _ in pairs], wanted,
                                     grad_outputs=[g for _, g in pairs],
                                     allow_unused=True)
                 if pairs else [None] * len(wanted))
    it = iter(grads)
    res = []
    for q in probes:
        if not q.requires_grad:
            res.append(None)
            continue
        g = next(it)
        res.append(torch.zeros_like(q) if g is None else g)
    return res


def zero_op_cotangent(Op) -> list:
    """All-zero cotangents of :func:`operator_params` ``(Op)`` (``None``
    for integer tensors)."""
    return [torch.zeros_like(p) if _inexact(p) else None
            for p in operator_params(Op)]


def _param_tangent(Op, x, dparams, direction: str):
    """``d/dε A(θ + ε dθ) x`` by two reverse passes: ``u ↦ (∂_θ A x)ᴴ u``
    is linear in ``u``, and the gradient in ``u`` of ``Re⟨(∂_θ A x)ᴴ u,
    dθ⟩`` is the tangent."""
    params = operator_params(Op)
    probes = [p.detach().requires_grad_(True) if _inexact(p) else p.detach()
              for p in params]
    pairs = [(q, d) for q, d in zip(probes, dparams)
             if q.requires_grad and d is not None]
    if not pairs:
        return None
    xd = _rebuild(x, [t.detach() for t in _flat(x)])
    with torch.enable_grad():
        y = _apply(with_params(Op, probes), xd, direction)
        outs = _flat(y)
        us = [torch.zeros_like(o, requires_grad=True) for o in outs]
        live = [(o, u) for o, u in zip(outs, us) if o.requires_grad]
        if not live:
            return None
        gs = torch.autograd.grad([o for o, _ in live],
                                 [q for q, _ in pairs],
                                 grad_outputs=[u for _, u in live],
                                 create_graph=True, allow_unused=True)
        s = sum(torch.vdot(g.reshape(-1), d.reshape(-1).to(g.dtype)).real
                for g, (_, d) in zip(gs, pairs) if g is not None)
        if not isinstance(s, torch.Tensor):
            return None
        ts = torch.autograd.grad(s, us, allow_unused=True)
    return _rebuild(y, [torch.zeros_like(o) if t is None else t.detach()
                        for o, t in zip(outs, ts)])


class _Spec:
    """What a rule's Function carries besides its tensors."""

    def __init__(self, Op, direction, mode, nparams, xtmpl):
        self.Op = Op
        self.direction = direction
        self.mode = mode
        self.nparams = nparams
        self.xtmpl = xtmpl
        self.ytmpl = None


class _ApplyFn(torch.autograd.Function):
    """One apply with the adjoint as its backward and ``A dx`` as its
    forward-mode tangent (module docstring)."""

    @staticmethod
    def forward(ctx, spec, *tensors):
        x = _rebuild(spec.xtmpl, tensors[spec.nparams:])
        y = _apply(spec.Op, x, spec.direction)
        spec.ytmpl = y
        ctx.spec = spec
        ctx.save_for_backward(*tensors)
        ctx.save_for_forward(*tensors)
        return tuple(_flat(y))

    @staticmethod
    def backward(ctx, *gys):
        spec = ctx.spec
        saved = ctx.saved_tensors
        v = _rebuild(spec.ytmpl, gys)
        if any(ctx.needs_input_grad[1 + spec.nparams:]):
            gx = _flat(transpose_apply(spec.Op, v, spec.direction))
        else:
            gx = [None] * (len(saved) - spec.nparams)
        gp = [None] * spec.nparams
        if spec.nparams and any(ctx.needs_input_grad[1:1 + spec.nparams]):
            x = _rebuild(spec.xtmpl, saved[spec.nparams:])
            gp = param_cotangent(spec.Op, x, v, spec.direction)
        return (None, *gp, *gx)

    @staticmethod
    def jvp(ctx, _spec_t, *tangents):
        spec = ctx.spec
        if spec.mode != "jvp":
            raise RuntimeError(
                "forward-mode AD through a mode='vjp' DifferentiableOperator "
                "(as through the JAX package's custom_vjp rule); build it "
                "with mode='jvp'")
        saved = ctx.saved_tensors
        dx = tangents[spec.nparams:]
        dx = [torch.zeros_like(t) if d is None else d
              for t, d in zip(saved[spec.nparams:], dx)]
        dy = _flat(_apply(spec.Op, _rebuild(spec.xtmpl, dx), spec.direction))
        if spec.nparams:
            x = _rebuild(spec.xtmpl, saved[spec.nparams:])
            extra = _param_tangent(spec.Op, x, tangents[:spec.nparams],
                                   spec.direction)
            if extra is not None:
                dy = [a + b for a, b in zip(dy, _flat(extra))]
        return tuple(dy)


class DifferentiableOperator(MPILinearOperator):
    """The adjoint autograd rules on an operator's applies (JAX
    ``DifferentiableOperator``). Shape, dtype and block routing are the
    wrapped operator's; under ``torch.autograd`` (``mode="vjp"``, reverse)
    or ``torch.autograd.forward_ad`` (``mode="jvp"``, forward, and
    reverse too) the apply differentiates by the hand-written adjoint.

    ``params=True`` also gives cotangents (and tangents) to the
    operator's own tensors, which needs every node registered
    (:func:`~..linearoperator.params_registered`); ``None`` resolves to
    that predicate, and an operator with an unregistered node gets the
    vector-only rule."""

    accepts_block = True

    def __init__(self, A: MPILinearOperator, mode: str = "vjp",
                 params=None):
        if isinstance(A, DifferentiableOperator):  # idempotent
            A = A.A
        if mode not in ("vjp", "jvp"):
            raise ValueError(f"mode={mode!r}: expected 'vjp' or 'jvp'")
        registered = params_registered(A)
        if params is None:
            params = registered
        elif params and not registered:
            raise ValueError(
                "params=True needs every operator node registered "
                "(linearoperator.register_operator_params); got "
                + type(A).__name__)
        self._mode = mode
        self._params = bool(params)
        self.dims, self.dimsd = A.dims, A.dimsd
        self.local_shapes_m, self.local_shapes_n = (A.local_shapes_m,
                                                    A.local_shapes_n)
        super().__init__(shape=A.shape, dtype=A.dtype)
        self.A = A

    @property
    def device(self):
        return getattr(self.A, "device", None)

    def _rule(self, x, direction: str):
        A = self.A
        params = operator_params(A) if self._params else []
        xs = _flat(x)
        spec = _Spec(A, direction, self._mode, len(params), x)
        outs = _ApplyFn.apply(spec, *params, *xs)
        return _rebuild(spec.ytmpl, outs)

    def _matvec(self, x):
        return self._rule(x, "matvec")

    def _rmatvec(self, x):
        return self._rule(x, "rmatvec")

    def _adjoint(self):
        return DifferentiableOperator(self.A.H, mode=self._mode,
                                      params=self._params)

    def aot_signature(self):
        from ..aot.signature import op_signature
        return ("diff", self._mode, self._params, op_signature(self.A))


def make_differentiable(Op: MPILinearOperator, mode: str = "vjp",
                        params: Optional[bool] = None) -> DifferentiableOperator:
    """``Op`` with the adjoint autograd rules: see
    :class:`DifferentiableOperator`."""
    return DifferentiableOperator(Op, mode=mode, params=params)


register_operator_params(DifferentiableOperator, "A")
