"""Distributed linear-operator abstraction with lazy composition algebra.

PyTorch counterpart of ``pylops_mpi_tpu/linearoperator.py`` (the
reference's ``pylops_mpi/LinearOperator.py``). Operators map
:class:`DistributedArray` → :class:`DistributedArray`. The lazy wrappers
mirror ref ``LinearOperator.py:408-580``: ``_AdjointLinearOperator``
(swap mat/rmat), ``_TransposedLinearOperator`` (conj∘rmat∘conj),
``_ProductLinearOperator``, ``_ScaledLinearOperator``,
``_SumLinearOperator``, ``_PowerLinearOperator``,
``_ConjLinearOperator``. Stacked operators (``MPIStackedVStack``,
``MPIGradient``) take or return :class:`StackedDistributedArray`, which
the algebra passes through unchanged.

**Operator parameters** (the counterpart of the JAX package's
``register_operator_arrays``/``operator_is_jit_arg``,
``linearoperator.py:562-600``): :func:`register_operator_params` names,
per class, the attributes holding an operator's tensors or
sub-operators, in the JAX package's registration order.
:func:`operator_params` returns an operator's tensors in that order (the
JAX operator pytree's ``tree_leaves`` order), :func:`with_params` an
operator of the same structure over other tensors, and
:func:`params_registered` says whether every node of an operator is
registered. The autodiff rules, the implicit solves and
``batched_solve`` stand on these.
"""

from __future__ import annotations

import copy
from typing import Optional, Tuple

import numpy as np
import torch

from .diagnostics import trace as _trace
from .distributedarray import DistributedArray
from .stacked import StackedDistributedArray
from .ops._precision import as_torch_dtype, result_dtype
from .parallel.collectives import replicated
from .parallel.mesh import DeviceLike, resolve_device

__all__ = ["MPILinearOperator", "LinearOperator", "aslinearoperator",
           "asmpilinearoperator", "register_operator_params",
           "params_registered", "operator_params", "with_params"]


def _scalar_like(x) -> bool:
    """Python/numpy scalars and 0-d tensors or arrays."""
    if np.isscalar(x):
        return True
    return isinstance(x, (torch.Tensor, np.ndarray, np.generic)) \
        and np.ndim(x) == 0


class MPILinearOperator:
    """Abstract distributed linear operator
    (ref ``pylops_mpi/LinearOperator.py:16-168``).

    Subclasses implement ``_matvec``/``_rmatvec`` on
    :class:`DistributedArray`. ``Op`` wraps a local operator
    (:mod:`ops.local`) applied to the whole vector, gathered first when
    it is SCATTER.
    """

    def __init__(self, Op=None, shape: Optional[Tuple[int, int]] = None,
                 dtype=None):
        self.Op = Op
        if Op is not None:
            self.shape = Op.shape if shape is None else shape
            self.dtype = Op.dtype if dtype is None else as_torch_dtype(dtype)
        else:
            self.shape = shape
            self.dtype = as_torch_dtype(dtype)
        if not hasattr(self, "dims") or self.dims is None:
            self.dims = (self.shape[1],) if self.shape else None
        if not hasattr(self, "dimsd") or self.dimsd is None:
            self.dimsd = (self.shape[0],) if self.shape else None

    dims: Optional[Tuple[int, ...]] = None
    dimsd: Optional[Tuple[int, ...]] = None
    # per-rank shapes of the model (m) and data (n) vectors, where the
    # operator fixes them; None lets the vector keep its own split
    local_shapes_m = None
    local_shapes_n = None

    # Block (column-batched) applies: a ``(N, K)`` DistributedArray is K
    # model vectors sharing one apply. Operators whose ``_matvec`` and
    # ``_rmatvec`` widen their contraction over the trailing axis set
    # ``accepts_block``; the rest apply column by column.
    accepts_block = False

    # ------------------------------------------------------------- apply
    def _check(self, x, n: int) -> bool:
        if isinstance(x, StackedDistributedArray):
            if x.size != n:
                raise ValueError(f"dimension mismatch: operator {self.shape}, "
                                 f"stacked x of size {x.size}")
            return False
        block = (isinstance(x, DistributedArray) and x.ndim == 2
                 and x.global_shape[0] == n)
        if isinstance(x, DistributedArray) and not block \
                and x.global_shape != (n,):
            raise ValueError(
                f"dimension mismatch: operator {self.shape}, x {x.global_shape}")
        return block

    def matvec(self, x: DistributedArray) -> DistributedArray:
        """Forward apply with global-shape check
        (ref ``LinearOperator.py:170-192``); accepts ``(N,)`` or the
        block form ``(N, K)``. Opens a span (``trace.op_span``) tagged
        with the operator's class, shape and dtype; compositions nest."""
        block = self._check(x, self.shape[1])
        with _trace.op_span(self, "matvec"):
            if block and not self.accepts_block:
                return self._apply_columns(x, forward=True)
            return self._matvec(x)

    def rmatvec(self, x: DistributedArray) -> DistributedArray:
        """Adjoint apply with global-shape check
        (ref ``LinearOperator.py:206-230``); traced like :meth:`matvec`."""
        block = self._check(x, self.shape[0])
        with _trace.op_span(self, "rmatvec"):
            if block and not self.accepts_block:
                return self._apply_columns(x, forward=False)
            return self._rmatvec(x)

    def _apply_columns(self, x: DistributedArray, forward: bool):
        """Block fallback: apply to each column and stack the results."""
        fn = self._matvec if forward else self._rmatvec
        row_locals = tuple((s[0],) for s in x.local_shapes)
        cols = [fn(DistributedArray._wrap(x.array[:, j].contiguous(), x,
                                          global_shape=(x.global_shape[0],),
                                          local_shapes=row_locals))
                for j in range(x.global_shape[1])]
        like = cols[0]
        K = x.global_shape[1]
        return DistributedArray._wrap(
            torch.stack([c.array for c in cols], dim=1), like,
            global_shape=like.global_shape + (K,),
            local_shapes=tuple(tuple(s) + (K,) for s in like.local_shapes))

    def _local_apply(self, x: DistributedArray, forward: bool):
        """The wrapped local operator on the whole vector, as the JAX
        package applies it (``linearoperator.py:149-166``): a SCATTER
        vector is gathered first. The output keeps ``x``'s partition and
        mask, with the default split of its size; every rank computes the
        whole output and keeps its shard."""
        if self.Op is None:
            raise NotImplementedError
        v = x._global().reshape(-1)
        return DistributedArray.to_dist(
            self.Op.matvec(v) if forward else self.Op.rmatvec(v),
            partition=x.partition, mask=x.mask)

    def _matvec(self, x: DistributedArray) -> DistributedArray:
        return self._local_apply(x, True)

    def _rmatvec(self, x: DistributedArray) -> DistributedArray:
        return self._local_apply(x, False)

    # ------------------------------------------------- normal-equations
    # ``(u, q) = (Opᴴ Op x, Op x)`` — the CGLS hot pair. The default is
    # two sweeps; operators that produce both in one memory pass
    # (MPIBlockDiag's normal-product kernel) override ``_normal_matvec``
    # and set ``has_fused_normal``.
    has_fused_normal = False

    def normal_matvec(self, x: DistributedArray):
        """``(OpᴴOp x, Op x)``; traced like :meth:`matvec` (the default
        two sweeps nest their own ``matvec`` and ``rmatvec`` spans)."""
        with _trace.op_span(self, "normal_matvec"):
            return self._normal_matvec(x)

    def _normal_matvec(self, x: DistributedArray):
        q = self.matvec(x)
        return self.rmatvec(q), q

    # ----------------------------------------------------------- algebra
    def dot(self, x):
        """Operator-operator, operator-scalar or operator-vector product
        (ref ``LinearOperator.py:244-280``)."""
        if isinstance(x, MPILinearOperator):
            return _ProductLinearOperator(self, x)
        if _scalar_like(x):
            return _ScaledLinearOperator(self, x)
        if isinstance(x, StackedDistributedArray) or x.ndim == 1:
            return self.matvec(x)
        if x.ndim == 2 and x.global_shape[0] == self.shape[1]:
            return self.matvec(x)
        raise ValueError(f"expected 1-d DistributedArray or "
                         f"StackedDistributedArray, got {x.global_shape!r}")

    def adjoint(self):
        return self._adjoint()

    H = property(adjoint)

    def transpose(self):
        return self._transpose()

    T = property(transpose)

    def conj(self):
        return _ConjLinearOperator(self)

    def _adjoint(self):
        return _AdjointLinearOperator(self)

    def _transpose(self):
        return _TransposedLinearOperator(self)

    def __mul__(self, x):
        return self.dot(x)

    def __rmul__(self, x):
        if _scalar_like(x):
            return _ScaledLinearOperator(self, x)
        return NotImplemented

    def __matmul__(self, x):
        if _scalar_like(x):
            raise ValueError("Scalar not allowed, use * instead")
        return self.__mul__(x)

    def __rmatmul__(self, x):
        if _scalar_like(x):
            raise ValueError("Scalar not allowed, use * instead")
        return self.__rmul__(x)

    def __pow__(self, p):
        return _PowerLinearOperator(self, p)

    def __add__(self, x):
        return _SumLinearOperator(self, x)

    def __neg__(self):
        return _ScaledLinearOperator(self, -1)

    def __sub__(self, x):
        return self.__add__(-x)

    def checkpointed(self) -> "MPILinearOperator":
        """The operator with its applies under
        ``torch.utils.checkpoint`` (``use_reentrant=False``): under
        autograd its intermediates are recomputed in the backward pass
        instead of stored (JAX ``linearoperator.py:245-251``). No effect
        outside autograd."""
        return _CheckpointedLinearOperator(self)

    def todifferentiable(self, mode: str = "vjp",
                         params=None) -> "MPILinearOperator":
        """The operator with the adjoint autograd rules on its applies
        (JAX ``linearoperator.py:253-263``): see
        :class:`~pylops_mpi_tpu_torch.autodiff.DifferentiableOperator`."""
        from .autodiff.rules import make_differentiable
        return make_differentiable(self, mode=mode, params=params)

    def todense(self, device: DeviceLike = None) -> np.ndarray:
        """Dense matrix of the operator on the host, by applying it to
        each identity column (JAX ``linearoperator.py:265``): O(n)
        applies, for tests and small operators. Under a group the model
        columns follow ``local_shapes_m`` and every output is gathered,
        so every rank returns the same matrix. ``device`` (default: the
        operator's, else ``"cuda"``) holds the columns."""
        m, n = self.shape
        dev = resolve_device(device if device is not None
                             else getattr(self, "device", None))
        dt = torch.zeros((), dtype=self.dtype or torch.float64)
        if dt.dtype in (torch.bfloat16, torch.float16):
            dt = dt.float()
        out = np.zeros((m, n), dtype=dt.numpy().dtype)
        for j in range(n):
            e = torch.zeros(n, dtype=dt.dtype, device=dev)
            e[j] = 1
            col = self.matvec(DistributedArray.to_dist(
                e, local_shapes=self.local_shapes_m))
            out[:, j] = col.asarray().reshape(-1)
        return out

    def __repr__(self):
        M, N = self.shape
        dt = "unspecified dtype" if self.dtype is None else f"dtype={self.dtype}"
        return f"<{M}x{N} {self.__class__.__name__} with {dt}>"


LinearOperator = MPILinearOperator


class _AdjointLinearOperator(MPILinearOperator):
    """ref ``LinearOperator.py:408-421``"""

    accepts_block = True

    def __init__(self, A: MPILinearOperator):
        self.dims, self.dimsd = A.dimsd, A.dims
        self.local_shapes_m, self.local_shapes_n = (A.local_shapes_n,
                                                    A.local_shapes_m)
        super().__init__(shape=(A.shape[1], A.shape[0]), dtype=A.dtype)
        self.A = A

    def _matvec(self, x):
        return self.A.rmatvec(x)

    def _rmatvec(self, x):
        return self.A.matvec(x)


class _TransposedLinearOperator(MPILinearOperator):
    """transpose = conj ∘ rmatvec ∘ conj (ref ``LinearOperator.py:424-443``)"""

    accepts_block = True

    def __init__(self, A: MPILinearOperator):
        self.dims, self.dimsd = A.dimsd, A.dims
        self.local_shapes_m, self.local_shapes_n = (A.local_shapes_n,
                                                    A.local_shapes_m)
        super().__init__(shape=(A.shape[1], A.shape[0]), dtype=A.dtype)
        self.A = A

    def _matvec(self, x):
        return self.A.rmatvec(x.conj()).conj()

    def _rmatvec(self, x):
        return self.A.matvec(x.conj()).conj()


class _ProductLinearOperator(MPILinearOperator):
    """ref ``LinearOperator.py:446-466``"""

    accepts_block = True

    def __init__(self, A: MPILinearOperator, B: MPILinearOperator):
        if A.shape[1] != B.shape[0]:
            raise ValueError(f"cannot multiply {A} and {B}: shape mismatch")
        self.args = (A, B)
        self.dims, self.dimsd = B.dims, A.dimsd
        self.local_shapes_m, self.local_shapes_n = (B.local_shapes_m,
                                                    A.local_shapes_n)
        super().__init__(shape=(A.shape[0], B.shape[1]),
                         dtype=result_dtype(A.dtype, B.dtype))

    def _matvec(self, x):
        return self.args[0].matvec(self.args[1].matvec(x))

    def _rmatvec(self, x):
        return self.args[1].rmatvec(self.args[0].rmatvec(x))

    def _adjoint(self):
        A, B = self.args
        return B.H * A.H


def _conj_scalar(alpha):
    if isinstance(alpha, torch.Tensor):
        return alpha.conj()
    return np.conj(alpha)


class _ScaledLinearOperator(MPILinearOperator):
    """ref ``LinearOperator.py:469-496``"""

    accepts_block = True

    def __init__(self, A: MPILinearOperator, alpha):
        if not _scalar_like(alpha):
            raise ValueError("scalar expected as alpha")
        self.args = (A, alpha)
        self.dims, self.dimsd = A.dims, A.dimsd
        self.local_shapes_m, self.local_shapes_n = (A.local_shapes_m,
                                                    A.local_shapes_n)
        # a Python scalar promotes like a weak scalar in torch: a real
        # one keeps the operator's dtype, a complex one makes it complex
        dtype = A.dtype
        if A.dtype is not None:
            dtype = torch.result_type(torch.zeros((), dtype=A.dtype),
                                      torch.as_tensor(alpha)
                                      if isinstance(alpha, (np.ndarray,
                                                            np.generic))
                                      else alpha)
        super().__init__(shape=A.shape, dtype=dtype)

    def _alpha(self):
        """The factor; a tensor one is held by every rank, so its
        gradient sums the ranks' parts
        (:func:`~.parallel.collectives.replicated`)."""
        alpha = self.args[1]
        return replicated(alpha) if isinstance(alpha, torch.Tensor) \
            else alpha

    def _matvec(self, x):
        return self.args[0].matvec(x) * self._alpha()

    def _rmatvec(self, x):
        return self.args[0].rmatvec(x) * _conj_scalar(self._alpha())

    def _adjoint(self):
        A, alpha = self.args
        return A.H * _conj_scalar(alpha)


class _SumLinearOperator(MPILinearOperator):
    """ref ``LinearOperator.py:499-524``"""

    accepts_block = True

    def __init__(self, A: MPILinearOperator, B: MPILinearOperator):
        if A.shape != B.shape:
            raise ValueError(f"cannot add {A} and {B}: shape mismatch")
        self.args = (A, B)
        self.dims, self.dimsd = A.dims, A.dimsd
        self.local_shapes_m, self.local_shapes_n = (A.local_shapes_m,
                                                    A.local_shapes_n)
        super().__init__(shape=A.shape, dtype=result_dtype(A.dtype, B.dtype))

    def _matvec(self, x):
        return self.args[0].matvec(x) + self.args[1].matvec(x)

    def _rmatvec(self, x):
        return self.args[0].rmatvec(x) + self.args[1].rmatvec(x)

    def _adjoint(self):
        A, B = self.args
        return A.H + B.H


class _PowerLinearOperator(MPILinearOperator):
    """repeat-apply (ref ``LinearOperator.py:527-552``)"""

    accepts_block = True

    def __init__(self, A: MPILinearOperator, p: int):
        if A.shape[0] != A.shape[1]:
            raise ValueError("square operator expected")
        if not isinstance(p, (int, np.integer)) or p < 0:
            raise ValueError("non-negative integer expected as p")
        self.args = (A, int(p))
        self.dims, self.dimsd = A.dims, A.dimsd
        self.local_shapes_m, self.local_shapes_n = (A.local_shapes_m,
                                                    A.local_shapes_n)
        super().__init__(shape=A.shape, dtype=A.dtype)

    def _power(self, fun, x):
        res = x.copy()
        for _ in range(self.args[1]):
            res = fun(res)
        return res

    def _matvec(self, x):
        return self._power(self.args[0].matvec, x)

    def _rmatvec(self, x):
        return self._power(self.args[0].rmatvec, x)


class _ConjLinearOperator(MPILinearOperator):
    """ref ``LinearOperator.py:555-580``"""

    accepts_block = True

    def __init__(self, A: MPILinearOperator):
        self.dims, self.dimsd = A.dims, A.dimsd
        self.local_shapes_m, self.local_shapes_n = (A.local_shapes_m,
                                                    A.local_shapes_n)
        super().__init__(shape=A.shape, dtype=A.dtype)
        self.A = A

    def _matvec(self, x):
        return self.A.matvec(x.conj()).conj()

    def _rmatvec(self, x):
        return self.A.rmatvec(x.conj()).conj()

    def _adjoint(self):
        return _ConjLinearOperator(self.A.H)


class _CheckpointedLinearOperator(MPILinearOperator):
    """Applies under ``torch.utils.checkpoint`` (non-reentrant), which
    takes the distributed vectors as they are."""

    accepts_block = True

    def __init__(self, A: MPILinearOperator):
        self.dims, self.dimsd = A.dims, A.dimsd
        self.local_shapes_m, self.local_shapes_n = (A.local_shapes_m,
                                                    A.local_shapes_n)
        super().__init__(shape=A.shape, dtype=A.dtype)
        self.A = A

    @property
    def device(self):
        return getattr(self.A, "device", None)

    def _matvec(self, x):
        from torch.utils.checkpoint import checkpoint
        return checkpoint(self.A.matvec, x, use_reentrant=False)

    def _rmatvec(self, x):
        from torch.utils.checkpoint import checkpoint
        return checkpoint(self.A.rmatvec, x, use_reentrant=False)

    def _adjoint(self):
        return _CheckpointedLinearOperator(self.A.H)


def aslinearoperator(Op) -> MPILinearOperator:
    """Wrap a local operator as a distributed one
    (ref ``asmpilinearoperator``, ``LinearOperator.py:583-602``)."""
    if isinstance(Op, MPILinearOperator):
        return Op
    return MPILinearOperator(Op=Op)


asmpilinearoperator = aslinearoperator


# ------------------------------------------------------ operator parameters
# class -> the attributes holding its tensors or sub-operators, in order
_PARAMS = {}


def register_operator_params(cls, *attrs: str) -> None:
    """Name the attributes of ``cls`` that hold its parameters: tensors,
    sub-operators, or lists and tuples of them (JAX
    ``register_operator_arrays``). A class registered with no attributes
    holds none; an unregistered class makes :func:`operator_params`
    refuse the operator."""
    _PARAMS[cls] = tuple(attrs)


def _walk(node, out: list) -> None:
    if isinstance(node, torch.Tensor):
        out.append(node)
    elif isinstance(node, (list, tuple)):
        for v in node:
            _walk(v, out)
    elif node is None or _scalar_like(node) or isinstance(node, str):
        pass
    else:
        attrs = _PARAMS.get(type(node))
        if attrs is None:
            raise TypeError(
                f"{type(node).__name__} is not registered with "
                "linearoperator.register_operator_params, so its tensors "
                "are not known as parameters")
        for a in attrs:
            _walk(getattr(node, a), out)


def params_registered(Op) -> bool:
    """Every operator node of ``Op`` is of a registered class (JAX
    ``operator_is_jit_arg``): its parameters are known."""
    try:
        _walk(Op, [])
    except TypeError:
        return False
    return True


def operator_params(Op) -> list:
    """The tensors of ``Op``'s registered attributes, depth first in
    registration order (the JAX operator pytree's leaf order): block
    stacks, matrices, sparse values and indices, preconditioner factors,
    and the 0-d tensor factor of a scaled operator. Python scalars are
    not parameters. Raises ``TypeError`` for an unregistered class."""
    out: list = []
    _walk(Op, out)
    return out


def _swap(node, it):
    if isinstance(node, torch.Tensor):
        return next(it)
    if isinstance(node, (list, tuple)):
        return type(node)(_swap(v, it) for v in node)
    attrs = _PARAMS.get(type(node))
    if not attrs:
        return node
    new = copy.copy(node)
    for a in attrs:
        setattr(new, a, _swap(getattr(node, a), it))
    return new


def with_params(Op, tensors) -> MPILinearOperator:
    """An operator of ``Op``'s structure over ``tensors`` in place of
    :func:`operator_params` ``(Op)``: each node holding parameters is
    copied (shallowly) with them swapped in; the rest is shared."""
    tensors = list(tensors)
    want = len(operator_params(Op))
    if len(tensors) != want:
        raise ValueError(f"{type(Op).__name__} has {want} parameter "
                         f"tensors, got {len(tensors)}")
    return _swap(Op, iter(tensors))


register_operator_params(MPILinearOperator)
for _w in (_AdjointLinearOperator, _TransposedLinearOperator,
           _ConjLinearOperator, _CheckpointedLinearOperator):
    register_operator_params(_w, "A")
for _w in (_ProductLinearOperator, _ScaledLinearOperator,
           _SumLinearOperator, _PowerLinearOperator):
    register_operator_params(_w, "args")
