"""Carry an operator's matrices and a problem's vectors into the port.

The tests build an operator with the JAX package, take its blocks as
numpy arrays (``[np.asarray(op.A) for op in jax_op.ops]``) and rebuild
the same operator here (``MPIBlockDiag``, ``MPIVStack``,
``MPIHStack``); a user with blocks on the host does the same.
Stacked vectors come over as (nested) lists of their components'
arrays. A frequency kernel ``(nfmax, ns, nr)`` comes over as one numpy
array (``np.asarray(jax_op.G)`` for ``MPIFredholm1``, or the array given
to the JAX package's ``MPIMDC``). The preconditioners come over as
their arrays: a Jacobi preconditioner's inverted diagonal
(``np.asarray(jax_M._dinv)``) and a block-Jacobi one's Cholesky factors
(``np.asarray(jax_M._chol)``); a sparse operator as its triplets
(``np.asarray(jax_op._rows)``, ``_cols``, ``_data``) and shape.

An operator's parameters come over as the JAX operator pytree's
inexact leaves, as numpy arrays in ``jax.tree_util.tree_leaves`` order
(:func:`operator_params_from_jax`), and gradients go back with
:func:`param_grads_to_jax`/:func:`grad_to_jax`. **The complex
convention is converted there, and only there:** for a real loss and a
complex input, ``jax.grad`` gives the conjugate of torch's ``.grad``
(``jax.grad(|z|²)(1+1j) = 2−2j``, torch's ``(z.abs()**2).backward()``
gives ``2+2j``); real gradients are the same in both.

A segmented solve's checkpoint, written by the JAX package with its
native backend, comes over through :func:`fused_carry_from_jax`, which
reads it without running any code the file names (numpy and builtins
only) and returns the port's carry for ``resume_state``.

Under a process group every rank passes the same global arrays, as the
JAX package's controller does, and keeps its own shard, its chunk of the
blocks or rows (the others stand in as :class:`~.ops.local.ShapeOnly`),
or its chunk of a kernel's slices; only what the rank keeps goes to the
device.
"""

from __future__ import annotations

import pickle
from typing import Sequence

import numpy as np
import torch

from .distributedarray import DistributedArray
from .stacked import StackedDistributedArray
from .ops._precision import as_torch_dtype
from .ops.blockdiag import MPIBlockDiag, _chunk_ops
from .ops.fredholm import MPIFredholm1
from .ops.matrixmult import MPIMatrixMult
from .ops.mdc import MPIMDC
from .ops.precond import BlockJacobiPrecond, JacobiPrecond
from .ops.sparse import MPISparseMatrixMult
from .ops.stack import MPIHStack, MPIVStack
from .ops.local import MatrixMult, ShapeOnly
from .parallel.mesh import DeviceLike, rank, resolve_device, world_size
from .parallel.partition import Partition

__all__ = ["blockdiag_from_numpy", "vstack_from_numpy", "hstack_from_numpy",
           "array_from_numpy", "stacked_from_numpy", "fredholm_from_numpy",
           "mdc_from_numpy", "matrixmult_from_numpy", "jacobi_from_numpy",
           "block_jacobi_from_numpy", "sparse_from_numpy",
           "fused_carry_from_jax", "operator_params_from_jax",
           "grad_to_jax", "grad_from_jax", "param_grads_to_jax"]


def _matrices(blocks: Sequence[np.ndarray], dtype,
              device: DeviceLike) -> list:
    """``MatrixMult`` of each block of this rank's chunk cast to ``dtype``
    (default: its own) on ``device`` (default ``"cuda"``), and a
    ``ShapeOnly`` of the same shape and dtype for every other block."""
    dev = resolve_device(device)
    dt = as_torch_dtype(dtype)
    mine = set(_chunk_ops(list(range(len(blocks))), world_size())[rank()])
    mats = []
    for i, b in enumerate(blocks):
        b = np.asarray(b)
        if i in mine:
            t = torch.tensor(b)
            mats.append(MatrixMult(t.to(device=dev, dtype=dt or t.dtype)))
        else:
            mats.append(ShapeOnly(b.shape[1], b.shape[0],
                                  dtype=dt or as_torch_dtype(b.dtype)))
    return mats


def blockdiag_from_numpy(blocks: Sequence[np.ndarray], dtype=None,
                         compute_dtype=None, device: DeviceLike = None,
                         mask=None) -> MPIBlockDiag:
    """``MPIBlockDiag([MatrixMult(b) for b in blocks], mask)`` with each
    block cast to ``dtype`` (default: its own); ``compute_dtype`` as for
    :class:`~.ops.blockdiag.MPIBlockDiag`. Every rank passes all the
    blocks; only the rank's own chunk is placed on ``device`` (default
    ``"cuda"``)."""
    return MPIBlockDiag(_matrices(blocks, dtype, device), mask=mask,
                        compute_dtype=compute_dtype)


def vstack_from_numpy(blocks: Sequence[np.ndarray], dtype=None,
                      compute_dtype=None, adjoint: bool = False,
                      device: DeviceLike = None, mask=None) -> MPIVStack:
    """``MPIVStack`` of ``MatrixMult(b)`` rows (``MatrixMult(b).H`` rows
    with ``adjoint``), blocks as for :func:`blockdiag_from_numpy`."""
    mats = _matrices(blocks, dtype, device)
    return MPIVStack([m.H for m in mats] if adjoint else mats, mask=mask,
                     compute_dtype=compute_dtype)


def hstack_from_numpy(blocks: Sequence[np.ndarray], dtype=None,
                      compute_dtype=None, device: DeviceLike = None,
                      mask=None) -> MPIHStack:
    """``MPIHStack([MatrixMult(b) for b in blocks])``, blocks as for
    :func:`blockdiag_from_numpy`."""
    return MPIHStack(_matrices(blocks, dtype, device), mask=mask,
                     compute_dtype=compute_dtype)


def array_from_numpy(x: np.ndarray, dtype=None,
                     partition: Partition = Partition.SCATTER, axis: int = 0,
                     device: DeviceLike = None, local_shapes=None,
                     mask=None) -> DistributedArray:
    """A :class:`DistributedArray` of the global ``x`` cast to ``dtype``
    on ``device`` (default ``"cuda"``): every rank passes the whole
    array and keeps its shard."""
    out = DistributedArray.to_dist(np.asarray(x), partition=partition,
                                   axis=axis, local_shapes=local_shapes,
                                   mask=mask, device=device)
    dt = as_torch_dtype(dtype)
    if dt is not None:
        out._arr = out._arr.to(dt)
    return out


def stacked_from_numpy(components: Sequence, dtype=None,
                       device: DeviceLike = None) -> StackedDistributedArray:
    """A (nested) :class:`StackedDistributedArray` from a list whose
    items are arrays (one SCATTER component each) or lists (a nested
    stack), cast to ``dtype`` on ``device`` (default ``"cuda"``)."""
    return StackedDistributedArray([
        stacked_from_numpy(c, dtype=dtype, device=device)
        if isinstance(c, (list, tuple))
        else array_from_numpy(c, dtype=dtype, device=device)
        for c in components])


def _kernel(G: np.ndarray, dtype) -> np.ndarray:
    """The whole kernel on the host, cast to ``dtype`` (a copy only when
    the dtype differs); the operator moves its chunk to the device."""
    G = np.asarray(G)
    dt = as_torch_dtype(dtype)
    if dt is None:
        return G
    return G.astype(torch.empty(0, dtype=dt).numpy().dtype, copy=False)


def fredholm_from_numpy(G: np.ndarray, nz: int = 1, dtype=None,
                        device: DeviceLike = None,
                        **kwargs) -> MPIFredholm1:
    """``MPIFredholm1`` of the kernel ``G (nsl, nx, ny)`` cast to
    ``dtype`` (default: its own, which is also the operator dtype), this
    rank's chunk of the slices on ``device`` (default ``"cuda"``);
    ``kwargs`` as for :class:`~.ops.fredholm.MPIFredholm1` (``saveGt``,
    ``compute_dtype``)."""
    K = _kernel(G, dtype)
    kwargs.setdefault("dtype", as_torch_dtype(K.dtype))
    return MPIFredholm1(K, nz=nz, device=resolve_device(device), **kwargs)


def mdc_from_numpy(G: np.ndarray, nt: int, nv: int, dtype=None,
                   device: DeviceLike = None, **kwargs):
    """``MPIMDC`` of the frequency kernel ``G (nfmax, ns, nr)`` cast to
    ``dtype`` (a complex dtype; default its own), this rank's chunk of
    the frequencies on ``device`` (default ``"cuda"``); ``kwargs`` as for
    :func:`~.ops.mdc.MPIMDC`."""
    return MPIMDC(_kernel(G, dtype), nt=nt, nv=nv,
                  device=resolve_device(device), **kwargs)


def matrixmult_from_numpy(A: np.ndarray, M: int, kind: str = "summa",
                          dtype=None, device: DeviceLike = None, **kwargs):
    """``MPIMatrixMult`` of the whole matrix ``A (N, K)`` cast to
    ``dtype`` (default: its own), this rank's rows or tile of it on
    ``device`` (default ``"cuda"``); ``kwargs`` as for
    :func:`~.ops.matrixmult.MPIMatrixMult` (``grid``, ``schedule``,
    ``saveAt``, ``compute_dtype``). From a JAX operator ``op``:
    ``matrixmult_from_numpy(np.asarray(op.A), op.M, kind, grid=op.grid)``
    (the block kind has no grid)."""
    K = _kernel(A, dtype)
    kwargs.setdefault("dtype", as_torch_dtype(K.dtype))
    return MPIMatrixMult(K, M, kind=kind, device=resolve_device(device),
                         **kwargs)


def jacobi_from_numpy(dinv: np.ndarray, dtype=None,
                      device: DeviceLike = None) -> JacobiPrecond:
    """A :class:`~.ops.precond.JacobiPrecond` whose inverted diagonal is
    ``dinv`` (the JAX object's ``_dinv``) cast to ``dtype``, on
    ``device`` (default ``"cuda"``)."""
    return JacobiPrecond.from_inverse(_kernel(dinv, dtype), device=device)


def block_jacobi_from_numpy(chol: np.ndarray, dtype=None,
                            device: DeviceLike = None) -> BlockJacobiPrecond:
    """A :class:`~.ops.precond.BlockJacobiPrecond` of the lower Cholesky
    factors ``chol (nblk, m, m)`` (the JAX object's ``_chol``) cast to
    ``dtype``; each rank keeps the factors covering its rows, on
    ``device`` (default ``"cuda"``)."""
    return BlockJacobiPrecond.from_factors(_kernel(chol, dtype),
                                           device=device)


def sparse_from_numpy(rows: np.ndarray, cols: np.ndarray, data: np.ndarray,
                      shape, dtype=None, device: DeviceLike = None,
                      **kwargs) -> MPISparseMatrixMult:
    """``MPISparseMatrixMult`` of the triplets ``(rows, cols, data)`` of
    a ``shape`` matrix (the JAX object's ``_rows``, ``_cols``,
    ``_data``), values cast to ``dtype``; each rank keeps the triplets
    of its rows on ``device`` (default ``"cuda"``); ``kwargs`` as for
    the operator (``compute_dtype``, ``adjoint_mode``)."""
    return MPISparseMatrixMult(rows, cols, _kernel(data, dtype), shape,
                               device=device, **kwargs)


# ------------------------------------------------------ JAX checkpoints
class _NumpyOnly(pickle.Unpickler):
    """An unpickler that builds numpy arrays, dtypes and scalars and
    builtins, and refuses every other class by name."""

    _NUMPY = {"_reconstruct", "scalar", "_frombuffer", "ndarray", "dtype"}
    _BUILTINS = {"complex", "set", "frozenset", "slice", "range",
                 "bytearray"}

    def find_class(self, module, name):
        top = module.split(".")[0]
        if (top == "numpy" and name in self._NUMPY) or \
                (module == "builtins" and name in self._BUILTINS):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"the checkpoint holds {module}.{name}, which is neither numpy "
            "nor a builtin: fused_carry_from_jax reads plain numpy "
            "checkpoints only and refuses to build it")


def fused_carry_from_jax(path: str, solver: str = None,
                         device: DeviceLike = None) -> dict:
    """The port's carry of a segmented solve checkpointed by the JAX
    package (``save_fused_carry`` with its native backend), for
    ``cg_segmented``/``cgls_segmented``/``block_cg_segmented``'s
    ``resume_state``: the solve resumes in the port where the JAX
    package stopped.

    The file is read through a restricted unpickler (numpy and builtins
    only; anything else refuses, naming it) and its sidecar of blobs
    with plain reads. ``solver`` (default: the file's) must match the
    file's loop family. Vectors land on ``device``, split over this
    world (regridded from the JAX package's device count); the cost
    histories gain the port's spare row; an unguarded carry's guard
    words are dropped, as the port's unguarded loops hold none."""
    from .utils import checkpoint as _ckpt
    enc = _ckpt._read_native(path, unpickler=_NumpyOnly)
    kind = enc.get("__fused__")
    state = _ckpt.check_fused(enc, path, solver or kind)
    dev = resolve_device(device)
    out = {k: _ckpt._decode(v, dev) for k, v in state.items()}
    niter = int(out["niter"])
    for name in ("cost", "cost1"):
        c = out.get(name)
        if isinstance(c, np.ndarray) and c.shape[0] == niter + 1:
            out[name] = np.concatenate([c, np.zeros_like(c[:1])])
    out.setdefault("it", np.asarray(out["iiter"]).reshape(1))
    if not out.get("guards"):
        for name in ("status", "bestk", "stall"):
            out[name] = None
    return out


# ------------------------------------------------ parameters and gradients
def _inexact(t: torch.Tensor) -> bool:
    return t.is_floating_point() or t.is_complex()


def operator_params_from_jax(Op, leaves: Sequence[np.ndarray]):
    """``Op`` over the JAX operator's parameter values: ``leaves`` are the
    JAX operator pytree's inexact leaves as numpy arrays, in
    ``tree_leaves`` order, matched one to one with the floating and
    complex tensors of :func:`~.linearoperator.operator_params` ``(Op)``
    (integer ones, such as sparse indices, are kept). Returns
    :func:`~.linearoperator.with_params` ``(Op, ...)`` over new tensors
    on the parameters' devices, at their dtypes."""
    from .linearoperator import operator_params, with_params
    params = operator_params(Op)
    slots = [i for i, t in enumerate(params) if _inexact(t)]
    leaves = list(leaves)
    if len(leaves) != len(slots):
        raise ValueError(f"{type(Op).__name__} has {len(slots)} inexact "
                         f"parameters, got {len(leaves)} leaves")
    new = list(params)
    for i, leaf in zip(slots, leaves):
        t = params[i]
        a = np.asarray(leaf)
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f"parameter {i} of {type(Op).__name__} has "
                             f"shape {tuple(t.shape)}, the leaf "
                             f"{tuple(a.shape)}")
        new[i] = torch.as_tensor(np.array(a)).to(device=t.device,
                                                 dtype=t.dtype)
    return with_params(Op, new)


def grad_to_jax(g) -> np.ndarray:
    """A torch gradient as the JAX package's cotangent, on the host: the
    conjugate for complex tensors, the same values for real ones."""
    if isinstance(g, torch.Tensor):
        g = g.detach().cpu().numpy()
    g = np.asarray(g)
    return np.conj(g) if np.iscomplexobj(g) else g


def grad_from_jax(g, like: torch.Tensor = None) -> torch.Tensor:
    """A JAX cotangent as torch's gradient (the inverse of
    :func:`grad_to_jax`), on ``like``'s device and dtype when given."""
    a = np.asarray(g)
    t = torch.as_tensor(np.conj(a) if np.iscomplexobj(a) else a)
    return t if like is None else t.to(device=like.device, dtype=like.dtype)


def param_grads_to_jax(grads: Sequence) -> list:
    """Parameter gradients (in :func:`~.linearoperator.operator_params`
    order, ``None`` for integer tensors) as the JAX operator's inexact
    leaf cotangents, in ``tree_leaves`` order: the inverse of
    :func:`operator_params_from_jax` for cotangents."""
    return [grad_to_jax(g) for g in grads if g is not None]
