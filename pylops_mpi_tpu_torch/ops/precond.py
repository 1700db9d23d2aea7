"""Preconditioners for the fused Krylov solvers.

PyTorch counterpart of ``pylops_mpi_tpu/ops/precond.py``. Three SPD
approximate inverses, each an :class:`MPILinearOperator`, so the solver
seam (``cg(..., M=...)``, ``cgls(..., M=...)``, the block solvers and
the CA engines) applies them like any operator:

- :class:`JacobiPrecond`, ``M = diag(A)⁻¹``, from an operator's own
  ``diagonal()``, lattice probing (``probe_diagonal`` with ``dims`` or
  ``stride``) or basis probing of a small operator;
- :class:`BlockJacobiPrecond`, dense ``m×m`` diagonal blocks factored
  once (``torch.linalg.cholesky_ex``; a block whose factorization fails
  gets an SPD eigenvalue clamp), ``L⁻¹`` formed once from the factor,
  and applied as two batched products ``L⁻ᴴ(L⁻¹ r)``;
- :class:`VCyclePrecond`, geometric multigrid: one V-cycle with a
  weighted-Jacobi smoother, factor-2 averaging restriction and
  piecewise-constant prolongation per grid axis, the level operators
  re-discretized by a user factory, and a dense Cholesky (or
  pseudo-inverse) solve on the coarsest grid.

All take block ``(n, K)`` vectors (``accepts_block``): K columns in one
apply. The factorizations are ``jax.scipy.linalg.cho_factor``/
``cho_solve`` in the JAX package, outside Pallas, so library calls
carry them here too. The block-Jacobi apply reads the triangular
inverse instead of solving with the factor: on an H100 a batched
``torch.cholesky_solve`` of one right-hand side took 36 ms for 32
factors of 4096² f32 (28× the 1.28 ms that reading them twice takes),
where the two batched products run at the memory rate; the two agree
to the factor's condition times the rounding unit.

Across ranks the applies work on the rank's shard, where the JAX
package works on the global vector and lets XLA partition it:

- a Jacobi apply is local (every rank holds the whole ``diag⁻¹`` and
  multiplies its rows);
- a rank of a block-Jacobi preconditioner holds the factors of a range
  of blocks: those covering its rows of the default split when built
  from all blocks, its operator chunk's with :meth:`from_block_diag`.
  When every rank's shard is exactly its range of blocks the apply is
  local. Otherwise it gathers ``x`` (one ``all_gather``) and solves the
  blocks covering the rank's rows; if those lie outside its range, the
  ranks also gather their solved ranges (a second ``all_gather``);
- a V-cycle's level applies are the level operators' own. Restriction
  and prolongation are local when every rank's rows are whole pairs of
  grid rows that map onto its coarse shard; otherwise the level vector
  is gathered. The coarsest solve gathers the coarse residual (one
  ``all_gather`` a cycle) and solves it on every rank.
"""

from __future__ import annotations

import itertools
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..distributedarray import DistributedArray, Partition
from ..linearoperator import MPILinearOperator
from ..parallel import collectives
from ..parallel.mesh import (DeviceLike, check_mesh, initialized, rank,
                             resolve_device, world_size)
from ..parallel.partition import local_split, shard_offsets
from ..utils.deps import mg_levels_default, precond_default
from ._precision import as_torch_dtype

__all__ = ["JacobiPrecond", "BlockJacobiPrecond", "VCyclePrecond",
           "probe_diagonal", "make_precond"]


def _np_dtype(dt) -> np.dtype:
    dt = as_torch_dtype(dt) or torch.float64
    return torch.empty(0, dtype=dt).numpy().dtype


def _name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


def _group() -> bool:
    return initialized() and world_size() > 1


def _to_device(a, dtype, device: DeviceLike) -> torch.Tensor:
    """``a`` as a tensor of ``dtype``: a tensor stays on its device
    unless ``device`` is given, anything else goes to ``device``
    (default ``"cuda"``)."""
    if isinstance(a, torch.Tensor):
        t = a if device is None else a.to(resolve_device(device))
    else:
        t = torch.tensor(np.asarray(a), device=resolve_device(device))
    dt = as_torch_dtype(dtype)
    return t if dt is None else t.to(dt)


def _chk_sum(t: torch.Tensor) -> float:
    return float(torch.nansum(t.detach().abs().double()))


def _chk(total: float) -> str:
    """Content checksum of a preconditioner signature (the JAX
    package's format)."""
    return f"{total:.6e}"


def _rows_of(x: DistributedArray) -> Tuple[Tuple[int, int], ...]:
    """Every rank's ``[start, stop)`` rows of ``x`` along axis 0; the
    whole array on every rank when it is not split."""
    n = x.global_shape[0]
    if not x._scattered():
        return ((0, n),) * world_size()
    sizes = x._axis_sizes()
    return tuple((o, o + s) for o, s in zip(shard_offsets(sizes), sizes))


# ------------------------------------------------------------- probing
def probe_diagonal(Op, *, dims: Optional[Tuple[int, ...]] = None,
                   reach: int = 1, stride: Optional[int] = None,
                   nmax: int = 2048, device: DeviceLike = None
                   ) -> torch.Tensor:
    """``diag(Op)`` (JAX ``ops/precond.py:62-126``), the whole diagonal
    on every rank:

    1. ``Op.diagonal()`` when the operator has one (a rank's piece of an
       ``MPIBlockDiag`` is gathered);
    2. ``dims``: lattice probing on the grid with per-axis stride
       ``2·reach + 1``, ``(2·reach+1)^ndim`` applies, exact for stencils
       of reach ``<= reach``;
    3. ``stride``: the 1-D lattice (bandwidth ``< stride``);
    4. else ``n`` basis probes, refused above ``nmax``.

    The probes live on ``device``, default the operator's."""
    diag_fn = getattr(Op, "diagonal", None)
    if callable(diag_fn):
        d = torch.as_tensor(diag_fn())
        from .blockdiag import MPIBlockDiag, _chunk_ops
        if isinstance(Op, MPIBlockDiag) and _group():
            sizes = [int(sum(min(Op.nops[i], Op.mops[i]) for i in c))
                     for c in _chunk_ops(list(range(len(Op.nops))),
                                         world_size())]
            d = collectives.all_gather(d.contiguous(), sizes)
        return d
    n = int(Op.shape[1])
    dt = _np_dtype(Op.dtype)
    dev = resolve_device(device if device is not None
                         else getattr(Op, "device", None))

    def apply(e: np.ndarray) -> np.ndarray:
        v = Op.matvec(DistributedArray.to_dist(
            torch.from_numpy(e).to(dev), local_shapes=Op.local_shapes_m))
        return np.asarray(v.asarray()).reshape(-1)

    d = np.zeros(n, dtype=dt)
    if dims is not None:
        dims = tuple(int(v) for v in dims)
        if int(np.prod(dims)) != n:
            raise ValueError(f"dims {dims} do not flatten to n={n}")
        s = 2 * int(reach) + 1
        grid = np.indices(dims)
        flat_ix = np.arange(n).reshape(dims)
        for offs in itertools.product(*(range(min(s, dd)) for dd in dims)):
            sel = np.ones(dims, dtype=bool)
            for ax, o in enumerate(offs):
                sel &= (grid[ax] % s) == o
            e = np.zeros(n, dtype=dt)
            e[flat_ix[sel]] = 1
            d[flat_ix[sel]] = apply(e)[flat_ix[sel]]
    elif stride is not None:
        s = int(stride)
        for o in range(min(s, n)):
            e = np.zeros(n, dtype=dt)
            e[o::s] = 1
            d[o::s] = apply(e)[o::s]
    else:
        if n > nmax:
            raise ValueError(
                f"probe_diagonal would need {n} matvecs (> nmax={nmax}); "
                "pass dims=/stride= for lattice probing, or give the "
                "operator a diagonal() method")
        for j in range(n):
            e = np.zeros(n, dtype=dt)
            e[j] = 1
            d[j] = apply(e)[j]
    return torch.from_numpy(d).to(dev)


# -------------------------------------------------------------- Jacobi
class JacobiPrecond(MPILinearOperator):
    """Diagonal preconditioner ``M x = x / diag`` (JAX
    ``ops/precond.py:144-186``). Entries of magnitude ``<= tiny`` pass
    through unscaled. ``diag`` is the whole diagonal (every rank passes
    it); the apply scales the rank's rows, with no communication."""

    accepts_block = True

    def __init__(self, diag, mesh=None, dtype=None, tiny: float = 1e-30, *,
                 device: DeviceLike = None):
        check_mesh(mesh)
        d = _to_device(diag, dtype, device)
        self._dinv = torch.where(d.abs() > tiny, 1.0 / d, torch.ones_like(d))
        self._init(d)

    def _init(self, d: torch.Tensor) -> None:
        n = int(d.shape[0])
        super().__init__(shape=(n, n), dtype=d.dtype)
        self._sig = f"jacobi[{n},{_name(self.dtype)},{_chk(_chk_sum(d))}]"

    @classmethod
    def from_operator(cls, Op, **probe_kw) -> "JacobiPrecond":
        return cls(probe_diagonal(Op, **probe_kw), dtype=Op.dtype)

    @classmethod
    def from_inverse(cls, dinv, device: DeviceLike = None) -> "JacobiPrecond":
        """From the inverted diagonal itself (the JAX object's
        ``_dinv``), bit for bit."""
        self = cls.__new__(cls)
        self._dinv = _to_device(dinv, None, device)
        self._init(1.0 / self._dinv)
        return self

    @property
    def device(self) -> torch.device:
        return self._dinv.device

    def precond_signature(self) -> str:
        return self._sig

    def _apply(self, x: DistributedArray, d: torch.Tensor):
        a, b = _rows_of(x)[rank()]
        dl = d[a:b].to(x.dtype)
        arr = x.array
        if arr.ndim == 2:
            dl = dl[:, None]
        return DistributedArray._wrap(arr * dl, x)

    def _matvec(self, x):
        return self._apply(x, self._dinv)

    def _rmatvec(self, x):
        return self._apply(x, self._dinv.conj())


# -------------------------------------------------------- block-Jacobi
def _cover_ranges(n: int, m: int, P: int):
    """Per rank, the ``[lo, hi)`` blocks of size ``m`` covering its rows
    of the default split of ``n``."""
    sizes = [s[0] for s in local_split((n,), P, Partition.SCATTER, 0)]
    out = []
    for a, s in zip(shard_offsets(sizes), sizes):
        lo = a // m
        out.append((lo, -(-(a + s) // m) if s else lo))
    return tuple(out)


class BlockJacobiPrecond(MPILinearOperator):
    """Block-Jacobi preconditioner (JAX ``ops/precond.py:189-321``):
    ``nblk`` dense ``m×m`` diagonal blocks, symmetrized and
    ridge-shifted (``ridge="auto"`` adds ``1e-6·mean|diag|``), factored
    once with ``torch.linalg.cholesky_ex``; a block whose factorization
    reports failure (``info != 0``) is replaced by its SPD eigenvalue
    clamp; the apply multiplies by ``L⁻¹`` and ``L⁻ᴴ`` (see the module
    doc). ``blocks`` is the whole ``(nblk, m, m)`` stack (every rank
    passes it); a rank factors the blocks covering its rows of the
    default split."""

    accepts_block = True

    def __init__(self, blocks, mesh=None, dtype=None, ridge="auto", *,
                 device: DeviceLike = None):
        check_mesh(mesh)
        B = _to_device(blocks, dtype, device)
        if B.ndim != 3 or B.shape[1] != B.shape[2]:
            raise ValueError(f"blocks must be (nblk, m, m), got "
                             f"{tuple(B.shape)}")
        nblk, m = int(B.shape[0]), int(B.shape[1])
        dsym = self._sym_diag(B)
        if ridge == "auto":
            ridge = 1e-6 * float(torch.mean(dsym.abs()))
        ranges = _cover_ranges(nblk * m, m, world_size())
        lo, hi = ranges[rank()]
        self._factor(B[lo:hi], ranges, nblk, m, ridge)
        self._sig_of(_chk_sum(dsym + ridge) if ridge else _chk_sum(dsym))

    @staticmethod
    def _sym_diag(B: torch.Tensor) -> torch.Tensor:
        d = torch.diagonal(B, dim1=1, dim2=2)
        return 0.5 * (d + d.conj())

    def _factor(self, B: torch.Tensor, ranges, nblk: int, m: int,
                ridge) -> None:
        """Symmetrize, shift and factor this rank's blocks ``B``."""
        self.nblk, self.m, self._ranges = nblk, m, tuple(ranges)
        B = 0.5 * (B + B.mH)
        if ridge:
            B = B + ridge * torch.eye(m, dtype=B.dtype, device=B.device)
        chol, info = torch.linalg.cholesky_ex(B)
        bad = (info != 0).cpu().numpy()
        if bad.any():
            # an indefinite block (probed approximations can be) gets a
            # nearby SPD apply: its eigenvalues clamped to a floor
            Bn = B.cpu().numpy().copy()
            for i in np.nonzero(bad)[0]:
                w, v = np.linalg.eigh(Bn[i])
                floor = 1e-6 * max(float(np.max(np.abs(w))), 1e-30)
                Bn[i] = (v * np.maximum(w, floor)) @ v.conj().T
            chol, _ = torch.linalg.cholesky_ex(
                torch.from_numpy(Bn).to(B.device))
        self._set_factor(chol)
        self.clamped = int(bad.sum())
        n = nblk * m
        MPILinearOperator.__init__(self, shape=(n, n), dtype=chol.dtype)

    def _set_factor(self, chol: torch.Tensor) -> None:
        """Keep the lower factors and their inverses."""
        self._chol = chol
        eye = torch.eye(self.m, dtype=chol.dtype, device=chol.device)
        self._linv = torch.linalg.solve_triangular(
            chol, eye.expand_as(chol), upper=False) if chol.numel() \
            else chol.clone()

    def _sig_of(self, total: float) -> None:
        self._sig = (f"block_jacobi[{self.nblk}x{self.m},{_name(self.dtype)},"
                     f"{_chk(total)}]")

    @classmethod
    def from_factors(cls, chol, device: DeviceLike = None
                     ) -> "BlockJacobiPrecond":
        """From lower Cholesky factors ``(nblk, m, m)`` (the JAX
        object's ``_chol``), bit for bit; a rank keeps the factors
        covering its rows of the default split."""
        self = cls.__new__(cls)
        L = _to_device(chol, None, device)
        nblk, m = int(L.shape[0]), int(L.shape[1])
        self.nblk, self.m = nblk, m
        self._ranges = _cover_ranges(nblk * m, m, world_size())
        lo, hi = self._ranges[rank()]
        self._set_factor(L[lo:hi].contiguous())
        self.clamped = 0
        MPILinearOperator.__init__(self, shape=(nblk * m,) * 2,
                                   dtype=L.dtype)
        self._sig_of(_chk_sum((L.abs() ** 2).sum(dim=2)))
        return self

    @classmethod
    def from_operator(cls, Op, block_size: int, *, normal: bool = False,
                      damp: float = 0.0, device: DeviceLike = None,
                      **kw) -> "BlockJacobiPrecond":
        """Probe ``Op`` (or ``OpᴴOp + damp²`` with ``normal=True``) with
        ``block_size`` lattice indicators: probe ``j`` lights every index
        ``≡ j (mod m)`` and yields column ``j`` of every diagonal block,
        exact for block-diagonal operators; ``m`` applies in all."""
        n = int(Op.shape[1])
        m = int(block_size)
        if n % m:
            raise ValueError(f"block_size {m} does not divide n={n}")
        nblk = n // m
        dt = _np_dtype(Op.dtype)
        dev = resolve_device(device if device is not None
                             else getattr(Op, "device", None))
        damp2 = damp ** 2
        cols = np.zeros((nblk, m, m), dtype=dt)
        for j in range(m):
            e = np.zeros(n, dtype=dt)
            e[j::m] = 1
            ed = DistributedArray.to_dist(torch.from_numpy(e).to(dev),
                                          local_shapes=Op.local_shapes_m)
            if normal:
                qv = np.asarray(Op.rmatvec(Op.matvec(ed)).asarray()) \
                    + damp2 * e
            else:
                qv = np.asarray(Op.matvec(ed).asarray())
            cols[:, :, j] = qv.reshape(nblk, m)
        return cls(cols, dtype=Op.dtype, device=dev, **kw)

    @classmethod
    def from_block_diag(cls, Op, *, normal: bool = False, damp: float = 0.0,
                        ridge="auto") -> "BlockJacobiPrecond":
        """From an ``MPIBlockDiag`` of homogeneous batched blocks, with
        no probes: each rank factors the blocks of its own chunk
        (``Op._batched``), ``AᵢᴴAᵢ + damp²`` with ``normal=True`` (the
        CGLS normal-system blocks, square even when the blocks are
        not). The ridge's mean takes one ``all_reduce`` under a
        group."""
        from .blockdiag import _chunk_ops
        A = getattr(Op, "_batched", None)
        if A is None and getattr(Op, "ops", None):
            raise ValueError(
                "from_block_diag needs an MPIBlockDiag with a batched "
                "homogeneous block stack; use from_operator instead")
        nops, mops = np.asarray(Op.nops), np.asarray(Op.mops)
        if len(set(nops)) != 1 or len(set(mops)) != 1:
            raise ValueError("from_block_diag needs blocks of one shape")
        rows, cols = int(nops[0]), int(mops[0])
        if not normal and rows != cols:
            raise ValueError(
                f"blocks are {rows}x{cols} (not square); only the "
                "normal=True form is SPD-invertible")
        nblk = len(nops)
        m = cols if normal else rows
        if A is None:  # a rank with no blocks
            G = torch.zeros((0, m, m), dtype=Op.dtype)
        else:
            B = A.to(Op.dtype)
            if normal:
                G = torch.einsum("bij,bjk->bik", B.mH, B)
                if damp:
                    G = G + (damp ** 2) * torch.eye(m, dtype=G.dtype,
                                                    device=G.device)
            else:
                G = B
        dsym = cls._sym_diag(G)
        if ridge == "auto":
            tot = torch.sum(dsym.abs()).reshape(1).to(torch.float64)
            if _group():
                tot = collectives.all_reduce(tot.contiguous(), "sum")
            ridge = 1e-6 * float(tot[0]) / (nblk * m)
        chunks = _chunk_ops(list(range(nblk)), world_size())
        ranges = tuple((c[0], c[-1] + 1) if c else
                       (sum(len(q) for q in chunks[:i]),) * 2
                       for i, c in enumerate(chunks))
        self = cls.__new__(cls)
        self._factor(G, ranges, nblk, m, ridge)
        tot = torch.tensor([_chk_sum(dsym + ridge) if ridge
                            else _chk_sum(dsym)], dtype=torch.float64)
        if _group():
            tot = collectives.all_reduce(tot, "sum")
        self._sig_of(float(tot[0]))
        return self

    @property
    def device(self) -> torch.device:
        return self._chol.device

    def precond_signature(self) -> str:
        return self._sig

    def _solve(self, rows: torch.Tensor, first: int) -> torch.Tensor:
        """The solves of ``rows`` (whole blocks, starting at this rank's
        kept block ``first``), ``L⁻ᴴ(L⁻¹ r)``, in ``rows``' dtype."""
        nb = rows.shape[0] // self.m
        # a rank with no blocks holds empty host factors
        Li = self._linv[first:first + nb].to(rows.device)
        rb = rows.reshape(nb, self.m, -1).to(Li.dtype)
        out = torch.bmm(Li.mH, torch.bmm(Li, rb))
        return out.reshape(rows.shape).to(rows.dtype)

    def _matvec(self, x: DistributedArray) -> DistributedArray:
        m, me = self.m, rank()
        rows = _rows_of(x)
        lo, hi = self._ranges[me]
        if all(a == l * m and b == h * m
               for (a, b), (l, h) in zip(rows, self._ranges)):
            return DistributedArray._wrap(self._solve(x.array, 0), x)
        g = x._global()
        a, b = rows[me]
        if all(l <= ra // m and -(-rb // m) <= h
               for (ra, rb), (l, h) in zip(rows, self._ranges)):
            blo, bhi = a // m, -(-b // m)
            piece = self._solve(g[blo * m:bhi * m], blo - lo)
            return DistributedArray._wrap(
                piece[a - blo * m:b - blo * m].contiguous(), x)
        # the ranks' own solved ranges, gathered and laid out whole
        piece = self._solve(g[lo * m:hi * m], 0)
        full = collectives.all_gather(
            piece.contiguous(), [(h - l) * m for l, h in self._ranges])
        out = torch.empty_like(g)
        off = 0
        for l, h in self._ranges:
            out[l * m:h * m] = full[off:off + (h - l) * m]
            off += (h - l) * m
        return DistributedArray._wrap(out[a:b].contiguous(), x)

    _rmatvec = _matvec  # symmetric


# ------------------------------------------------------------- V-cycle
def _restrict(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Factor-2 averaging over the first ``ndim`` axes (cell-centred:
    each coarse cell the mean of its two children along every axis)."""
    for ax in range(ndim):
        idx = (slice(None),) * ax
        t = 0.5 * (t[idx + (slice(0, None, 2),)]
                   + t[idx + (slice(1, None, 2),)])
    return t


def _prolong(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Piecewise-constant injection over the first ``ndim`` axes (the
    restriction's adjoint up to the averaging factor, so the cycle stays
    symmetric up to a positive scalar)."""
    for ax in range(ndim):
        t = torch.repeat_interleave(t, 2, dim=ax)
    return t


class VCyclePrecond(MPILinearOperator):
    """Geometric multigrid V-cycle (JAX ``ops/precond.py:345-460``).

    ``op_factory(dims)`` returns the operator discretized on the
    ``dims`` grid (shape ``(prod(dims), prod(dims))``). Per level the
    constructor probes the diagonal on the lattice for the weighted
    Jacobi smoother; the coarsest level is densified (``todense``) and
    factored once (Cholesky, or ``pinv`` where the symmetrized coarse
    matrix is not positive definite). The grid coarsens by 2 per axis
    while every axis stays even and ``> 2``, up to ``levels`` (default
    ``PYLOPS_MPI_TPU_TORCH_MG_LEVELS``). One apply is one V-cycle with
    ``nu_pre``/``nu_post`` sweeps of weight ``omega``."""

    accepts_block = True

    def __init__(self, op_factory: Callable, dims: Sequence[int], *,
                 levels: Optional[int] = None, nu_pre: int = 1,
                 nu_post: int = 1, omega: float = 2.0 / 3.0,
                 reach: int = 1, coarsest_max: int = 4096,
                 mesh=None, dtype=None, device: DeviceLike = None):
        check_mesh(mesh)
        dims = tuple(int(d) for d in dims)
        if levels is None:
            levels = mg_levels_default()
        self.omega = float(omega)
        self.nu_pre, self.nu_post = int(nu_pre), int(nu_post)
        level_dims = [dims]
        while (len(level_dims) < levels
               and all(d % 2 == 0 and d > 2 for d in level_dims[-1])):
            level_dims.append(tuple(d // 2 for d in level_dims[-1]))
        self.level_dims = level_dims
        P, me = world_size(), rank()
        self._ops, self._dinv, self._sizes = [], [], []
        for dl in level_dims:
            op = op_factory(dl)
            nl = int(np.prod(dl))
            if tuple(op.shape) != (nl, nl):
                raise ValueError(
                    f"op_factory({dl}) returned shape {op.shape}, "
                    f"expected {(nl, nl)}")
            d = probe_diagonal(op, dims=dl, reach=reach, device=device)
            dinv = torch.where(d.abs() > 1e-30, 1.0 / d, torch.ones_like(d))
            sizes = [s[0] for s in (op.local_shapes_m or local_split(
                (nl,), P, Partition.SCATTER, 0))]
            a = shard_offsets(sizes)[me]
            self._ops.append(op)
            self._dinv.append(dinv[a:a + sizes[me]])
            self._sizes.append(sizes)
        self._local_transfer = [self._aligned(l)
                                for l in range(len(level_dims) - 1)]
        nc = int(np.prod(level_dims[-1]))
        if nc > coarsest_max:
            raise ValueError(
                f"coarsest grid {level_dims[-1]} has {nc} unknowns "
                f"(> coarsest_max={coarsest_max}); raise levels or "
                "coarsest_max")
        dev = self._dinv[0].device
        Ac = np.asarray(self._ops[-1].todense(device=dev))
        Ac = 0.5 * (Ac + Ac.conj().T)
        Ac += 1e-12 * np.trace(np.abs(Ac)) / nc * np.eye(nc)
        try:
            self._chol_c = torch.as_tensor(np.linalg.cholesky(Ac),
                                           device=dev)
            self._inv_c = None
        except np.linalg.LinAlgError:
            self._chol_c = None
            self._inv_c = torch.as_tensor(np.linalg.pinv(Ac), device=dev)
        n = int(np.prod(dims))
        dt = as_torch_dtype(dtype) or self._ops[0].dtype
        super().__init__(shape=(n, n), dtype=dt)
        self._sig = (f"mg[{'x'.join(map(str, dims))},"
                     f"L={len(level_dims)},nu={nu_pre}/{nu_post},"
                     f"w={self.omega:.3f},{_name(self.dtype)}]")

    @property
    def device(self) -> torch.device:
        return self._dinv[0].device

    def precond_signature(self) -> str:
        return self._sig

    def _aligned(self, l: int) -> bool:
        """Restriction from level ``l`` is local: every rank's rows are
        whole pairs of grid rows whose coarse rows are its coarse
        shard."""
        if not _group():
            return True
        inner = int(np.prod(self.level_dims[l][1:]))
        inner_c = int(np.prod(self.level_dims[l + 1][1:]))
        fine, coarse = self._sizes[l], self._sizes[l + 1]
        for a, s, ac, sc in zip(shard_offsets(fine), fine,
                                shard_offsets(coarse), coarse):
            if a % (2 * inner) or s % (2 * inner):
                return False
            if (a // (2 * inner) * inner_c, s // (2 * inner) * inner_c) \
                    != (ac, sc):
                return False
        return True

    def _gather(self, l: int, t: torch.Tensor) -> torch.Tensor:
        return collectives.all_gather(t.contiguous(), self._sizes[l]) \
            if _group() else t

    def _mine(self, l: int, g: torch.Tensor) -> torch.Tensor:
        if not _group():
            return g
        a = shard_offsets(self._sizes[l])[rank()]
        return g[a:a + self._sizes[l][rank()]].contiguous()

    def _grid(self, l: int, t: torch.Tensor) -> torch.Tensor:
        return t.reshape((-1,) + tuple(self.level_dims[l][1:])
                         + tuple(t.shape[1:]))

    def _restrict(self, l: int, t: torch.Tensor) -> torch.Tensor:
        nd = len(self.level_dims[l])
        tail = tuple(t.shape[1:])
        if not self._local_transfer[l]:
            t = self._gather(l, t)
        c = _restrict(self._grid(l, t), nd).reshape((-1,) + tail)
        return c if self._local_transfer[l] else self._mine(l + 1, c)

    def _prolong(self, l: int, t: torch.Tensor) -> torch.Tensor:
        nd = len(self.level_dims[l])
        tail = tuple(t.shape[1:])
        if not self._local_transfer[l]:
            t = self._gather(l + 1, t)
        f = _prolong(self._grid(l + 1, t), nd).reshape((-1,) + tail)
        return f if self._local_transfer[l] else self._mine(l, f)

    def _level_apply(self, l: int, t: torch.Tensor) -> torch.Tensor:
        tail = tuple(t.shape[1:])
        sizes = self._sizes[l]
        v = DistributedArray.__new__(DistributedArray)
        v._set_layout((sum(sizes),) + tail, Partition.SCATTER, 0,
                      tuple((s,) + tail for s in sizes))
        v._arr = t
        out = self._ops[l].matvec(v)
        if [s[0] for s in out.local_shapes] != sizes:
            out = out._relayout(tuple((s,) + tail for s in sizes))
        return out.array

    def _coarse(self, b: torch.Tensor) -> torch.Tensor:
        L = len(self.level_dims) - 1
        g = self._gather(L, b)
        rhs = g if g.ndim == 2 else g[:, None]
        if self._chol_c is not None:
            out = torch.cholesky_solve(rhs, self._chol_c.to(g.dtype))
        else:
            out = self._inv_c.to(g.dtype) @ rhs
        return self._mine(L, out.reshape(g.shape))

    def _cycle(self, l: int, b: torch.Tensor) -> torch.Tensor:
        if l == len(self.level_dims) - 1:
            return self._coarse(b)
        dinv = self._dinv[l].to(b.dtype)
        if b.ndim == 2:
            dinv = dinv[:, None]
        # a device fill, not a host copy: a captured segment may hold it
        om = torch.full((), self.omega, dtype=b.dtype, device=b.device)
        x = om * dinv * b  # the first sweep, from x = 0
        for _ in range(self.nu_pre - 1):
            x = x + om * dinv * (b - self._level_apply(l, x))
        r = b - self._level_apply(l, x)
        xc = self._cycle(l + 1, self._restrict(l, r))
        x = x + self._prolong(l, xc).to(b.dtype)
        for _ in range(self.nu_post):
            x = x + om * dinv * (b - self._level_apply(l, x))
        return x

    def _matvec(self, x: DistributedArray) -> DistributedArray:
        tail = tuple(x.global_shape[1:])
        want = tuple((s,) + tail for s in self._sizes[0])
        v = x._relayout(want) if x._scattered() else x
        wdt = torch.promote_types(v.dtype, self.dtype)
        out = self._cycle(0, v.array.to(wdt)).to(x.dtype)
        y = DistributedArray._wrap(out, v)
        return y._relayout(x.local_shapes) if x._scattered() else y

    _rmatvec = _matvec  # symmetric cycle


# ----------------------------------------------------------- dispatch
def make_precond(Op, kind: Optional[str] = None, **kw):
    """A preconditioner for ``Op`` by name (JAX
    ``ops/precond.py:463-497``), ``kind`` defaulting to
    ``PYLOPS_MPI_TPU_TORCH_PRECOND``: ``none`` gives ``None`` (the
    unpreconditioned loop), ``jacobi`` :meth:`JacobiPrecond.from_operator`,
    ``block_jacobi`` :meth:`BlockJacobiPrecond.from_operator`
    (``block_size`` needed unless ``Op`` is an ``MPIBlockDiag`` of a
    batched stack: then :meth:`~BlockJacobiPrecond.from_block_diag`),
    ``mg`` :class:`VCyclePrecond` (``op_factory`` and ``dims``
    needed)."""
    if kind is None:
        kind = precond_default()
    kind = str(kind).lower()
    if kind in ("none", "", "off", "0"):
        return None
    if kind == "jacobi":
        return JacobiPrecond.from_operator(Op, **kw)
    if kind == "block_jacobi":
        from .blockdiag import MPIBlockDiag
        if "block_size" not in kw and isinstance(Op, MPIBlockDiag) and (
                Op._batched is not None or not Op.ops):
            return BlockJacobiPrecond.from_block_diag(Op, **kw)
        if "block_size" not in kw:
            raise ValueError(
                "block_jacobi needs block_size= (or an MPIBlockDiag "
                "with a batched homogeneous stack)")
        return BlockJacobiPrecond.from_operator(Op, **kw)
    if kind == "mg":
        factory = kw.pop("op_factory", None)
        dims = kw.pop("dims", None)
        if factory is None or dims is None:
            raise ValueError("mg needs op_factory= and dims=")
        return VCyclePrecond(factory, dims, **kw)
    raise ValueError(
        f"unknown preconditioner kind {kind!r}; expected none, jacobi, "
        "block_jacobi or mg")


# the operator's parameters (JAX ``ops/precond.py`` registrations)
from ..linearoperator import register_operator_params  # noqa: E402

register_operator_params(JacobiPrecond, "_dinv")
register_operator_params(BlockJacobiPrecond, "_chol")
