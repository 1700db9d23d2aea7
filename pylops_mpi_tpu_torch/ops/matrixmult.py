"""Distributed dense matrix multiplication ``Y = A X``.

PyTorch counterpart of ``pylops_mpi_tpu/ops/matrixmult.py`` (the
reference's ``pylops_mpi/basicoperators/MatrixMult.py``). ``A`` is
``(N, K)`` and ``X`` is ``(K, M)``; the model and data are the flat
``(K·M,)`` and ``(N·M,)`` vectors, or ``(K·M, ncol)`` blocks whose
``ncol`` columns fold into the GEMM's columns (``M·ncol`` of them). The
output is a SCATTER vector with the default split and the input's mask,
as in the JAX package. Every rank passes the whole ``A`` and keeps only
its rows or its tile of it.

- ``kind="block"``: the rank keeps its balanced split of the rows of
  ``A``. The forward gathers ``X`` (one ``all_gather``) and computes its
  rows of ``Y``; the adjoint is the rank's partial ``Aᴴ·Y_rows``, summed
  over the world into the flat split (one ``reduce_scatter``).
- ``kind="summa"``: over a ``(pr, pc)`` grid of ranks
  (:func:`~..parallel.mesh.make_grid_2d`), rank ``(i, j)`` keeps tile
  ``(i, j)`` of ``A`` zero-padded to ``(Np, Kp_c)``. Schedules, on the
  grid's row (``c``) and column (``r``) sub-groups, as the JAX package's
  kernels: ``gather`` all-gathers the A row along ``c`` and the X column
  along ``r`` for one GEMM; ``stat_a`` gathers X fully, multiplies the
  owned tile by its k-block and reduce-scatters along ``c``; ``auto``
  picks the one whose volume model (:func:`summa_comm_volume`) receives
  fewer elements. The adjoint gathers Y along ``c``, multiplies by the
  tile's ``Aᴴ`` and sums over ``r`` as a ``reduce_scatter`` of the rows
  (the JAX package's ``psum``, of which each rank then keeps only the
  rows it passes on).
- ``kind="auto"``: the SUMMA ``gather`` schedule over the same tiling
  (the JAX package lays the tiling down as sharding constraints and lets
  XLA derive the schedule; the numbers are the same).

The flat vectors do not follow tile or row boundaries: a rank holds its
default-split range of ``K·M`` (or ``N·M``). So both ends of an apply
move data explicitly, each move one ``all_to_all`` of the overlaps
(:class:`_Move`): ``x`` to the GEMM layout (``flat→tile``,
``flat→rows``), and the product back to the flat split (``tile→flat``,
``rows→flat``). ``collectives.counts`` and ``received`` count them.

Each GEMM is one ``torch.matmul`` (cuBLAS on the card, TF32 off), as the
JAX package leaves it to XLA's ``matmul``; no hand kernel is on this
path. ``compute_dtype`` (real f32 operators only) stores the tiles
narrow and widens them for each product; the vector keeps its dtype.

With overlap on (``overlap=``, ``PYLOPS_MPI_TPU_TORCH_OVERLAP``) and more
than one rank along ``c``, the SUMMA kinds run the JAX package's ring
schedules (``ops/matrixmult.py:450-548``), each collective along ``c``
decomposed into ``pc - 1`` hops interleaved with ``pc`` GEMMs
(:func:`~..parallel.collectives.ring_pass`,
:func:`~..parallel.collectives.ring_reduce_scatter`): ``gather`` rotates
the A tiles, each step multiplying the resident tile by its k-slice of
the gathered X column; ``stat_a`` reduce-scatters as a ring whose chunk
GEMMs are computed just in time; the adjoint rotates the Y tiles, each
step filling its owner's columns, un-rotated with one roll, the ``r``
reduction unchanged. They reorder the sums.

``hierarchical`` (``PYLOPS_MPI_TPU_TORCH_HIERARCHICAL``; JAX
``ops/matrixmult.py:319-337``): on a world laid out hosts × ranks the
SUMMA kinds resolve ``_hier`` (the cost model then charges each grid
axis to the fabric it spans), and where the ring axis ``c`` spans hosts
in equal runs (``topology.slice_run``, e.g. a ``(1, 4)`` grid on two
hosts of two) the gather ring and the adjoint ring take the
host-blocked hop order (``ring_pass(slice_size=)``: one IB crossing a
lap of the run). That order visits the owners out of rotation order, so
the adjoint places each tile's product at its owner's columns directly
instead of rolling; the ``stat_a`` ring stays flat, as in the JAX
package (every hop is a neighbour shift). A flat world, a world of one
and ``off`` keep every schedule bit for bit. SUMMA consults
the tuner (:mod:`..tuning`) for the knobs left at their sentinels
(``schedule="auto"``, ``overlap``/``hierarchical=None``) under
``PYLOPS_MPI_TPU_TORCH_TUNE=on|auto``; the volume model lives in
:mod:`..diagnostics.costmodel`.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..diagnostics.costmodel import (summa_comm_volume,
                                     summa_comm_volume_split)
from ..distributedarray import DistributedArray
from ..linearoperator import MPILinearOperator
from ..parallel import collectives
from ..parallel.mesh import (DeviceLike, best_grid_2d, check_mesh,
                             make_grid_2d, rank, resolve_device, world_size)
from ..parallel.partition import Partition, local_split, shard_offsets
from ._precision import as_torch_dtype, default_compute_dtype, matmul_narrow

__all__ = ["MPIMatrixMult", "active_grid_comm", "local_block_split",
           "block_gather", "summa_comm_volume", "summa_comm_volume_split"]


def active_grid_comm(N: int, M: int, n_devices: Optional[int] = None):
    """Largest square grid of active ranks for a distributed matmul (JAX
    ``ops/matrixmult.py:58-90``, ref ``MatrixMult.py:24-79``): ``P' =
    isqrt(P)``, the active side capped at ``min(N, M)``.

    Returns ``(group, grid, active_ids, is_full)``: this rank's sub-group
    of its color (the active ranks for an active rank, the others for
    the rest, as the reference's ``Split``; ``None`` without a process
    group or when every rank is active) in the slot of the JAX package's
    mesh, the ``(d, d)`` grid, the active ranks in row-major grid order,
    and whether all ``n_devices`` ranks take part. Collective: every rank
    calls it."""
    world = world_size()
    n = world if n_devices is None else int(n_devices)
    if n > world:
        raise ValueError(f"requested {n} ranks but only {world} exist")
    p_prime = math.isqrt(n)
    d = max(1, min(int(N), int(M), p_prime))
    active = [r * p_prime + c for r in range(d) for c in range(d)]
    group = None
    if len(active) < world:
        group = collectives.mask_group(
            [0 if q in active else 1 for q in range(world)])
    return group, (d, d), active, len(active) == n


def local_block_split(global_shape: Tuple[int, int], rank: int,
                      grid: Tuple[int, int]) -> Tuple[slice, slice]:
    """The slices of tile ``(i, j) = divmod(rank, pc)`` of a 2-D array on
    ``grid``, tiles of ``ceil`` size (JAX ``:93-105``)."""
    pr, pc = grid
    i, j = divmod(rank, pc)
    if not (0 <= i < pr and 0 <= j < pc):
        raise ValueError(f"rank {rank} outside grid {grid}")
    br = -(-global_shape[0] // pr)
    bc = -(-global_shape[1] // pc)
    return (slice(i * br, min((i + 1) * br, global_shape[0])),
            slice(j * bc, min((j + 1) * bc, global_shape[1])))


def block_gather(blocks, global_shape: Tuple[int, int],
                 grid: Tuple[int, int]) -> np.ndarray:
    """The dense matrix from the tiles of every rank in row-major rank
    order (JAX ``:108-116``)."""
    out = np.zeros(global_shape, dtype=np.asarray(blocks[0]).dtype)
    for r, blk in enumerate(blocks):
        rs, cs = local_block_split(global_shape, r, grid)
        out[rs, cs] = np.asarray(blk)
    return out


def _tile_index(rows: Tuple[int, int], cols: Tuple[int, int],
                width: int) -> np.ndarray:
    """Flat row-major indices, in a matrix ``width`` wide, of the rows
    ``[rows)`` and columns ``[cols)`` (ascending)."""
    r = np.arange(rows[0], max(rows[0], rows[1]), dtype=np.int64)
    c = np.arange(cols[0], max(cols[0], cols[1]), dtype=np.int64)
    return (r[:, None] * width + c[None, :]).reshape(-1)


def _span(idx: np.ndarray):
    """``idx`` as a ``(start, length)`` run when it is one, else None."""
    start = int(idx[0]) if idx.size else 0
    if not np.array_equal(idx, np.arange(start, start + idx.size)):
        return None
    return start, int(idx.size)


class _Move:
    """One all-to-all that re-lays a flat vector: rank ``p`` holds the
    global indices ``have[p]`` (ascending, in its local order) and rank
    ``q`` wants ``want[q]`` (ascending); each rank sends every other the
    overlap of its indices with theirs. Runs of consecutive positions go
    as views and are placed by concatenation; the rest by index."""

    def __init__(self, have: Sequence[np.ndarray],
                 want: Sequence[np.ndarray], device: torch.device):
        me = rank()
        self.n_out = int(want[me].size)
        self.sends, self.recv, pos = [], [], []
        for q, w in enumerate(want):
            _, at, _ = np.intersect1d(have[me], w, assume_unique=True,
                                      return_indices=True)
            s = _span(at)
            self.sends.append(s if s is not None else
                              torch.as_tensor(at, device=device))
        for h in have:
            _, _, at = np.intersect1d(h, want[me], assume_unique=True,
                                      return_indices=True)
            self.recv.append((int(at.size),))
            pos.append(at)
        pos = np.concatenate(pos)
        self.place = None if _span(pos) == (0, self.n_out) else \
            torch.as_tensor(pos, device=device)

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        sends = [t.narrow(0, *s) if isinstance(s, tuple)
                 else t.index_select(0, s) for s in self.sends]
        parts = torch.cat(collectives.all_to_all(sends, self.recv))
        if self.place is None:
            return parts
        return parts.new_empty(self.n_out).index_copy_(0, self.place, parts)


class _MatMulBase(MPILinearOperator):
    """Shape bookkeeping, storage dtype, the GEMM, and the moves between
    the flat vectors and the GEMM layouts."""

    # the adjoint reads a stored Aᴴ under saveAt (the SUMMA kinds never do)
    _uses_At = True
    # K model columns fold into the GEMM's columns (M -> M·ncol)
    accepts_block = True

    def __init__(self, A, M: int, mesh=None, dtype=None,
                 saveAt: bool = False, compute_dtype=None,
                 device: DeviceLike = None):
        check_mesh(mesh)
        if not isinstance(A, torch.Tensor):
            A = np.asarray(A)
        if A.ndim != 2:
            raise ValueError(f"A must be 2-D, got shape {tuple(A.shape)}")
        self.N, self.K = (int(v) for v in A.shape)
        self.M = int(M)
        self.saveAt = saveAt
        self.dims = (self.K, self.M)
        self.dimsd = (self.N, self.M)
        dtype = as_torch_dtype(dtype) or as_torch_dtype(A.dtype)
        super().__init__(shape=(self.N * self.M, self.K * self.M),
                         dtype=dtype)
        compute_dtype = as_torch_dtype(compute_dtype)
        if compute_dtype is not None and self.dtype != torch.float32:
            raise ValueError(
                "compute_dtype is only supported for real float32 "
                f"operators, dtype is {self.dtype}")
        if compute_dtype is None:
            compute_dtype = default_compute_dtype(self.dtype)
        self.compute_dtype = compute_dtype
        self._P, self._rank = world_size(), rank()
        self._moves: Dict[tuple, _Move] = {}
        rows, cols, shape = self._owned()
        part = A[rows[0]:rows[1], cols[0]:cols[1]]
        storage = compute_dtype or self.dtype
        if isinstance(A, torch.Tensor):
            dev = A.device if device is None else resolve_device(device)
            piece = part.to(dtype=self.dtype)
        else:
            dev = resolve_device(device)
            piece = torch.tensor(part).to(self.dtype)
        if tuple(piece.shape) != shape:  # a tile padded with zeros
            full = piece.new_zeros(shape)
            full[:piece.shape[0], :piece.shape[1]] = piece
            piece = full
        piece = piece.to(device=dev, dtype=storage)
        if self._P > 1 and isinstance(A, torch.Tensor) \
                and piece.data_ptr() == A.data_ptr():
            piece = piece.clone()  # not a view that keeps the whole A
        self.A = piece
        self.At = (piece.mH.contiguous()
                   if saveAt and self._uses_At else None)

    @property
    def device(self) -> torch.device:
        return self.A.device

    def _owned(self):
        """This rank's rows and columns of ``A`` and its stored shape."""
        raise NotImplementedError

    def _gemm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``a @ b`` with the matrix operand ``a`` at its storage dtype
        widened for the product and ``b`` at its own dtype (never
        narrowed); under ``compute_dtype`` the product is at the operator
        dtype (JAX ``_gemm``, ``:166-176``)."""
        out = matmul_narrow(a, b, self.compute_dtype, self.dtype)
        return out if self.compute_dtype is None else out.to(self.dtype)

    # --------------------------------------------------------- flat side
    @staticmethod
    def _inner(x: DistributedArray) -> Tuple[int, Optional[int]]:
        """Entries per flat row (``ncol`` of a block, else 1) and ncol."""
        ncol = int(x.global_shape[1]) if x.ndim == 2 else None
        return ncol or 1, ncol

    def _flat_in(self, x: DistributedArray):
        """This rank's entries of ``x`` as one flat tensor, and the flat
        sizes of every rank's range (``None`` when every rank holds all of
        it: a BROADCAST vector, or one split along another axis,
        gathered)."""
        if x.partition == Partition.SCATTER and x.axis == 0:
            inner, _ = self._inner(x)
            sizes = tuple(s[0] * inner for s in x.local_shapes)
            return x.array.reshape(-1), sizes
        return x._global().reshape(-1), None

    def _move(self, name: str, t: torch.Tensor, have, want,
              key: tuple) -> torch.Tensor:
        """``t`` (laid as ``have``) re-laid as ``want`` by the
        :class:`_Move` ``name``, cached under ``key`` (what the layouts
        depend on); ``have`` and ``want`` are functions of a rank giving
        its ascending global indices."""
        if self._P == 1:
            return t
        k = (name,) + key
        if k not in self._moves:
            self._moves[k] = _Move([have(p) for p in range(self._P)],
                                   [want(q) for q in range(self._P)],
                                   t.device)
        return self._moves[k](t)

    def _from_flat(self, name: str, x: DistributedArray, want, inner: int):
        """This rank's ``want`` entries of ``x``: a move from its split,
        or a local cut of a vector every rank holds whole."""
        flat, sizes = self._flat_in(x)
        if sizes is None:
            return flat[torch.as_tensor(want(self._rank), device=flat.device)]
        return self._move(name, flat, self._ranges(sizes), want,
                          (sizes, inner))

    @staticmethod
    def _ranges(sizes: Sequence[int]):
        """Rank ``p``'s contiguous global indices under ``sizes``."""
        offs = shard_offsets(sizes)
        return lambda p: np.arange(offs[p], offs[p] + sizes[p],
                                   dtype=np.int64)

    def _out_sizes(self, nrows: int, inner: int) -> List[int]:
        """Flat sizes of the output's default split (rows of ``inner``)."""
        return [s[0] * inner for s in local_split(
            (nrows * self.M,), self._P, Partition.SCATTER, 0)]

    def _wrap_out(self, flat: torch.Tensor, x: DistributedArray,
                  nrows: int, ncol: Optional[int]) -> DistributedArray:
        """This rank's piece of the default split as a SCATTER vector with
        ``x``'s mask (JAX ``_wrap_out``, ``:196-206``)."""
        tail = () if ncol is None else (ncol,)
        locs = tuple(s + tail for s in local_split(
            (nrows * self.M,), self._P, Partition.SCATTER, 0))
        return DistributedArray._wrap(
            flat.reshape(locs[self._rank]), x,
            global_shape=(nrows * self.M,) + tail, local_shapes=locs,
            partition=Partition.SCATTER, axis=0)


class _MPIBlockMatrixMult(_MatMulBase):
    """Rows of ``A`` split over the ranks (JAX ``:209-232``, ref
    ``MatrixMult.py:178-427``): forward ``all_gather`` of X and a
    ``rows→flat`` move; adjoint a ``flat→rows`` move and one
    ``reduce_scatter`` over the world."""

    def _owned(self):
        sizes = [s[0] for s in local_split((self.N,), self._P,
                                           Partition.SCATTER, 0)]
        self._row_sizes = sizes
        lo = shard_offsets(sizes)[self._rank]
        hi = lo + sizes[self._rank]
        return (lo, hi), (0, self.K), (hi - lo, self.K)

    def _row_ranges(self, width: int):
        sizes = [n * width for n in self._row_sizes]
        return self._ranges(sizes)

    def _matvec(self, x: DistributedArray) -> DistributedArray:
        inner, ncol = self._inner(x)
        Me = self.M * inner
        flat, sizes = self._flat_in(x)
        if sizes is not None and self._P > 1:
            flat = collectives.all_gather(flat, sizes)
        Y = self._gemm(self.A, flat.reshape(self.K, Me))   # this rank's rows
        out = self._ranges(self._out_sizes(self.N, inner))
        y = self._move("rows→flat", Y.reshape(-1), self._row_ranges(Me),
                       out, (inner,))
        return self._wrap_out(y, x, self.N, ncol)

    def _rmatvec(self, x: DistributedArray) -> DistributedArray:
        inner, ncol = self._inner(x)
        Me = self.M * inner
        Yr = self._from_flat("flat→rows", x, self._row_ranges(Me), inner)
        At = self.At if self.At is not None else self.A.mH
        X = self._gemm(At, Yr.reshape(-1, Me)).reshape(-1)  # (K, Me) partial
        if self._P > 1:
            X = collectives.reduce_scatter(X, self._out_sizes(self.K, inner))
        return self._wrap_out(X, x, self.K, ncol)


class _MPISummaMatrixMult(_MatMulBase):
    """SUMMA over a ``(pr, pc)`` grid of ranks (JAX ``:235-589``, ref
    ``MatrixMult.py:430-765``): rank ``(i, j)`` keeps tile ``(i, j)`` of
    ``A`` padded to ``(Np, Kp_c)``; X and Y travel as tiles of the padded
    ``(Kp_r, Mp)`` and ``(Np, Mp)`` matrices. See the module docstring
    for the schedules. No ``At`` is stored, ``saveAt`` or not."""

    _uses_At = False
    # the tuner's seam (the auto kind runs the gather schedule and never
    # consults it)
    _consults = True

    def __init__(self, A, M: int, mesh=None, dtype=None,
                 saveAt: bool = False,
                 grid: Optional[Tuple[int, int]] = None, compute_dtype=None,
                 schedule: str = "auto", overlap=None, hierarchical=None, *,
                 device: DeviceLike = None):
        if schedule not in ("auto", "gather", "stat_a"):
            raise ValueError(f"schedule={schedule!r}: expected "
                             "'auto', 'gather' or 'stat_a'")
        check_mesh(mesh)
        self.grid = (tuple(int(g) for g in grid) if grid is not None
                     else best_grid_2d(world_size()))
        self._g2 = make_grid_2d(self.grid)
        # the tuner's seam (JAX ``ops/matrixmult.py:306-318``): only the
        # knobs left at their sentinels, and not pinned by the
        # environment, come from the plan
        from ..utils.deps import (hierarchical_active,
                                  hierarchical_env_pinned, overlap_enabled,
                                  overlap_env_pinned)
        want_overlap = overlap is None and not overlap_env_pinned()
        want_hier = hierarchical is None and not hierarchical_env_pinned()
        tplan = None
        if self._consults and (schedule == "auto" or want_overlap
                               or want_hier):
            tplan = self._consult_plan(A, M, dtype, compute_dtype, device)
        if tplan is not None:
            if want_overlap and tplan.get("overlap") in ("on", "off"):
                overlap = tplan.get("overlap")
            if want_hier and tplan.get("hierarchical") in (
                    "auto", "on", "off"):
                hierarchical = tplan.get("hierarchical")
            if schedule == "auto" and tplan.get("schedule") in (
                    "gather", "stat_a"):
                schedule = tplan.get("schedule")
        self.overlap = overlap
        self.hierarchical = hierarchical
        # on a world laid out hosts × ranks: ``_hier`` the fabric-aligned
        # attribution, ``_ring_slice`` the host run of a ring axis ``c``
        # that spans hosts (the host-blocked hop order), else None
        from ..parallel import topology as _topo
        self._hier = hierarchical_active(hierarchical)
        self._ring_slice = (_topo.slice_run(self._g2, "c")
                            if self._hier and _topo.axis_fabric(
                                self._g2, "c") == "ib" else None)
        N, K = (int(v) for v in np.shape(A))
        pr, pc = self.grid
        self.Np = pr * -(-N // pr)
        self.Kp_r = pr * -(-K // pr)
        self.Kp_c = pc * -(-K // pc)
        if schedule == "auto":
            vols = summa_comm_volume(N, K, int(M), self.grid)
            schedule = "stat_a" if vols["stat_a"] < vols["gather"] \
                else "gather"
        self.schedule = schedule
        super().__init__(A, M, mesh, dtype, saveAt, compute_dtype, device)
        self._overlap = overlap_enabled(overlap, self.device)

    def _consult_plan(self, A, M, dtype, compute_dtype, device):
        """``tuning.get_plan`` for this construction (``None`` with
        ``PYLOPS_MPI_TPU_TORCH_TUNE=off``; JAX ``:386-416``). Under
        ``auto`` a miss is measured in place: each candidate is built
        with explicit schedule, overlap and staging (which never consult
        the tuner) over the same ``A`` and times one forward apply."""
        from ..tuning import plan as _tuneplan
        from ..utils.deps import batch_default
        N_, K_ = (int(v) for v in np.shape(A))
        dev = A.device if isinstance(A, torch.Tensor) and device is None \
            else resolve_device(device)
        op_dtype = as_torch_dtype(dtype) or as_torch_dtype(A.dtype)

        def factory(params):
            op = _MPISummaMatrixMult(
                A, M, dtype=dtype, grid=self.grid,
                compute_dtype=compute_dtype, schedule=params["schedule"],
                overlap=params["overlap"],
                hierarchical=params.get("hierarchical"), device=dev)
            dx = DistributedArray.to_dist(
                torch.zeros(K_ * int(M), dtype=op.dtype), device=dev)
            return lambda: op.matvec(dx).array

        return _tuneplan.get_plan(
            "matrixmult", shape=(N_, K_, int(M)), dtype=op_dtype,
            n_dev=world_size(), device=dev,
            extra={"grid": tuple(int(g) for g in self.grid),
                   "batch": batch_default()},
            factory=factory)

    def _owned(self):
        pr, pc = self.grid
        i, j = self._g2.coords
        bn, bk = self.Np // pr, self.Kp_c // pc
        return ((i * bn, min((i + 1) * bn, self.N)),
                (j * bk, min((j + 1) * bk, self.K)), (bn, bk))

    def _tiles(self, nrows: int, rows_p: int, Me: int):
        """Rank ``q``'s valid entries of tile ``(i, j)`` of a ``(nrows,
        Me)`` matrix in tiles of ``rows_p`` rows and ``ceil(Me/pc)``
        columns, as global flat indices."""
        pc = self.grid[1]
        bm = -(-Me // pc)

        def tile(q):
            i, j = divmod(q, pc)
            return _tile_index((i * rows_p, min((i + 1) * rows_p, nrows)),
                               (j * bm, min((j + 1) * bm, Me)), Me)
        return tile

    def _to_tile(self, x: DistributedArray, nrows: int, rows_p: int,
                 name: str):
        """``flat→tile``: this rank's tile of the folded ``(nrows, Me)``
        matrix, zero-padded to ``(rows_p, ceil(Me/pc))``."""
        inner, ncol = self._inner(x)
        Me = self.M * inner
        v = self._from_flat(name, x, self._tiles(nrows, rows_p, Me), inner)
        pc = self.grid[1]
        i, j = self._g2.coords
        bm = -(-Me // pc)
        h = max(0, min(rows_p, nrows - i * rows_p))
        w = max(0, min(bm, Me - j * bm))
        T = v.reshape(h, w)
        if (h, w) != (rows_p, bm):
            T = torch.nn.functional.pad(T, (0, bm - w, 0, rows_p - h))
        return T, inner, ncol, Me

    def _gather(self, t: torch.Tensor, axis: int, group, n: int):
        """``t`` joined along ``axis`` over ``group`` of ``n`` ranks (equal
        padded tiles; a group of one rank moves nothing)."""
        if n == 1:
            return t
        return collectives.all_gather(t.contiguous(), [t.shape[axis]] * n,
                                      axis, group)

    @property
    def _two_level(self) -> bool:
        """Whether a two-level schedule runs (the graph bank's key,
        :func:`~..aot.signature.schedule_signature`): the rings in the
        host-blocked order."""
        return bool(self._overlap and self._ring_slice)

    def _matvec(self, x: DistributedArray) -> DistributedArray:
        pr, pc = self.grid
        j = self._g2.coords[1]
        bkr, bk = self.Kp_r // pr, self.Kp_c // pc
        Xt, inner, ncol, Me = self._to_tile(x, self.K, bkr, "flat→tile X")
        if self._overlap and pc > 1:
            Yt = (self._fwd_ring(Xt) if self.schedule == "gather"
                  else self._fwd_stat_a_ring(Xt))
        elif self.schedule == "gather":
            Arow = self._gather(self.A, 1, self._g2.c, pc)  # (bn, Kp_c)
            Xcol = self._gather(Xt, 0, self._g2.r, pr)      # (Kp_r, bm)
            Yt = self._gemm(Arow[:, :self.K], Xcol[:self.K])
        else:  # stat_a: A never moves
            Xf = self._gather(self._gather(Xt, 0, self._g2.r, pr), 1,
                              self._g2.c, pc)               # (Kp_r, Mp)
            if self.Kp_c > self.Kp_r:
                Xf = torch.nn.functional.pad(
                    Xf, (0, 0, 0, self.Kp_c - self.Kp_r))
            part = self._gemm(self.A, Xf[j * bk:(j + 1) * bk])  # (bn, Mp)
            Yt = part if pc == 1 else collectives.reduce_scatter(
                part, [Xt.shape[1]] * pc, 1, self._g2.c)
        return self._from_tile(Yt, x, inner, ncol, Me)

    def _padded_x(self, X: torch.Tensor) -> torch.Tensor:
        """X's ``Kp_r`` rows padded with zeros to ``Kp_c`` (the A tiles'
        contraction), where that is longer."""
        if self.Kp_c > self.Kp_r:
            X = torch.nn.functional.pad(X, (0, 0, 0, self.Kp_c - self.Kp_r))
        return X

    def _fwd_ring(self, Xt: torch.Tensor) -> torch.Tensor:
        """``gather`` as a ring (JAX ``_kernel_fwd_ring``, ``:450-473``): X
        gathers along ``r`` as in the bulk schedule, the A row's gather
        along ``c`` becomes ``pc - 1`` hops, each step multiplying the
        resident tile by its owner's k-slice of X (padding meets zeros)."""
        pr, pc = self.grid
        Xcol = self._padded_x(self._gather(Xt, 0, self._g2.r, pr))
        kb = self.Kp_c // pc

        def body(acc, Ares, owner, _s):
            part = self._gemm(Ares, Xcol[owner * kb:(owner + 1) * kb])
            return part if acc is None else acc + part

        return collectives.ring_pass(self.A, body, group=self._g2.c,
                                     slice_size=self._ring_slice)

    def _fwd_stat_a_ring(self, Xt: torch.Tensor) -> torch.Tensor:
        """``stat_a`` as a ring (JAX ``_kernel_fwd_stat_a_ring``,
        ``:475-508``): A never moves, the reduce-scatter along ``c`` is
        a ring whose partial for each output chunk of columns is
        computed just in time."""
        pr, pc = self.grid
        j = self._g2.coords[1]
        Xf = self._padded_x(self._gather(self._gather(Xt, 0, self._g2.r, pr),
                                         1, self._g2.c, pc))
        kb, mb = self.Kp_c // pc, Xt.shape[1]
        Xk = Xf[j * kb:(j + 1) * kb]
        return collectives.ring_reduce_scatter(
            lambda q: self._gemm(self.A, Xk[:, q * mb:(q + 1) * mb]),
            self._g2.c)

    def _adj_ring(self, Yt: torch.Tensor) -> torch.Tensor:
        """The adjoint's gather along ``c`` as a ring (JAX
        ``_kernel_adj_ring``, ``:510-548``): the Y tiles rotate, each
        step multiplying ``Aᴴ`` by the resident tile into its owner's
        columns, collected in rotation order and un-rotated with one
        roll; in the host-blocked order each product is written at its
        owner's columns (JAX ``:520-538``)."""
        pc = self.grid[1]
        j = self._g2.coords[1]
        At = self.A.mH
        if self._ring_slice:
            mb = Yt.shape[1]

            def place(acc, Yres, owner, _s):
                part = self._gemm(At, Yres)
                if acc is None:
                    acc = part.new_zeros((part.shape[0], mb * pc))
                acc[:, owner * mb:(owner + 1) * mb] = part
                return acc

            return collectives.ring_pass(Yt, place, group=self._g2.c,
                                         slice_size=self._ring_slice)
        parts = []

        def body(acc, Yres, _owner, _s):
            parts.append(self._gemm(At, Yres))
            return acc

        collectives.ring_pass(Yt, body, group=self._g2.c)
        return torch.roll(torch.cat(parts, dim=1), j * Yt.shape[1], dims=1)

    def _from_tile(self, Yt: torch.Tensor, x: DistributedArray, inner: int,
                   ncol: Optional[int], Me: int) -> DistributedArray:
        """``tile→flat``: the valid part of this rank's tile of Y to the
        default split."""
        i, j = self._g2.coords
        bn, bm = Yt.shape
        h = max(0, min(bn, self.N - i * bn))
        w = max(0, min(bm, Me - j * bm))
        out = self._ranges(self._out_sizes(self.N, inner))
        y = self._move("tile→flat", Yt[:h, :w].reshape(-1),
                       self._tiles(self.N, bn, Me), out, (inner,))
        return self._wrap_out(y, x, self.N, ncol)

    def _rmatvec(self, x: DistributedArray) -> DistributedArray:
        pr, pc = self.grid
        i, j = self._g2.coords
        bn, bk = self.Np // pr, self.Kp_c // pc
        Yt, inner, ncol, Me = self._to_tile(x, self.N, bn, "flat→tile Y")
        if self._overlap and pc > 1:
            part = self._adj_ring(Yt)                         # (bk, Mp)
        else:
            Yrow = self._gather(Yt, 1, self._g2.c, pc)        # (bn, Mp)
            part = self._gemm(self.A.mH, Yrow)                # (bk, Mp)
        sizes = [s[0] for s in local_split((bk,), pr, Partition.SCATTER, 0)]
        Xp = part if pr == 1 else collectives.reduce_scatter(
            part, sizes, 0, self._g2.r)
        # this rank's rows of X, whole width: one contiguous flat range

        def band(q):
            qi, qj = divmod(q, pc)
            lo = qj * bk + shard_offsets(sizes)[qi]
            return _tile_index((lo, min(lo + sizes[qi], self.K)), (0, Me), Me)

        rows = max(0, min(sizes[i], self.K - (j * bk
                                              + shard_offsets(sizes)[i])))
        out = self._ranges(self._out_sizes(self.K, inner))
        X = self._move("rows→flat", Xp[:rows, :Me].reshape(-1), band, out,
                       (inner,))
        return self._wrap_out(X, x, self.K, ncol)


class _MPIAutoMatrixMult(_MPISummaMatrixMult):
    """``kind="auto"`` (JAX ``:592-622``): the JAX package expresses the
    2-D tiling as sharding constraints on one einsum and lets XLA's
    partitioner derive the schedule. The port runs the SUMMA ``gather``
    schedule over the same tiling, which gives the same numbers; like
    the SUMMA kind it stores no ``At``."""

    _consults = False

    def __init__(self, A, M: int, mesh=None, dtype=None,
                 saveAt: bool = False,
                 grid: Optional[Tuple[int, int]] = None, compute_dtype=None,
                 *, device: DeviceLike = None):
        # the partitioner's schedule has no ring form: overlap stays off
        super().__init__(A, M, mesh, dtype, saveAt, grid, compute_dtype,
                         "gather", "off", device=device)


def MPIMatrixMult(A, M: int, saveAt: bool = False, mesh=None,
                  kind: str = "summa", dtype=None,
                  grid: Optional[Tuple[int, int]] = None,
                  compute_dtype=None, schedule: str = "auto",
                  overlap=None, hierarchical=None, *,
                  device: DeviceLike = None) -> MPILinearOperator:
    """Distributed ``Y = A X`` (JAX ``:625-665``, ref
    ``MatrixMult.py:768-872``), ``kind`` one of ``"block"``, ``"summa"``
    or ``"auto"``.

    ``A`` is the whole ``(N, K)`` matrix on every rank (a tensor stays on
    its device unless ``device`` is given, a numpy array goes to
    ``device``, default ``"cuda"``); each rank keeps its rows (block) or
    its tile (summa, auto). ``M`` is the number of columns of X.
    ``saveAt`` stores the rows' ``Aᴴ`` (block only). ``mesh`` must
    describe the process group. ``grid`` is the ``(pr, pc)`` grid of the
    SUMMA kinds (default :func:`~..parallel.mesh.best_grid_2d`).
    ``compute_dtype`` (real f32 operators only; ``None`` takes the
    precision policy) stores A narrow. ``schedule`` (summa):
    ``"gather"``, ``"stat_a"`` or ``"auto"``. ``overlap`` (summa) selects
    the ring schedules and ``hierarchical`` (summa) their host-blocked
    hop order on a world laid out hosts × ranks (module docstring)."""
    if kind == "block":
        return _MPIBlockMatrixMult(A, M, mesh, dtype, saveAt, compute_dtype,
                                   device)
    if kind == "summa":
        return _MPISummaMatrixMult(A, M, mesh, dtype, saveAt, grid,
                                   compute_dtype, schedule, overlap,
                                   hierarchical, device=device)
    if kind == "auto":
        return _MPIAutoMatrixMult(A, M, mesh, dtype, saveAt, grid,
                                  compute_dtype, device=device)
    raise NotImplementedError("kind must be 'block', 'summa' or 'auto'")


# the operator's parameters (JAX ``ops/matrixmult.py`` registrations)
from ..linearoperator import register_operator_params  # noqa: E402

for _c in (_MPIBlockMatrixMult, _MPISummaMatrixMult, _MPIAutoMatrixMult):
    register_operator_params(_c, "A", "At")
