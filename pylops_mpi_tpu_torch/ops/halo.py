"""N-D Cartesian halo operator.

PyTorch counterpart of ``pylops_mpi_tpu/ops/halo.py`` (the reference's
``pylops_mpi/basicoperators/Halo.py:12-423``). The ranks form a
Cartesian grid (row-major over ``proc_grid_shape``), each holding one
block of the field (the ceil split of :func:`halo_block_split`) as its
flat SCATTER shard. The forward extends the block with ghost zones from
its neighbours, one axis at a time
(:func:`~..parallel.collectives.cart_halo_extend`: boundary slabs only,
the corners relayed by the later axes, zeros at the domain's edges), and
cuts the rank's haloed window out of it; the adjoint crops the halo,
with no communication. It is built to sandwich local operators:
``HOp.H @ MPIBlockDiag(ops) @ HOp``.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

from ..distributedarray import DistributedArray
from ..linearoperator import MPILinearOperator
from ..parallel import collectives
from ..parallel.mesh import check_mesh, rank, world_size
from ..parallel.partition import Partition

__all__ = ["MPIHalo", "halo_block_split"]


def _cart_coords(rank: int, grid: Tuple[int, ...]) -> Tuple[int, ...]:
    return tuple(int(c) for c in np.unravel_index(rank, grid))


def halo_block_split(global_shape: Tuple[int, ...], rank: int,
                     grid_shape: Optional[Tuple[int, ...]] = None,
                     n_shards: Optional[int] = None) -> Tuple[slice, ...]:
    """Local slice owned by ``rank`` under the Cartesian ceil-block split
    (ref ``halo_block_split``, ``Halo.py:12-66``; JAX package
    ``ops/halo.py:50-70``)."""
    ndim = len(global_shape)
    if grid_shape is None:
        if n_shards is None:
            raise ValueError("grid_shape or n_shards required")
        grid_shape = (1,) * (ndim - 1) + (n_shards,)
    if int(np.prod(grid_shape)) <= rank or rank < 0:
        raise ValueError(f"rank {rank} outside grid {grid_shape}")
    coords = _cart_coords(rank, grid_shape)
    slices = []
    for gdim, procs, coord in zip(global_shape, grid_shape, coords):
        bs = math.ceil(gdim / procs)
        start = coord * bs
        end = min(start + bs, gdim)
        slices.append(slice(start, end))
    return tuple(slices)


class MPIHalo(MPILinearOperator):
    """Halo (ghost-zone) operator over a Cartesian block decomposition
    (ref ``Halo.py:69-423``; JAX package ``ops/halo.py:73-416``).

    ``halo`` is a scalar (symmetric everywhere, trimmed to zero at the
    grid's edges as the reference does for scalars, so with one rank
    the identity), a length-``ndim`` tuple (symmetric per axis, kept at
    the edges with zero fill), or a length-``2*ndim`` tuple of
    (minus, plus) pairs. The forward takes a SCATTER array whose shards
    are the ranks' blocks (``local_dim_sizes``) and returns the haloed
    blocks, SCATTER (``local_extent_sizes``); the adjoint crops each
    haloed block back to its block (the sandwich's left inverse, as in
    the reference, not the strict adjoint).

    ``proc_grid_shape`` must multiply to the number of ranks. ``mesh``
    keeps the JAX package's argument order and must describe the
    process group. ``overlap`` (``PYLOPS_MPI_TPU_TORCH_OVERLAP``) selects
    the JAX package's overlap select (``ops/halo.py:296-349``): the first
    exchanging axis's ghosts are posted, the rank's own block is copied
    into its place in the haloed window from the block before the
    exchange while they are in flight, and only the ghost shell is
    copied from the extended block after the wait; the numbers are the
    bulk path's, bit for bit (a copy either way). ``hierarchical`` is
    recorded (``.hierarchical``, and ``._hier`` what it resolves to on this
    world): the Cartesian exchange is the same on a world laid out hosts
    × ranks, as the JAX package's hybrid halo kernels are bit for bit its
    flat ones, and its bytes split by fabric pair by pair whatever the
    setting; ``off`` changes nothing.
    """

    def __init__(self, dims, halo, proc_grid_shape=None, mesh=None,
                 dtype=np.float64, overlap=None, hierarchical=None):
        check_mesh(mesh)
        self.global_dims = tuple(int(d) for d in np.atleast_1d(dims))
        self.ndim = len(self.global_dims)
        P_ = world_size()
        # the tuner's seam (JAX ``ops/halo.py:110-120``): an overlap left
        # at None, and not pinned by the environment, comes from the plan
        from ..utils.deps import overlap_enabled, overlap_env_pinned
        if overlap is None and not overlap_env_pinned():
            from ..tuning import plan as _tuneplan
            tplan = _tuneplan.get_plan("halo", shape=self.global_dims,
                                       dtype=dtype, n_dev=P_)
            if tplan is not None and tplan.get("overlap") in ("on", "off"):
                overlap = tplan.get("overlap")
        self.overlap = overlap
        self._overlap = overlap_enabled(overlap)
        from ..utils.deps import hierarchical_active
        self.hierarchical = hierarchical
        self._hier = hierarchical_active(hierarchical)
        if proc_grid_shape is None:
            proc_grid_shape = (1,) * (self.ndim - 1) + (P_,)
        self.proc_grid_shape = tuple(int(g) for g in proc_grid_shape)
        if int(np.prod(self.proc_grid_shape)) != P_:
            raise ValueError(
                f"grid_shape {self.proc_grid_shape} does not match mesh "
                f"size {P_}")
        scalar_halo = isinstance(halo, (int, np.integer))
        base = self._parse_halo(halo)
        # the exchange moves the untrimmed widths everywhere, so that the
        # slabs relayed along later axes agree between neighbours
        self._base_halo = base
        # per-rank geometry
        self.block_slices: List[Tuple[slice, ...]] = []
        self.halos: List[Tuple[int, ...]] = []
        self.local_dims_all: List[Tuple[int, ...]] = []
        self.extents: List[Tuple[int, ...]] = []
        for r in range(P_):
            coords = _cart_coords(r, self.proc_grid_shape)
            sl = halo_block_split(self.global_dims, r, self.proc_grid_shape)
            h = list(base)
            if scalar_halo:
                # ref trims scalar halos at grid boundaries (Halo.py:204-210)
                for ax in range(self.ndim):
                    if coords[ax] == 0:
                        h[2 * ax] = 0
                    if coords[ax] == self.proc_grid_shape[ax] - 1:
                        h[2 * ax + 1] = 0
            ld = tuple(s.stop - s.start for s in sl)
            ext = tuple(ld[ax] + h[2 * ax] + h[2 * ax + 1]
                        for ax in range(self.ndim))
            self.block_slices.append(sl)
            self.halos.append(tuple(h))
            self.local_dims_all.append(ld)
            self.extents.append(ext)
        self._validate_widths()
        self.local_dim_sizes = tuple((int(np.prod(ld)),)
                                     for ld in self.local_dims_all)
        self.local_extent_sizes = tuple((int(np.prod(e)),)
                                        for e in self.extents)
        n = int(np.prod(self.global_dims))
        m = int(sum(np.prod(e) for e in self.extents))
        self.dims = self.global_dims
        self.dimsd = (m,)
        super().__init__(shape=(m, n), dtype=dtype)

    def _parse_halo(self, h) -> Tuple[int, ...]:
        """ref ``Halo.py:197-227``"""
        if isinstance(h, (int, np.integer)):
            halo = (int(h),) * (2 * self.ndim)
        else:
            h = tuple(int(v) for v in h)
            if len(h) == 1:
                halo = h * (2 * self.ndim)
            elif len(h) == self.ndim:
                halo = sum(((d, d) for d in h), ())
            elif len(h) == 2 * self.ndim:
                halo = h
            else:
                raise ValueError(
                    f"Invalid halo length {len(h)} for ndim={self.ndim}")
        if any(v < 0 for v in halo):
            raise ValueError("Halo widths must be non-negative")
        return halo

    def _validate_widths(self) -> None:
        """One-hop exchange feasibility (ref ``Halo.py:280-318``): a halo
        may not be wider than the neighbouring block it is read from."""
        stride = [int(np.prod(self.proc_grid_shape[ax + 1:]))
                  for ax in range(self.ndim)]
        for r, h in enumerate(self.halos):
            coords = _cart_coords(r, self.proc_grid_shape)
            for ax in range(self.ndim):
                if coords[ax] > 0 and \
                        h[2 * ax] > self.local_dims_all[r - stride[ax]][ax]:
                    raise ValueError(
                        "MPIHalo halo widths are not supported by the "
                        "one-hop exchange: halo width exceeds the minus-"
                        "neighbour block size")
                if coords[ax] < self.proc_grid_shape[ax] - 1 and \
                        h[2 * ax + 1] > self.local_dims_all[r + stride[ax]][ax]:
                    raise ValueError(
                        "MPIHalo halo widths are not supported by the "
                        "one-hop exchange: halo width exceeds the plus-"
                        "neighbour block size")

    # ------------------------------------------------------------- apply
    @staticmethod
    def _check_layout(x: DistributedArray, sizes, what: str) -> None:
        """The JAX package's checks and errors (``ops/halo.py:366-373``,
        ``:392-399``)."""
        if x.partition != Partition.SCATTER:
            raise ValueError(
                f"x should have partition={Partition.SCATTER} "
                f"Got {x.partition} instead...")
        if tuple(s[0] for s in x.local_shapes) != tuple(s[0] for s in sizes):
            raise ValueError(f"MPIHalo {what}")

    def _matvec(self, x: DistributedArray) -> DistributedArray:
        self._check_layout(x, self.local_dim_sizes, "input local shapes do "
                           "not match the Cartesian block decomposition")
        r, base = rank(), self._base_halo
        blk = x.array.reshape(self.local_dims_all[r])
        # the rank's window in the block extended by the untrimmed widths
        win = tuple(slice(base[2 * ax] - h, base[2 * ax] - h + e)
                    for ax, (h, e) in enumerate(zip(self.halos[r][::2],
                                                    self.extents[r])))
        # overlap only where an exchange happens (JAX ``:296-303``: a
        # distributed axis with a nonzero halo)
        exchanging = [ax for ax in range(self.ndim)
                      if self.proc_grid_shape[ax] > 1
                      and (base[2 * ax] or base[2 * ax + 1])]
        if self._overlap and exchanging and world_size() > 1:
            out = self._overlap_window(blk, win, exchanging[0])
        else:
            for ax in range(self.ndim):
                blk = collectives.cart_halo_extend(
                    blk, self.proc_grid_shape, ax, base[2 * ax],
                    base[2 * ax + 1])
            out = blk[win]
        return DistributedArray._wrap(out.reshape(-1), x,
                                      global_shape=(self.shape[0],),
                                      local_shapes=self.local_extent_sizes)

    def _overlap_window(self, blk, win, first: int):
        """The haloed window of the overlap select (class docstring): axis
        ``first``'s exchange posted, the block copied into the window's
        interior meanwhile, the later axes' exchanges relaying the corners
        as in the bulk path, and the ghost shell copied last."""
        r, base = rank(), self._base_halo
        h = self.halos[r]
        ld = self.local_dims_all[r]
        ext = blk  # axes before ``first`` move nothing (zero ghosts)
        for ax in range(first):
            ext = collectives.cart_halo_extend(
                ext, self.proc_grid_shape, ax, base[2 * ax], base[2 * ax + 1])
        pending = collectives.post_cart_halo(
            ext, self.proc_grid_shape, first, base[2 * first],
            base[2 * first + 1])
        out = blk.new_empty(self.extents[r])
        out[tuple(slice(h[2 * ax], h[2 * ax] + ld[ax])
                  for ax in range(self.ndim))] = blk
        ext = pending.wait()
        for ax in range(first + 1, self.ndim):
            ext = collectives.cart_halo_extend(
                ext, self.proc_grid_shape, ax, base[2 * ax], base[2 * ax + 1])
        ext = ext[win]
        # the ghost shell: the slabs before and after the interior along
        # each axis, whole along the others (corners twice, harmless)
        for ax in range(self.ndim):
            for sl in (slice(0, h[2 * ax]),
                       slice(h[2 * ax] + ld[ax], self.extents[r][ax])):
                if sl.stop > sl.start:
                    idx = (slice(None),) * ax + (sl,)
                    out[idx] = ext[idx]
        return out

    def _rmatvec(self, x: DistributedArray) -> DistributedArray:
        """Crop the halo zones (ref ``Halo.py:400-423``): ghost
        contributions are discarded, not added back. Local to each
        rank."""
        self._check_layout(x, self.local_extent_sizes, "adjoint input "
                           "local shapes do not match the haloed "
                           "decomposition")
        r = rank()
        h, ld = self.halos[r], self.local_dims_all[r]
        sl = tuple(slice(h[2 * ax], h[2 * ax] + ld[ax])
                   for ax in range(self.ndim))
        return DistributedArray._wrap(
            x.array.reshape(self.extents[r])[sl].reshape(-1), x,
            global_shape=(self.shape[1],), local_shapes=self.local_dim_sizes)


# the operator's parameters (JAX ``ops/halo.py`` registrations)
from ..linearoperator import register_operator_params  # noqa: E402

register_operator_params(MPIHalo)
