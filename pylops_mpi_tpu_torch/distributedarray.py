"""DistributedArray: a tensor sharded over the ranks of the process group.

PyTorch counterpart of ``pylops_mpi_tpu/distributedarray.py`` (the
reference's ``pylops_mpi/DistributedArray.py``). The port runs SPMD, as
the reference does: every rank holds its own shard, the
``local_shapes[rank]`` piece of the balanced split
(:func:`~.parallel.partition.local_split`) for ``SCATTER`` or the whole
array for ``BROADCAST``, and ``.array`` is that local tensor. The layout
metadata (``global_shape``, ``partition``, ``axis``, ``local_shapes``,
``mask``) is the same on every rank.

Elementwise arithmetic is local. ``dot`` and ``norm`` reduce a local
partial, accumulated at ``ops/_precision.accum_dtype`` (f32 for bf16/f16
vectors), with one :func:`~.parallel.collectives.all_reduce` over the
group, or over the mask's sub-group; ``BROADCAST`` arrays skip the
reduction. ``asarray`` gathers the shards; it is collective, as is every
method that communicates, so every rank calls it.

Without a process group the world is one rank whose shard is the whole
array, and nothing communicates. Reductions return 0-d tensors on the
array's device, so a solver loop never waits for the host.

With a ``mask``, ``dot`` and ``norm`` reduce within the rank's color
group, and each rank gets its own group's scalar, as in the reference;
the JAX package returns the vector of every group's scalars instead.

An array may live on a :class:`~.parallel.mesh.Mesh` over a sub-group
of the world (``mesh=``, from :func:`~.parallel.mesh.sub_mesh`): shard
``i`` sits on the mesh's ``i``-th rank, reductions and gathers run over
the sub-group, and a rank outside it holds an empty tensor (zero rows)
with the same metadata. :meth:`reshard` moves an array between layouts
and worlds, :meth:`to_host` parks it in host RAM
(``parallel/reshard.py``, ``parallel/spill.py``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .ops._precision import accum_dtype, as_torch_dtype
from .parallel import collectives
from .parallel.mesh import DeviceLike, rank, resolve_device, world_size
from .parallel.partition import Partition, local_split, shard_offsets
from .parallel.reshard import _UNSET

__all__ = ["DistributedArray", "Partition", "local_split"]


class DistributedArray:
    """Sharded array (ref ``pylops_mpi/DistributedArray.py:74-960``).

    Parameters
    ----------
    global_shape : tuple or int
        Logical global shape.
    partition : Partition
        Placement policy (SCATTER / BROADCAST / UNSAFE_BROADCAST).
    axis : int
        Split dimension for SCATTER.
    local_shapes : list of tuples, optional
        Per-rank shapes (defaults to the balanced split); one per rank
        of :func:`~.parallel.mesh.world_size`.
    mask : list, optional
        Group color per rank; ``dot``/``norm`` reduce within the rank's
        group (ref ``DistributedArray.py:74-100``).
    dtype : torch or numpy dtype, optional
        Defaults to ``torch.get_default_dtype()``.
    device : str or torch.device, optional
        Defaults to :func:`~.parallel.mesh.default_device` (``"cuda"``).
    mesh : Mesh, optional
        A sub-group's mesh (:func:`~.parallel.mesh.sub_mesh`); default
        the whole world.
    """

    # a sub-group's Mesh, or None for the whole world
    _mesh = None

    def __init__(self, global_shape, partition: Partition = Partition.SCATTER,
                 axis: int = 0,
                 local_shapes: Optional[Sequence[Tuple[int, ...]]] = None,
                 mask: Optional[Sequence] = None,
                 dtype=None, device: DeviceLike = None, *, mesh=None):
        if isinstance(global_shape, (int, np.integer)):
            global_shape = (int(global_shape),)
        self._set_layout(tuple(int(s) for s in global_shape), partition,
                         axis, local_shapes, mask, mesh)
        dtype = as_torch_dtype(dtype) or torch.get_default_dtype()
        self._arr = torch.zeros(self.local_shape, dtype=dtype,
                                device=resolve_device(device))

    def _set_layout(self, global_shape, partition, axis, local_shapes,
                    mask=None, mesh=None):
        """Validate and store the layout metadata."""
        if partition not in Partition:
            raise ValueError(f"Should be one of {[p for p in Partition]}")
        if axis < 0:
            axis += len(global_shape)
        if partition == Partition.SCATTER and not (0 <= axis < len(global_shape)):
            raise IndexError(f"axis {axis} out of range for shape {global_shape}")
        self._mesh = mesh if mesh is not None and mesh.ranks is not None \
            else None
        n_shards = mesh.size if mesh is not None else world_size()
        if local_shapes is None:
            local_shapes = local_split(global_shape, n_shards, partition, axis)
        else:
            local_shapes = tuple(tuple(int(v) for v in np.atleast_1d(s))
                                 for s in local_shapes)
            if len(local_shapes) != n_shards:
                raise ValueError(f"need {n_shards} local shapes, got {len(local_shapes)}")
            if partition == Partition.SCATTER:
                tot = sum(s[axis] for s in local_shapes)
                if tot != global_shape[axis]:
                    raise ValueError(
                        f"local shapes sum to {tot} != global dim {global_shape[axis]}")
        if mask is not None:
            mask = tuple(mask)
            if len(mask) != n_shards:
                raise ValueError(f"mask must have {n_shards} entries")
        self._partition = partition
        self._axis = int(axis)
        self._global_shape = global_shape
        self._local_shapes = local_shapes
        self._mask = mask

    _KEEP = object()

    @classmethod
    def _wrap(cls, arr: torch.Tensor, like: "DistributedArray", *,
              global_shape=None, local_shapes=None, axis=None,
              partition=None, mask=_KEEP) -> "DistributedArray":
        """Internal constructor from this rank's local tensor, copying the
        layout metadata of ``like`` except where given."""
        out = cls.__new__(cls)
        out._partition = like._partition if partition is None else partition
        out._axis = like._axis if axis is None else int(axis)
        out._global_shape = (tuple(global_shape) if global_shape is not None
                             else like._global_shape)
        out._local_shapes = (tuple(tuple(s) for s in local_shapes)
                             if local_shapes is not None else like._local_shapes)
        out._mask = like._mask if mask is cls._KEEP else (
            None if mask is None else tuple(mask))
        out._mesh = like._mesh
        out._arr = arr
        return out

    # ---------------------------------------------------------- properties
    @property
    def global_shape(self) -> Tuple[int, ...]:
        return self._global_shape

    @property
    def local_shapes(self) -> Tuple[Tuple[int, ...], ...]:
        return self._local_shapes

    @property
    def local_shape(self) -> Tuple[int, ...]:
        """This rank's shard shape (zero rows off the array's mesh)."""
        me = self._me()
        if me < 0:
            shp = list(self._global_shape)
            shp[self._axis if self._partition == Partition.SCATTER else 0] = 0
            return tuple(shp)
        return self._local_shapes[me]

    def _me(self) -> int:
        """This rank's shard index: its rank in the array's mesh, -1 off
        it."""
        return self._mesh.rank if self._mesh is not None else rank()

    @property
    def mesh(self):
        """The :class:`~.parallel.mesh.Mesh` the array lives on."""
        if self._mesh is not None:
            return self._mesh
        from .parallel.mesh import default_mesh
        return default_mesh()

    @property
    def partition(self) -> Partition:
        return self._partition

    @property
    def axis(self) -> int:
        return self._axis

    @property
    def mask(self):
        return self._mask

    @property
    def rank(self) -> int:
        return rank()

    @property
    def n_shards(self) -> int:
        return len(self._local_shapes)

    @property
    def dtype(self) -> torch.dtype:
        return self._arr.dtype

    @property
    def device(self) -> torch.device:
        return self._arr.device

    @property
    def ndim(self) -> int:
        return len(self._global_shape)

    @property
    def size(self) -> int:
        return int(np.prod(self._global_shape))

    @property
    def array(self) -> torch.Tensor:
        """This rank's shard (the whole array without a group)."""
        return self._arr

    local_array = array

    @property
    def engine(self) -> str:
        return "torch"

    # ------------------------------------------------------------ sharding
    def _axis_sizes(self) -> List[int]:
        return [int(s[self._axis]) for s in self._local_shapes]

    def _scattered(self) -> bool:
        return self._partition == Partition.SCATTER and self.n_shards > 1

    def _shard_of(self, g):
        """This rank's piece, under this array's layout, of the global
        array ``g`` (a tensor or a numpy array)."""
        if not self._scattered():
            return g
        r = self._me()
        if r < 0:
            sl = [slice(0, 0)] + [slice(None)] * (len(self._global_shape) - 1)
            return g[tuple(sl)]
        sl = [slice(None)] * len(self._global_shape)
        off = shard_offsets(self._axis_sizes())[r]
        sl[self._axis] = slice(off, off + self._local_shapes[r][self._axis])
        return g[tuple(sl)]

    def _global(self) -> torch.Tensor:
        """The whole array on every rank (an all-gather for SCATTER). The
        shards span the world whatever the mask, so the gather does too:
        a mask groups only the reductions."""
        if self._partition != Partition.SCATTER:
            return self._arr
        if self._mesh is not None:
            if self._me() < 0:
                raise RuntimeError("this rank holds no shard of the array's "
                                   "mesh: only its members gather it")
            return collectives.all_gather(self._arr, self._axis_sizes(),
                                          self._axis, self._mesh.group)
        return collectives.all_gather(self._arr, self._axis_sizes(),
                                      self._axis)

    def _group(self):
        if self._mask is None and self._mesh is not None:
            return self._mesh.group
        return collectives.mask_group(self._mask)

    def _relayout(self, local_shapes) -> "DistributedArray":
        """The same array under another split along the same axis: a
        gather and this rank's slice of it."""
        local_shapes = tuple(tuple(int(v) for v in s) for s in local_shapes)
        if local_shapes == self._local_shapes:
            return self
        out = DistributedArray._wrap(None, self, local_shapes=local_shapes)
        out._arr = out._shard_of(collectives.all_gather(
            self._arr, self._axis_sizes(), self._axis)).contiguous()
        return out

    # ------------------------------------------------------ create/gather
    @classmethod
    def to_dist(cls, x, partition: Partition = Partition.SCATTER,
                axis: int = 0, local_shapes=None, mask=None,
                device: DeviceLike = None, *, mesh=None) -> "DistributedArray":
        """Place a global array (ref ``DistributedArray.py:408-461``):
        every rank passes the whole ``x`` and keeps its shard. A numpy
        array goes to ``device`` (default ``"cuda"``); a tensor stays on
        its own device unless ``device`` is given. ``mesh``: a
        sub-group's (module docstring)."""
        out = cls.__new__(cls)
        out._set_layout(tuple(np.shape(x)), partition, axis, local_shapes,
                        mask, mesh)
        if isinstance(x, torch.Tensor):
            dev = x.device if device is None else resolve_device(device)
            t = out._shard_of(x)
        else:
            dev = resolve_device(device)
            t = torch.tensor(np.ascontiguousarray(out._shard_of(np.asarray(x))))
        if out._scattered():
            t = t.contiguous()
        out._arr = t.to(dev)
        return out

    def asarray(self) -> np.ndarray:
        """The global array on the host (ref ``DistributedArray.py:371-406``),
        gathered from every rank (collective). bf16/f16 arrays come back
        as float32 (numpy has no bfloat16)."""
        a = self._global().detach()
        if a.dtype in (torch.bfloat16, torch.float16):
            a = a.float()
        return a.cpu().numpy()

    def local_arrays(self) -> List[np.ndarray]:
        """This rank's shard on the host, in a list (the JAX package lists
        every shard; a rank sees only its own)."""
        a = self._arr.detach()
        if a.dtype in (torch.bfloat16, torch.float16):
            a = a.float()
        return [a.cpu().numpy()]

    # --------------------------------------------------------- get / set
    def __getitem__(self, key):
        """Index this rank's shard, as the reference's ``local_array``."""
        return self._arr[key]

    def __setitem__(self, key, value):
        arr = self._arr.clone()
        arr[key] = torch.as_tensor(value, dtype=self.dtype, device=self.device)
        self._arr = arr

    def fill(self, value) -> None:
        self[:] = value

    # --------------------------------------------------------- arithmetic
    def _check_compat(self, other: "DistributedArray") -> None:
        if self._global_shape != other._global_shape:
            raise ValueError(
                f"Global shape mismatch {self._global_shape} != {other._global_shape}")
        if self._partition != other._partition:
            raise ValueError(
                f"Partition mismatch {self._partition} != {other._partition}")
        if self._mask != other._mask:
            raise ValueError("Mask mismatch")

    def _coerce_operand(self, x):
        """``x``'s local tensor under this array's layout: arrays split
        differently are gathered and re-sliced, as the JAX package
        repacks them (the reference raises)."""
        if isinstance(x, DistributedArray):
            self._check_compat(x)
            if x._axis != self._axis or x._local_shapes != self._local_shapes:
                return self._shard_of(x._global())
            return x._arr
        return x

    def add(self, x):
        return DistributedArray._wrap(self._arr + self._coerce_operand(x), self)

    def iadd(self, x):
        self._arr = self._arr + self._coerce_operand(x)
        return self

    def multiply(self, x):
        return DistributedArray._wrap(self._arr * self._coerce_operand(x), self)

    def __add__(self, x):
        return self.add(x)

    def __radd__(self, x):
        return self.add(x)

    def __iadd__(self, x):
        return self.iadd(x)

    def __sub__(self, x):
        return DistributedArray._wrap(self._arr - self._coerce_operand(x), self)

    def __rsub__(self, x):
        return DistributedArray._wrap(self._coerce_operand(x) - self._arr, self)

    def __isub__(self, x):
        self._arr = self._arr - self._coerce_operand(x)
        return self

    def __mul__(self, x):
        return self.multiply(x)

    def __rmul__(self, x):
        return self.multiply(x)

    def __truediv__(self, x):
        return DistributedArray._wrap(self._arr / self._coerce_operand(x), self)

    def __neg__(self):
        return DistributedArray._wrap(-self._arr, self)

    # --------------------------------------------------------- reductions
    def _reduces(self) -> bool:
        """SCATTER arrays reduce over the group; BROADCAST ones hold the
        whole array on every rank and do not (JAX ``:515-517``)."""
        return self._partition == Partition.SCATTER

    def _dot_local(self, y: "DistributedArray", vdot: bool) -> torch.Tensor:
        a = self._arr.conj() if vdot else self._arr
        z = a * self._coerce_operand(y)
        return torch.sum(z.to(accum_dtype(z.dtype)))

    def dot(self, y: "DistributedArray", vdot: bool = False) -> torch.Tensor:
        """Dot product (ref ``DistributedArray.py:655-687``), as a 0-d
        tensor on the array's device; ``vdot=True`` conjugates
        ``self``. The local partial is reduced with one ``all_reduce``."""
        z = self._dot_local(y, vdot)
        if not self._reduces():
            return z
        return collectives.all_reduce(z, "sum", self._group())

    def col_dot(self, y: "DistributedArray", vdot: bool = False) -> torch.Tensor:
        """Per-column dot of a block ``(N, K)`` vector sharded on axis 0:
        the ``(K,)`` column dots (JAX ``distributedarray.py:520``)."""
        if self.ndim != 2:
            raise ValueError(
                f"col_dot needs a 2-D (rows, columns) array, got "
                f"global_shape={self._global_shape}")
        if self._axis != 0:
            raise ValueError("col_dot needs the row axis sharded (axis=0)")
        if self._mask is not None:
            raise NotImplementedError(
                "col_dot does not support masked (sub-communicator) arrays")
        a = self._arr.conj() if vdot else self._arr
        z = a * self._coerce_operand(y)
        z = torch.sum(z.to(accum_dtype(z.dtype)), dim=0)
        if not self._reduces():
            return z
        return collectives.all_reduce(z, "sum")

    @staticmethod
    def _norm_op(ord) -> str:
        if ord == np.inf:
            return "max"
        if ord == -np.inf:
            return "min"
        return "sum"

    def _norm_local(self, ord) -> torch.Tensor:
        """This rank's partial of the flat ``ord``-norm: the count of
        nonzeros (0), the largest or smallest magnitude (±inf), or the
        sum of ``|x|**ord``."""
        x = self._arr
        if not x.is_complex():
            x = x.to(accum_dtype(x.dtype))
        ax = torch.abs(x)
        if ord == 0:
            return torch.count_nonzero(x).to(ax.dtype)
        if ord in (np.inf, -np.inf):
            if ax.numel() == 0:  # an empty shard: the reduction's identity
                return ax.new_full((), 0.0 if ord == np.inf else np.inf)
            return torch.max(ax) if ord == np.inf else torch.min(ax)
        return torch.sum(ax ** ord)

    @staticmethod
    def _norm_finish(p: torch.Tensor, ord) -> torch.Tensor:
        if ord in (0, np.inf, -np.inf):
            return p
        return p ** (1.0 / ord)

    def norm(self, ord=None, axis: Optional[int] = None) -> torch.Tensor:
        """``numpy.linalg.norm`` of the array
        (ref ``DistributedArray.py:775-808``): ``axis=None`` flattens;
        ``ord`` is one of ``None``/2, 1, ``inf``, ``-inf``, 0 or any
        positive number. Returns a tensor on the array's device; with
        ``axis`` given, the norms of the gathered array."""
        if axis is not None:
            if axis >= self.ndim:
                raise ValueError(f"axis={axis} out of range for ndim={self.ndim}")
            x = self._global()
            if not x.is_complex():
                x = x.to(accum_dtype(x.dtype))
            return torch.linalg.vector_norm(
                x, ord=2 if ord is None else ord, dim=axis)
        ord = 2 if ord is None else ord
        if ord in ("fro", "nuc"):
            raise ValueError(f"norm-{ord} not possible for vectors")
        p = self._norm_local(ord)
        if self._reduces():
            p = collectives.all_reduce(p, self._norm_op(ord), self._group())
        return self._norm_finish(p, ord)

    # ------------------------------------------------------------ algebra
    def conj(self) -> "DistributedArray":
        return DistributedArray._wrap(torch.conj_physical(self._arr), self)

    def copy(self) -> "DistributedArray":
        return DistributedArray._wrap(self._arr.clone(), self)

    def zeros_like(self) -> "DistributedArray":
        return DistributedArray._wrap(torch.zeros_like(self._arr), self)

    def empty_like(self) -> "DistributedArray":
        return self.zeros_like()

    def ravel(self, order: str = "C") -> "DistributedArray":
        """Shard-major flatten (ref ``DistributedArray.py:847-875``): the
        concatenation of each shard's C-order ravel, which is each rank's
        local ravel; the global ravel when ``axis == 0``."""
        if order not in ("C", "K", "A"):
            raise NotImplementedError("only C-order ravel is supported")
        return DistributedArray._wrap(
            self._arr.reshape(-1), self, axis=0, global_shape=(self.size,),
            local_shapes=tuple((int(np.prod(s)),) for s in self._local_shapes))

    def redistribute(self, axis: int) -> "DistributedArray":
        """Change the sharded axis (ref ``DistributedArray.py:463-522``)
        through the bounded-memory planner (``parallel/reshard.py``): with
        no budget set, one all-to-all, rank ``p`` sending rank ``q`` its
        rows cut to ``q``'s new slice; under
        ``PYLOPS_MPI_TPU_TORCH_RESHARD_BUDGET``, that exchange in chunks."""
        if self._partition != Partition.SCATTER:
            raise ValueError("redistribute only applies to SCATTER arrays")
        if axis < 0:
            axis += self.ndim
        if axis == self._axis:
            return self.copy()
        from .parallel import reshard as _reshard
        return _reshard.reshard(self, axis=axis)

    def to_partition(self, partition: Partition,
                     axis: Optional[int] = None) -> "DistributedArray":
        """Convert between BROADCAST and SCATTER placements (JAX
        ``distributedarray.py:670``) through the planner."""
        from .parallel import reshard as _reshard
        return _reshard.reshard(self, partition=partition,
                                axis=self._axis if axis is None else axis)

    def reshard(self, *, mesh=None, partition: Optional[Partition] = None,
                axis: Optional[int] = None, local_shapes=None, budget=_UNSET,
                chunks: Optional[int] = None) -> "DistributedArray":
        """Move to any layout (partition, axis, ragged split) and/or
        another world (``mesh``) with each rank's scratch under
        ``budget`` (default ``PYLOPS_MPI_TPU_TORCH_RESHARD_BUDGET``); see
        :func:`~.parallel.reshard.reshard`. Collective over the world."""
        from .parallel import reshard as _reshard
        return _reshard.reshard(
            self, mesh=mesh, partition=partition, axis=axis,
            local_shapes=local_shapes,
            budget=budget, chunks=chunks)

    def to_host(self, *, budget=_UNSET, chunks: Optional[int] = None,
                overlap: Optional[str] = None):
        """Park this array in host RAM as a
        :class:`~.parallel.spill.HostArray` (each rank its shard, pinned
        from a card), chunk by chunk under ``budget``;
        ``HostArray.to_device()`` is the inverse."""
        from .parallel import spill as _spill
        return _spill.to_host(self, budget=budget, chunks=chunks,
                              overlap=overlap)

    def add_ghost_cells(self, cells_front: Optional[int] = None,
                        cells_back: Optional[int] = None) -> torch.Tensor:
        """This rank's shard extended with the previous rank's last
        ``cells_front`` and the next rank's first ``cells_back`` entries
        along the sharded axis (ref ``DistributedArray.py:877-954``); the
        first and last ranks get none on their outer side."""
        front = int(cells_front) if cells_front else 0
        back = int(cells_back) if cells_back else 0
        sizes = self._axis_sizes()
        for i in range(1, self.n_shards):
            if front > sizes[i - 1]:
                raise ValueError(
                    f"Local shape {sizes[i - 1]} along axis={self._axis} "
                    f"must be >= ghost width {front}")
        for i in range(self.n_shards - 1):
            if back > sizes[i + 1]:
                raise ValueError(
                    f"Local shape {sizes[i + 1]} along axis={self._axis} "
                    f"must be >= ghost width {back}")
        if self._partition != Partition.SCATTER:
            return self._arr
        b = torch.movedim(self._arr, self._axis, 0).contiguous()
        top, bottom = collectives.halo_exchange(b, front, back)
        parts = [p for p in (top, b, bottom) if isinstance(p, torch.Tensor)]
        return torch.movedim(torch.cat(parts), 0, self._axis)

    def __repr__(self):
        return (f"<DistributedArray global_shape={self._global_shape}, "
                f"local_shape={self.local_shape}, "
                f"partition={self._partition.name}, axis={self._axis}, "
                f"dtype={self.dtype}, device={self.device}>")
