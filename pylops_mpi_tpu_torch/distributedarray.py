"""DistributedArray: a partitioned tensor with the reference's semantics.

PyTorch counterpart of ``pylops_mpi_tpu/distributedarray.py`` (the
reference's ``pylops_mpi/DistributedArray.py``). The array keeps the
reference's layout metadata — ``partition``, ``axis`` and the balanced
``local_shapes`` of :func:`~.parallel.partition.local_split` — while the
data is one global tensor on one device: this port runs one process
with one device, so the world has size one and every reduction is a
local sum. Sharding over ``torch.distributed`` is a later step.

Reductions (``dot``, ``norm``) return 0-d tensors on the array's device,
so a solver loop never waits for the host. Narrow (bf16/f16) vectors
accumulate at f32 (``ops/_precision.accum_dtype``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .ops._precision import accum_dtype, as_torch_dtype
from .parallel.mesh import DeviceLike, resolve_device, world_size
from .parallel.partition import Partition, local_split

__all__ = ["DistributedArray", "Partition", "local_split"]


class DistributedArray:
    """Partitioned array (ref ``pylops_mpi/DistributedArray.py:74-960``).

    Parameters
    ----------
    global_shape : tuple or int
        Logical global shape.
    partition : Partition
        Placement policy (SCATTER / BROADCAST / UNSAFE_BROADCAST).
    axis : int
        Split dimension for SCATTER.
    local_shapes : list of tuples, optional
        Per-worker shapes (defaults to the balanced split); one per
        worker of :func:`~.parallel.mesh.world_size`.
    dtype : torch or numpy dtype, optional
        Defaults to ``torch.get_default_dtype()``.
    device : str or torch.device, optional
        Defaults to :func:`~.parallel.mesh.default_device` (``"cuda"``).
    """

    def __init__(self, global_shape, partition: Partition = Partition.SCATTER,
                 axis: int = 0,
                 local_shapes: Optional[Sequence[Tuple[int, ...]]] = None,
                 dtype=None, device: DeviceLike = None):
        if isinstance(global_shape, (int, np.integer)):
            global_shape = (int(global_shape),)
        self._set_layout(tuple(int(s) for s in global_shape), partition,
                         axis, local_shapes)
        dtype = as_torch_dtype(dtype) or torch.get_default_dtype()
        self._arr = torch.zeros(self._global_shape, dtype=dtype,
                                device=resolve_device(device))

    def _set_layout(self, global_shape, partition, axis, local_shapes):
        """Validate and store the layout metadata."""
        if partition not in Partition:
            raise ValueError(f"Should be one of {[p for p in Partition]}")
        if axis < 0:
            axis += len(global_shape)
        if partition == Partition.SCATTER and not (0 <= axis < len(global_shape)):
            raise IndexError(f"axis {axis} out of range for shape {global_shape}")
        n_shards = world_size()
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
        self._partition = partition
        self._axis = int(axis)
        self._global_shape = global_shape
        self._local_shapes = local_shapes

    @classmethod
    def _wrap(cls, arr: torch.Tensor, like: "DistributedArray", *,
              global_shape=None, local_shapes=None) -> "DistributedArray":
        """Internal constructor from a global tensor, copying the layout
        metadata of ``like``."""
        out = cls.__new__(cls)
        out._partition = like._partition
        out._axis = like._axis
        out._global_shape = (tuple(global_shape) if global_shape is not None
                             else like._global_shape)
        out._local_shapes = (tuple(tuple(s) for s in local_shapes)
                             if local_shapes is not None else like._local_shapes)
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
        return self._local_shapes[0]

    @property
    def partition(self) -> Partition:
        return self._partition

    @property
    def axis(self) -> int:
        return self._axis

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
        """The global tensor."""
        return self._arr

    @property
    def engine(self) -> str:
        return "torch"

    # ------------------------------------------------------ create/gather
    @classmethod
    def to_dist(cls, x, partition: Partition = Partition.SCATTER,
                axis: int = 0, local_shapes=None,
                device: DeviceLike = None) -> "DistributedArray":
        """Place a global array (ref ``DistributedArray.py:408-461``).
        A numpy array goes to ``device`` (default ``"cuda"``); a tensor
        stays on its own device unless ``device`` is given."""
        if isinstance(x, torch.Tensor):
            dev = x.device if device is None else resolve_device(device)
        else:
            x = torch.tensor(np.asarray(x))
            dev = resolve_device(device)
        out = cls.__new__(cls)
        out._set_layout(tuple(x.shape), partition, axis, local_shapes)
        out._arr = x.to(dev)
        return out

    def asarray(self) -> np.ndarray:
        """The global array on the host (ref ``DistributedArray.py:371-406``).
        bf16/f16 arrays come back as float32 (numpy has no bfloat16)."""
        a = self._arr.detach()
        if a.dtype in (torch.bfloat16, torch.float16):
            a = a.float()
        return a.cpu().numpy()

    # --------------------------------------------------------- get / set
    def __getitem__(self, key):
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

    def _coerce_operand(self, x):
        if isinstance(x, DistributedArray):
            self._check_compat(x)
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
    def dot(self, y: "DistributedArray", vdot: bool = False) -> torch.Tensor:
        """Dot product (ref ``DistributedArray.py:655-687``), as a 0-d
        tensor on the array's device; ``vdot=True`` conjugates
        ``self``."""
        a = self._arr.conj() if vdot else self._arr
        z = a * self._coerce_operand(y)
        return torch.sum(z.to(accum_dtype(z.dtype)))

    def norm(self, ord=None, axis: Optional[int] = None) -> torch.Tensor:
        """``numpy.linalg.norm`` of the array
        (ref ``DistributedArray.py:775-808``): ``axis=None`` flattens;
        ``ord`` is one of ``None``/2, 1, ``inf``, ``-inf``, 0 or any
        positive number. Returns a tensor on the array's device."""
        x = self._arr
        if not x.is_complex():
            x = x.to(accum_dtype(x.dtype))
        if axis is not None:
            if axis >= self.ndim:
                raise ValueError(f"axis={axis} out of range for ndim={self.ndim}")
            return torch.linalg.vector_norm(
                x, ord=2 if ord is None else ord, dim=axis)
        ord = 2 if ord is None else ord
        if ord in ("fro", "nuc"):
            raise ValueError(f"norm-{ord} not possible for vectors")
        ax = torch.abs(x)
        if ord == 0:
            return torch.count_nonzero(x).to(ax.dtype)
        if ord == np.inf:
            return torch.max(ax)
        if ord == -np.inf:
            return torch.min(ax)
        return torch.sum(ax ** ord) ** (1.0 / ord)

    # ------------------------------------------------------------ algebra
    def conj(self) -> "DistributedArray":
        return DistributedArray._wrap(torch.conj_physical(self._arr), self)

    def copy(self) -> "DistributedArray":
        return DistributedArray._wrap(self._arr.clone(), self)

    def zeros_like(self) -> "DistributedArray":
        return DistributedArray._wrap(torch.zeros_like(self._arr), self)

    def empty_like(self) -> "DistributedArray":
        return self.zeros_like()

    def __repr__(self):
        return (f"<DistributedArray global_shape={self._global_shape}, "
                f"partition={self._partition.name}, axis={self._axis}, "
                f"dtype={self.dtype}, device={self.device}>")
