"""Device, world and process group.

PyTorch counterpart of ``pylops_mpi_tpu/parallel/mesh.py``. The JAX
package lays one controller's arrays over a device mesh; the port runs
SPMD, as the reference does under ``mpiexec -n P``: every rank runs the
same script and holds its own shard, and ``torch.distributed`` is the
mesh. NCCL carries the collectives between cards and gloo between CPU
processes.

With no process group initialized the world is one rank (rank 0 of 1)
and nothing communicates, which matches the reference run without
``mpiexec``. :func:`init` starts a group; :func:`default_mesh` describes
it as a :class:`Mesh` (group, rank, size, the rank's device).
:func:`make_grid_2d` lays the ranks row-major on a 2-D grid and gives a
rank its row and column sub-groups (the JAX package's ``make_mesh_2d``).

Entry points run on the card unless the caller asks for the CPU: the
default device is ``"cuda"``, and asking for it on a machine without a
GPU raises instead of quietly running on the CPU.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_mesh", "default_mesh", "init", "destroy",
           "default_device", "set_default_device", "resolve_device",
           "world_size", "rank", "check_mesh", "best_grid_2d", "Grid2D",
           "make_grid_2d"]

DeviceLike = Union[str, torch.device, None]

_DEFAULT_DEVICE = torch.device("cuda")


@dataclass(frozen=True)
class Mesh:
    """The process group as an operator sees it: the group handle
    (``None`` without a group), this process's rank, the number of
    ranks, the device that holds this rank's shards, and the backend
    (``"nccl"``, ``"gloo"``, or ``None`` without a group)."""

    group: Optional[object]
    rank: int
    size: int
    device: torch.device
    backend: Optional[str] = None


_MESH: Optional[Mesh] = None


def initialized() -> bool:
    """A default process group exists."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """Ranks of the default group; 1 without a group."""
    return dist.get_world_size() if initialized() else 1


def rank() -> int:
    """This process's rank in the default group; 0 without a group."""
    return dist.get_rank() if initialized() else 0


def _group_device(backend: str, device: DeviceLike) -> torch.device:
    """The rank's device: explicit when given, else ``cuda:{local_rank %
    device_count}`` for NCCL and ``cpu`` for gloo. Never a CPU stand-in
    for a CUDA device."""
    if device is not None:
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", _local_card())
        return dev
    if backend == "nccl":
        return resolve_device(f"cuda:{_local_card()}")
    return torch.device("cpu")


def _local_card() -> int:
    """``LOCAL_RANK`` (``torchrun``'s), else the rank, modulo the cards."""
    local = int(os.environ.get("LOCAL_RANK", rank()))
    return local % max(torch.cuda.device_count(), 1)


def init(backend: Optional[str] = None, store=None, rank: Optional[int] = None,
         world_size: Optional[int] = None, device: DeviceLike = None,
         init_method: Optional[str] = None) -> Mesh:
    """Start the default process group and return its :class:`Mesh`.

    ``backend`` defaults to NCCL when ``device`` is a CUDA device (or
    none is given and a GPU exists) and gloo otherwise. ``store`` (e.g.
    a :class:`torch.distributed.FileStore`) or ``init_method``
    (``tcp://localhost:<port>``) rendezvous the ranks; with neither, the
    ``torchrun`` environment does. A CUDA device becomes the current
    device, so ``"cuda"`` names the rank's card."""
    if backend is None:
        dev = None if device is None else torch.device(device)
        cuda = (dev.type == "cuda") if dev is not None \
            else torch.cuda.is_available()
        backend = "nccl" if cuda else "gloo"
    kwargs = {}
    if store is not None:
        kwargs["store"] = store
    elif init_method is not None:
        kwargs["init_method"] = init_method
    if rank is not None:
        kwargs["rank"] = rank
    if world_size is not None:
        kwargs["world_size"] = world_size
    if backend == "nccl":
        dev = resolve_device("cuda" if device is None else device)
        if dev.index is None:
            local = int(os.environ.get("LOCAL_RANK", rank or 0))
            dev = torch.device("cuda", local % torch.cuda.device_count())
        kwargs["device_id"] = device = dev
    dist.init_process_group(backend, **kwargs)
    mesh = make_mesh(device=device)
    if mesh.device.type == "cuda":
        torch.cuda.set_device(mesh.device)
    global _MESH
    _MESH = mesh
    return mesh


def destroy() -> None:
    """End the default process group (and forget its sub-groups)."""
    global _MESH
    from . import collectives
    collectives.forget_groups()
    _MESH = None
    if initialized():
        dist.destroy_process_group()


def make_mesh(device: DeviceLike = None) -> Mesh:
    """The :class:`Mesh` of the default group: a world of one on
    :func:`default_device` without a group."""
    if not initialized():
        return Mesh(None, 0, 1, default_device() if device is None
                    else torch.device(device))
    backend = dist.get_backend()
    return Mesh(dist.group.WORLD, rank(), world_size(),
                _group_device(backend, device), backend)


def default_mesh() -> Mesh:
    """The mesh :func:`init` made, or :func:`make_mesh` of the current
    state."""
    if _MESH is not None and initialized():
        return _MESH
    return make_mesh()


def default_device() -> torch.device:
    """The device entry points use when called without ``device=``."""
    return _DEFAULT_DEVICE


def set_default_device(device: DeviceLike) -> None:
    """Change the process-wide default device (``None`` restores
    ``"cuda"``)."""
    global _DEFAULT_DEVICE
    _DEFAULT_DEVICE = torch.device("cuda" if device is None else device)


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a :class:`torch.device`, defaulting to
    :func:`default_device`. A CUDA device on a machine without one
    raises: the port never falls back to the CPU on its own."""
    dev = default_device() if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pylops_mpi_tpu_torch runs on a CUDA device by default, but "
            "torch.cuda.is_available() is False; pass device='cpu' to "
            "run on the CPU")
    return dev


def check_mesh(mesh: Optional[Mesh]) -> None:
    """Refuse a ``mesh`` (the JAX package's argument, kept in its slot
    of every constructor) that does not describe the default process
    group: operators split over the group itself."""
    if mesh is not None and (mesh.size, mesh.rank) != (world_size(), rank()):
        raise ValueError(
            f"mesh of rank {mesh.rank} of {mesh.size} does not match the "
            f"process group (rank {rank()} of {world_size()})")


def best_grid_2d(n: int) -> Tuple[int, int]:
    """The ``(pr, pc)`` grid with ``pr·pc == n`` and ``pr`` the largest
    divisor of ``n`` not above ``√n``: no rank idles (JAX
    ``parallel/mesh.py:63-74``)."""
    pr = int(np.sqrt(n))
    while n % pr != 0:
        pr -= 1
    return pr, n // pr


@dataclass(frozen=True)
class Grid2D:
    """The ranks laid row-major on a ``(pr, pc)`` grid, as this rank sees
    it: its coordinates ``(i, j)`` (rank ``i·pc + j``), and its sub-groups
    named as the JAX package's mesh axes: ``c``, the ranks of its grid
    row (``i`` fixed, group rank ``j``), and ``r``, the ranks of its grid
    column (``j`` fixed, group rank ``i``). Both are ``None`` without a
    process group."""

    shape: Tuple[int, int]
    coords: Tuple[int, int]
    c: Optional[object]
    r: Optional[object]


def make_grid_2d(grid: Optional[Tuple[int, int]] = None) -> Grid2D:
    """The :class:`Grid2D` of the process group on ``grid`` (default
    :func:`best_grid_2d` of the world size; JAX ``make_mesh_2d``,
    ``parallel/mesh.py:77-95``). ``dist.new_group`` is collective over
    the world, so every rank creates every row and every column group,
    in one fixed order, through ``collectives.mask_group`` (cached per
    grid; :func:`destroy` forgets them)."""
    from . import collectives
    n = world_size()
    pr, pc = best_grid_2d(n) if grid is None else (int(grid[0]),
                                                   int(grid[1]))
    if pr < 1 or pc < 1 or pr * pc != n:
        raise ValueError(f"grid {(pr, pc)} does not tile {n} ranks")
    i, j = divmod(rank(), pc)
    c = collectives.mask_group([q // pc for q in range(n)])
    r = collectives.mask_group([q % pc for q in range(n)])
    return Grid2D((pr, pc), (i, j), c, r)
