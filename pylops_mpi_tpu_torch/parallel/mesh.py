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
rank its row and column sub-groups (the JAX package's ``make_mesh_2d``);
:func:`make_mesh_hybrid` lays them hosts × ranks-per-host
(``parallel/topology.py``). :func:`sub_mesh` describes a sub-group of
the world as a :class:`Mesh` (a move to a smaller world names one), and
:func:`detach` lets a survivor whose peers died go on as a world of one
without the group's shutdown, which would wait on the dead.

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
           "make_grid_2d", "make_mesh_hybrid", "sub_mesh", "detach"]

DeviceLike = Union[str, torch.device, None]

_DEFAULT_DEVICE = torch.device("cuda")


@dataclass(frozen=True)
class Mesh:
    """The process group as an operator sees it: the group handle
    (``None`` without a group), this process's rank, the number of
    ranks, the device that holds this rank's shards, and the backend
    (``"nccl"``, ``"gloo"``, or ``None`` without a group). ``ranks``
    lists the world ranks of a sub-group's members in order (``None``:
    the whole world); on a rank outside the sub-group ``rank`` is -1."""

    group: Optional[object]
    rank: int
    size: int
    device: torch.device
    backend: Optional[str] = None
    ranks: Optional[Tuple[int, ...]] = None

    @property
    def member(self) -> bool:
        """This process holds a rank of the mesh."""
        return self.rank >= 0

    def world_ranks(self) -> Tuple[int, ...]:
        """The world rank of each of the mesh's ranks, in order."""
        return tuple(range(self.size)) if self.ranks is None \
            else tuple(self.ranks)


_MESH: Optional[Mesh] = None
# set by detach(): the group object lives on, but this process acts as a
# world of one
_DETACHED = False


def initialized() -> bool:
    """A default process group exists (and this process was not
    :func:`detach` ed from it)."""
    return dist.is_available() and dist.is_initialized() and not _DETACHED


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


# rendezvous failures worth another try (a store not listening yet); a
# wrong argument raises at once
_TRANSIENT = (TimeoutError, ConnectionError,
              getattr(dist, "DistStoreError", TimeoutError),
              getattr(dist, "DistNetworkError", ConnectionError))


def init(backend: Optional[str] = None, store=None, rank: Optional[int] = None,
         world_size: Optional[int] = None, device: DeviceLike = None,
         init_method: Optional[str] = None) -> Mesh:
    """Start the default process group and return its :class:`Mesh`.

    ``backend`` defaults to NCCL when ``device`` is a CUDA device (or
    none is given and a GPU exists) and gloo otherwise. ``store`` (e.g.
    a :class:`torch.distributed.FileStore`) or ``init_method``
    (``tcp://localhost:<port>``) rendezvous the ranks; with neither, the
    ``torchrun`` environment does. A CUDA device becomes the current
    device, so ``"cuda"`` names the rank's card. The bring-up runs
    under :func:`~..resilience.retry.retry_call` (a rendezvous that
    timed out or was refused is tried again) and
    :func:`~..resilience.elastic.watched_call` (stage
    ``multihost_init``), as the JAX package's bring-up does
    (``parallel/mesh.py:133``)."""
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
    # the bring-up waits on every peer: a lost rendezvous is retried
    # (bounded) and, under a supervisor, the whole wait is watched
    from ..resilience.elastic import watched_call
    from ..resilience.retry import retry_call
    watched_call(retry_call, dist.init_process_group, backend,
                 exceptions=_TRANSIENT, describe="init_process_group",
                 stage="multihost_init", **kwargs)
    global _MESH, _DETACHED
    _DETACHED = False
    mesh = make_mesh(device=device)
    if mesh.device.type == "cuda":
        torch.cuda.set_device(mesh.device)
    _MESH = mesh
    _gather_hosts()
    return mesh


def _gather_hosts() -> None:
    """Each world rank's host name, gathered once here, where every rank
    calls (``parallel/topology.py``)."""
    import socket
    from . import topology
    n = world_size()
    names = [None] * n
    if n > 1:
        dist.all_gather_object(names, socket.gethostname())
    else:
        names = [socket.gethostname()]
    topology.set_world_hosts(names)


def destroy() -> None:
    """End the default process group (and forget its sub-groups)."""
    global _MESH, _DETACHED
    from . import collectives, topology
    collectives.forget_groups()
    topology.set_world_hosts(None)
    _MESH = None
    if initialized():
        dist.destroy_process_group()
    _DETACHED = False


def detach() -> None:
    """Go on as a world of one without ending the process group: forget
    the mesh and the sub-groups, and make :func:`initialized` false. No
    call waits on a peer (``destroy_process_group`` would, on a dead one,
    for ever); the group object is left to the process's exit, which
    must be ``os._exit`` for the same reason. The in-place recovery's
    :func:`~..resilience.elastic.reform_mesh` calls it."""
    global _MESH, _DETACHED
    from . import collectives, topology
    collectives.forget_groups()
    topology.set_world_hosts(None)
    _MESH = None
    _DETACHED = True


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


def sub_mesh(ranks, device: DeviceLike = None) -> Mesh:
    """A :class:`Mesh` over the world ranks ``ranks`` (in that order):
    its group is ``dist.new_group(ranks)``, which every rank of the world
    must call, in the same order (cached per rank list, like the mask
    groups). On a rank outside it the mesh's ``rank`` is -1. The world's
    own rank list gives the default mesh; without a process group only
    ``[0]`` is valid and gives the world of one."""
    ranks = tuple(int(r) for r in ranks)
    n = world_size()
    if not ranks or len(set(ranks)) != len(ranks) \
            or any(not 0 <= r < n for r in ranks):
        raise ValueError(f"sub_mesh: {ranks} is not a list of distinct "
                         f"ranks of the world of {n}")
    if ranks == tuple(range(n)):
        return default_mesh() if device is None else make_mesh(device)
    from . import collectives
    group = collectives.rank_group(ranks)
    me = rank()
    base = default_mesh()
    dev = base.device if device is None else resolve_device(device)
    return Mesh(group, ranks.index(me) if me in ranks else -1, len(ranks),
                dev, base.backend, ranks)


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
    axis_names: Tuple[str, str] = ("r", "c")


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


def make_mesh_2d(n_devices: Optional[int] = None,
                 axis_names: Tuple[str, str] = ("r", "c"),
                 grid: Optional[Tuple[int, int]] = None) -> Grid2D:
    """The JAX package's ``make_mesh_2d`` under its name:
    :func:`make_grid_2d` of ``grid``. The port's grid spans the process
    group, so ``n_devices`` must be its size, and its sub-groups are the
    axes ``r`` and ``c``."""
    n = world_size()
    if n_devices is not None and int(n_devices) != n:
        raise ValueError(f"make_mesh_2d: the grid spans the process group "
                         f"of {n} ranks, not {n_devices} (make_grid_2d)")
    if tuple(axis_names) != ("r", "c"):
        raise ValueError(f"make_mesh_2d: the grid's axes are ('r', 'c'), "
                         f"not {tuple(axis_names)} (make_grid_2d)")
    return make_grid_2d(grid)


def initialize_multihost(*args, **kwargs) -> None:
    """The JAX package's bring-up of a multi-host job. Its counterpart is
    :func:`init`, which takes the rendezvous itself: this raises, naming
    it."""
    raise NotImplementedError(
        "initialize_multihost joins a multi-host JAX job; the port's "
        "counterpart is pylops_mpi_tpu_torch.parallel.init(backend, "
        "store= or init_method='tcp://<host>:<port>', rank=, world_size=)")


def set_default_mesh(mesh: Optional[Mesh]) -> None:
    """The JAX package's ``set_default_mesh``: arrays and operators here
    live on the process group's world unless given ``mesh=``, so the
    world's mesh sets only the default device (:func:`set_default_device`;
    ``None`` restores ``"cuda"``). A sub-group's mesh is refused."""
    if mesh is not None and mesh.ranks is not None:
        raise ValueError("set_default_mesh takes the world's mesh: pass a "
                         "sub-group's mesh as mesh= to the arrays and "
                         "operators that live on it")
    set_default_device(None if mesh is None else mesh.device)


def make_mesh_hybrid(ici_axis: str = "nvlink", dcn_axis: str = "ib",
                     dcn_size: Optional[int] = None) -> Grid2D:
    """The world as a 2-D grid whose outer axis (``dcn_axis``, IB)
    crosses hosts and whose inner axis (``ici_axis``, NVLink) stays on
    one (JAX ``make_mesh_hybrid``, ``parallel/mesh.py:142-173``): ranks
    row-major, so a row is one host's ranks (rank-major launches, as
    ``torchrun`` assigns them). ``dcn_size`` defaults to the number of
    hosts (``parallel/topology.py``); it must divide the world, and the
    error lists the sizes that do. With one host the grid is one row.
    The row and column sub-groups are :func:`make_grid_2d`'s: ``c`` the
    ranks of this rank's host, ``r`` its peers on the other hosts."""
    from . import topology
    topology.refresh()
    n = world_size()
    if dcn_size is None:
        dcn_size = len({topology._slice_of(r) for r in range(n)})
    dcn_size = int(dcn_size)
    if dcn_size > 1 and n % dcn_size:
        divisors = [d for d in range(1, n + 1) if n % d == 0]
        raise ValueError(
            f"make_mesh_hybrid: dcn_size={dcn_size} does not divide the "
            f"rank count {n}; every host must hold the same number of "
            f"ranks. Valid dcn_size values here: {divisors}")
    d = max(dcn_size, 1)
    g = make_grid_2d((d, n // d))
    return Grid2D(g.shape, g.coords, g.c, g.r, (dcn_axis, ici_axis))
