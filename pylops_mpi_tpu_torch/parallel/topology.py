"""Fabric topology: which grid axes stay on one host and which cross hosts.

PyTorch counterpart of ``pylops_mpi_tpu/parallel/topology.py:65-271``.
The JAX package names two fabrics, ICI (the links within a TPU slice)
and DCN (the network between slices). The port's are:

==========  ==========  ===============================================
JAX         port        what it is
==========  ==========  ===============================================
``ici``     ``nvlink``  ranks on one host: NVLink between its cards
``dcn``     ``ib``      ranks on different hosts: InfiniBand between
                        the hosts' NICs
==========  ==========  ===============================================

A JAX "slice" is a host here. The port's meshes are process groups, so
the topology question is asked of ranks: which host runs each rank of
the world? Two sources answer it, most specific first:

1. ``PYLOPS_MPI_TPU_TORCH_FABRIC="DxI"`` declares the world to be D
   hosts of I ranks each, rank-major (rank ``r`` on host ``r // I``), as
   the JAX package parses its ``DxI`` over device ids. It lets one
   machine rehearse a multi-host layout.
2. The ranks' host names, gathered once for the world by
   :func:`~.mesh.init` (every rank calls it, so the one
   ``all_gather_object`` it issues is collective by construction; a
   gather issued lazily from a key computation would hang the first
   time only some ranks compute a key). A sub-group's hosts are those of
   its world ranks. Without a process group the world is one rank on
   one host.

A grid is anything with ``axis_names`` and a rank array: a
:class:`~.mesh.Mesh` is one axis (``"sp"``) over its ranks, a
:class:`~.mesh.Grid2D` (from :func:`~.mesh.make_grid_2d` or
:func:`~.mesh.make_mesh_hybrid`) two axes over the world's ranks laid
row-major. An axis named ``ib…`` is IB by construction (the
:func:`~.mesh.make_mesh_hybrid` convention).

The answers feed the per-fabric byte split of the collectives
(``.bytes_nvlink``/``.bytes_ib`` beside ``.bytes``; the world's layout
for it is computed by :func:`refresh` at ``init`` and at each
:func:`~.mesh.make_mesh_hybrid`, not at every count), the planner's
per-fabric split (``parallel/reshard.py``), the split of the neighbour
exchanges' ghost bytes pair by pair (:func:`peer_fabric`), the two-level
schedules' sub-groups (:func:`hier_groups`), the cost model's IB term,
and :func:`topology_key`, the plan-cache key segment that keeps a plan
measured on one layout from being replayed on another. A flat world
(every rank on one host, or one rank per host) gives an empty key, so
every plan key banked before stays verbatim.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

__all__ = ["fabric_override", "axis_fabric", "mesh_fabrics", "is_hybrid",
           "hybrid_axes", "topology_key", "collective_fabric", "slice_map",
           "slice_run", "perm_crossings", "group_fabric", "world_key",
           "world_shape", "hier_groups", "peer_fabric",
           "FABRIC_GBPS", "FABRIC_ENV"]

FABRIC_ENV = "PYLOPS_MPI_TPU_TORCH_FABRIC"

# Per-fabric bandwidths, GB/s per card and direction, for the
# fabric-relative placement the JAX package's FABRIC_GBPS gives: NVLink
# 4 on an H100 SXM (the data sheet's 900 GB/s over 18 links,
# bidirectional, halved), and an ASSUMED 400 Gb/s NDR InfiniBand NIC per
# card (50 GB/s), not a measurement. diagnostics/costmodel.py carries
# the card-resolved tables.
FABRIC_GBPS: Dict[str, float] = {"nvlink": 450.0, "ib": 50.0}

# the world's host index per rank, set by mesh.init (None: unknown, and
# then every rank counts as one host)
_WORLD_HOSTS: Optional[Tuple[int, ...]] = None


# the world's (D, I) layout (world_shape), computed where the layout is
# set rather than on every collective's count
_WORLD_SHAPE: Optional[Tuple[int, int]] = None


def set_world_hosts(names: Optional[Sequence[str]]) -> None:
    """Record the host name of each world rank (``None`` forgets them):
    hosts are numbered in order of first appearance. Then
    :func:`refresh`."""
    global _WORLD_HOSTS, _WORLD_SHAPE
    if names is None:
        _WORLD_HOSTS = None
        _WORLD_SHAPE = None
        _GROUP_FABRIC.clear()
        return
    index: Dict[str, int] = {}
    _WORLD_HOSTS = tuple(index.setdefault(str(n), len(index))
                         for n in names)
    refresh()


def refresh() -> None:
    """Recompute the world's layout from the host names and
    ``PYLOPS_MPI_TPU_TORCH_FABRIC`` and drop the per-group fabrics:
    :func:`~.mesh.init` calls it through :func:`set_world_hosts`, and
    :func:`~.mesh.make_mesh_hybrid` before it lays out a grid, so an
    override set after ``init`` counts from the next hybrid grid on."""
    global _WORLD_SHAPE
    _GROUP_FABRIC.clear()
    _WORLD_SHAPE = world_shape()
    # the two-level schedules' sub-groups: dist.new_group is collective
    # over the world, so they are made here, where every rank calls, and
    # never first by an operator that only some ranks build
    hier_groups()


def fabric_override() -> Optional[Tuple[int, int]]:
    """``PYLOPS_MPI_TPU_TORCH_FABRIC`` as ``(hosts, ranks_per_host)``,
    or ``None`` when unset or empty. A malformed value raises (a typo
    must not fall back to a flat layout)."""
    raw = os.environ.get(FABRIC_ENV, "").strip().lower()
    if not raw:
        return None
    parts = raw.split("x")
    if len(parts) != 2:
        raise ValueError(
            f"{FABRIC_ENV}={raw!r}: expected 'DxI' (hosts x "
            "ranks-per-host), e.g. '2x4'")
    try:
        d, i = int(parts[0]), int(parts[1])
    except ValueError:
        raise ValueError(
            f"{FABRIC_ENV}={raw!r}: expected 'DxI' with "
            "integer D and I, e.g. '2x4'") from None
    if d < 1 or i < 1:
        raise ValueError(f"{FABRIC_ENV}={raw!r}: D and I must be >= 1")
    return d, i


def _slice_of(r: int) -> int:
    """Host index of world rank ``r``: the override's rank-major blocks,
    else the gathered host names, else 0."""
    ov = fabric_override()
    if ov is not None and ov[0] > 1:
        return int(r) // max(ov[1], 1)
    hosts = _WORLD_HOSTS
    if hosts is not None and 0 <= int(r) < len(hosts):
        return hosts[int(r)]
    return 0


def _grid(mesh) -> Tuple[Tuple[str, ...], np.ndarray]:
    """``(axis_names, ranks)`` of a :class:`~.mesh.Mesh` (one axis over
    its world ranks) or of a 2-D grid (its ``shape`` over the world's
    ranks row-major)."""
    if hasattr(mesh, "coords"):  # Grid2D
        names = tuple(getattr(mesh, "axis_names", ("r", "c")))
        return names, np.arange(int(np.prod(mesh.shape))).reshape(
            tuple(mesh.shape))
    ranks = getattr(mesh, "ranks", None)
    if ranks is None:
        ranks = range(int(mesh.size))
    return ("sp",), np.asarray(list(ranks), dtype=np.int64)


def axis_fabric(mesh, axis: Union[str, int]) -> str:
    """``"nvlink"`` or ``"ib"`` for one grid axis (by name or index): IB
    when its name starts with ``ib`` or when a step along it crosses a
    host for any fiber of the rank array; an axis of one rank is
    NVLink."""
    names, ranks = _grid(mesh)
    if isinstance(axis, str):
        ax = list(names).index(axis)
        name = axis
    else:
        ax = int(axis)
        name = names[ax]
    if str(name).lower().startswith("ib"):
        return "ib"
    if ranks.shape[ax] <= 1:
        return "nvlink"
    fibers = np.moveaxis(ranks, ax, -1).reshape(-1, ranks.shape[ax])
    for fiber in fibers:
        if len({_slice_of(r) for r in fiber}) > 1:
            return "ib"
    return "nvlink"


def mesh_fabrics(mesh) -> Dict[str, str]:
    """Axis name → fabric for every axis of ``mesh``."""
    names, _ = _grid(mesh)
    return {str(n): axis_fabric(mesh, i) for i, n in enumerate(names)}


def is_hybrid(mesh) -> bool:
    """Both an IB axis and an NVLink axis of more than one rank: the
    shape a hierarchical schedule decomposes over. A one-axis grid is
    never hybrid, even across hosts."""
    names, ranks = _grid(mesh)
    fabs = [(axis_fabric(mesh, i), int(ranks.shape[i]))
            for i in range(ranks.ndim)]
    return (any(f == "ib" and s > 1 for f, s in fabs)
            and any(f == "nvlink" and s > 1 for f, s in fabs))


def hybrid_axes(mesh) -> Optional[Tuple[str, str, int, int]]:
    """``(ib_axis, nvlink_axis, hosts, ranks_per_host)`` of a two-axis
    hybrid grid, or ``None`` when the grid is not hybrid or has more
    than one axis of a fabric."""
    if not is_hybrid(mesh):
        return None
    names, ranks = _grid(mesh)
    ib = [(str(n), int(ranks.shape[i])) for i, n in enumerate(names)
          if axis_fabric(mesh, i) == "ib" and ranks.shape[i] > 1]
    nv = [(str(n), int(ranks.shape[i])) for i, n in enumerate(names)
          if axis_fabric(mesh, i) == "nvlink" and ranks.shape[i] > 1]
    if len(ib) != 1 or len(nv) != 1:
        return None
    return ib[0][0], nv[0][0], ib[0][1], nv[0][1]


def topology_key(mesh) -> str:
    """Plan-cache key segment: empty for every grid that is not hybrid
    (all plan keys banked before keep their keys), ``ib{D}xnvlink{I}``
    for a hybrid grid (JAX ``dcn{D}xici{I}``)."""
    if mesh is None:
        return ""
    h = hybrid_axes(mesh)
    if h is None:
        return ""
    _, _, d, i = h
    return f"ib{d}xnvlink{i}"


def world_shape() -> Optional[Tuple[int, int]]:
    """``(D, I)`` when the world spans D hosts of I ranks each,
    rank-major, with ``1 < D < world`` (:func:`~.mesh.make_mesh_hybrid`'s
    grid is hybrid), else ``None``."""
    from .mesh import world_size
    n = world_size()
    hosts = [_slice_of(r) for r in range(n)]
    d = len(set(hosts))
    if d <= 1 or d >= n or n % d:
        return None
    i = n // d
    order = list(dict.fromkeys(hosts))
    if hosts != [order[r // i] for r in range(n)]:
        return None
    return d, i


def hier_groups() -> Optional[Tuple[object, object, int, int]]:
    """``(ib_group, nvlink_group, D, I)`` on a world laid out as ``D``
    hosts of ``I`` ranks (:func:`world_shape`; then ``D > 1`` and
    ``I > 1``), else ``None``. The NVLink group is the ranks of this
    rank's host (its group rank the rank's place ``l`` on the host), the
    IB group this rank's peers at the same place on the other hosts (its
    group rank the host ``d``): the ``c`` and ``r`` groups of
    :func:`~.mesh.make_grid_2d` ``((D, I))``, made once through
    ``collectives.mask_group`` and cached. :func:`refresh` makes them on
    every rank when the layout is set; a later call finds them in the
    cache."""
    from .mesh import initialized, make_grid_2d
    shp = world_shape()
    if shp is None or not initialized():
        return None
    g = make_grid_2d(shp)
    return g.r, g.c, shp[0], shp[1]


def peer_fabric(peer: int) -> Optional[str]:
    """The fabric between this rank and world rank ``peer``: ``None``
    unless the world is laid out hosts × ranks (as of the last
    :func:`refresh`), else ``"nvlink"`` when both are on one host and
    ``"ib"`` when they are not (the JAX package's per-pair split of the
    neighbour exchanges, ``parallel/collectives.py:310-336``)."""
    from .mesh import initialized, rank
    if _WORLD_SHAPE is None or not initialized():
        return None
    return "nvlink" if _slice_of(peer) == _slice_of(rank()) else "ib"


def world_key() -> str:
    """:func:`topology_key` of the world laid hosts × ranks-per-host:
    ``ib{D}xnvlink{I}`` for :func:`world_shape` ``(D, I)``, else empty."""
    shp = world_shape()
    return "" if shp is None else f"ib{shp[0]}xnvlink{shp[1]}"


def collective_fabric(mesh, axes: Union[str, Sequence[str], None]
                      ) -> Optional[str]:
    """The fabric a collective over ``axes`` of ``mesh`` is charged to:
    ``None`` on a grid that is not hybrid (only ``.bytes`` is counted),
    ``"ib"`` when any axis is IB (a mixed collective is charged to the
    slow fabric), else ``"nvlink"``."""
    if not is_hybrid(mesh):
        return None
    names, _ = _grid(mesh)
    if axes is None:
        axes = tuple(names)
    if isinstance(axes, str):
        axes = (axes,)
    fabs = {axis_fabric(mesh, a) for a in axes}
    return "ib" if "ib" in fabs else "nvlink"


def slice_map(mesh) -> Optional[Tuple[int, ...]]:
    """Host index of each rank of ``mesh`` in its order, or ``None`` when
    every rank is on one host (the planner's per-fabric split, JAX
    ``slice_map``)."""
    _, ranks = _grid(mesh)
    ids = tuple(_slice_of(r) for r in ranks.ravel())
    return ids if len(set(ids)) > 1 else None


def slice_run(mesh, axis: Union[str, int]) -> Optional[int]:
    """Length of the equal contiguous host blocks along one axis, or
    ``None`` when the axis is on one host or its hosts interleave."""
    names, ranks = _grid(mesh)
    ax = list(names).index(axis) if isinstance(axis, str) else int(axis)
    n = int(ranks.shape[ax])
    if n <= 1:
        return None
    fiber = np.moveaxis(ranks, ax, 0).reshape(n, -1)[:, 0]
    sl = [_slice_of(r) for r in fiber]
    runs, cur = [], 1
    for a, b in zip(sl, sl[1:]):
        if a == b:
            cur += 1
        else:
            runs.append(cur)
            cur = 1
    runs.append(cur)
    L = runs[0]
    if L <= 1 or len(runs) <= 1 or any(r != L for r in runs):
        return None
    return L


def perm_crossings(mesh, axes: Union[str, Sequence[str]],
                   perm: Sequence[Tuple[int, int]]) -> Tuple[int, int]:
    """``(n_nvlink, n_ib)``: how many ``(src, dst)`` pairs of an exchange
    over ``axes`` stay on a host and how many cross one; ranks are
    row-major over ``axes`` in the given order, each represented by its
    entry at index 0 of the other axes."""
    if isinstance(axes, str):
        axes = (axes,)
    names, ranks = _grid(mesh)
    order = [list(names).index(a) for a in axes]
    order += [i for i in range(ranks.ndim) if i not in order]
    ranks = np.transpose(ranks, order)
    k = len(axes)
    lead = int(np.prod(ranks.shape[:k], dtype=np.int64)) if k else 1
    reps = ranks.reshape(lead, -1)[:, 0]
    sl = [_slice_of(r) for r in reps]
    cross = sum(1 for s, d in perm if sl[int(s)] != sl[int(d)])
    return len(perm) - cross, cross


_GROUP_FABRIC: Dict[int, str] = {}


def group_fabric(group) -> Optional[str]:
    """The fabric a collective over ``group`` (``None``: the world) is
    charged to: ``None`` unless the world is laid hosts × ranks (its
    :func:`world_shape` as of the last :func:`refresh`), else ``"ib"``
    when the group's ranks span hosts and ``"nvlink"`` when they share
    one. Cached per group (``collectives.forget_groups`` clears it)."""
    from .mesh import initialized
    if _WORLD_SHAPE is None or not initialized():
        return None
    key = id(group)
    if key not in _GROUP_FABRIC:
        if group is None:
            from .mesh import world_size
            members = range(world_size())
        else:
            import torch.distributed as dist
            members = dist.get_process_group_ranks(group)
        hosts = {_slice_of(r) for r in members}
        _GROUP_FABRIC[key] = "ib" if len(hosts) > 1 else "nvlink"
    return _GROUP_FABRIC[key]


def forget() -> None:
    """Drop the per-group fabric cache (its groups ended)."""
    _GROUP_FABRIC.clear()
