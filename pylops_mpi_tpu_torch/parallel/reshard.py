"""Bounded-memory resharding: the planner and its SPMD executor.

PyTorch counterpart of ``pylops_mpi_tpu/parallel/reshard.py:78-848``
(arXiv 2112.01075: any layout change as a short program of collective
steps whose scratch is bounded by a chunk, not the array). A move of a
:class:`~..distributedarray.DistributedArray` between two
:class:`Layout` s (a ragged split to another, one split axis to another,
BROADCAST to SCATTER and back, one world to a smaller or larger one)
streams in chunks so that no rank's scratch passes
``PYLOPS_MPI_TPU_TORCH_RESHARD_BUDGET``.

**The planner** (:func:`plan_reshard`) is the JAX package's host math,
kept field for field: exact bytes between each pair of shards from the
interval overlaps (one split axis) or the product measure (an axis
change), the split of those bytes over the fabrics from
``topology.slice_map`` (``nbytes_nvlink``/``nbytes_ib``, JAX's
``nbytes_ici``/``nbytes_dcn``), and a chunk count that keeps
``peak_scratch <= budget``. A budget below ``min_budget`` (one row of
scratch for each live buffer) raises :class:`ReshardError` naming the
least budget that would do; under ``PYLOPS_MPI_TPU_TORCH_SPILL=auto`` it
stages the move through host RAM instead (``parallel/spill.py``).

**The executor is SPMD.** The JAX package carves each chunk from one
controller's view of the whole array. Here every rank holds only its
shard, and every rank of the world calls the move with the same
metadata, so each computes the same plan and the same routing:

- A chunk is a range ``[lo, hi)`` of the move axis (the destination's
  split axis, else the source's). Destination shard ``q`` needs the
  part of the chunk inside its own range of that axis (all of the chunk
  for a replicated destination). Source shard ``p`` holds its range of
  its split axis (everything for a replicated source). Their
  intersection is the piece ``p`` owes ``q`` in this chunk: ``p``'s rank
  carves it from its shard and sends it to ``q``'s rank; a rank that is
  both copies it in place. A replicated source serves each destination
  from the destination's own copy where it has one, else from source
  shard ``q mod P``.
- The sends and receives of one chunk go as one ``batch_isend_irecv``
  (:func:`~.collectives.exchange`; gloo's ``all_to_all`` refuses
  unequal sizes), counted as one call of the plan's collective family
  (``all_to_all`` for an axis change, ``ppermute`` for a regrid of one
  axis, ``all_gather`` to a replicated layout).
- **Scratch per rank.** In a chunk a rank holds its carved pieces (one
  contiguous copy of each distinct piece, at most its part of the chunk)
  and its receive buffers (at most its need of the chunk): at most two
  chunks' bytes, the plan's ``scratch_bytes`` of an exchange step, and
  both are freed before the next chunk. The executor records each
  chunk's live staging in its ``collective.reshard.step`` event
  (``scratch_bytes``, the plan's beside it as ``plan_scratch_bytes``).
- **A move to another world** names a :class:`~.mesh.Mesh` over a
  sub-group (:func:`~.mesh.sub_mesh`, whose ``dist.new_group`` every
  rank calls in the same order). Shard ``i`` of a layout lives on the
  mesh's ``i``-th rank. After the move each member holds its shard of
  the new layout (the balanced split over the members unless
  ``local_shapes`` says otherwise), and every other rank holds an
  empty tensor with the same metadata. The planner's pair bytes assume
  shard ``i`` stays on the ``i``-th rank of both worlds, which holds for
  sub-groups that list the world's first ranks, as a shrink does.

With no budget the plan is one chunk, and an axis change issues the one
``all_to_all`` :meth:`~..distributedarray.DistributedArray.redistribute`
always issued, with the same pieces and bytes. The whole move runs under
a ``collective.reshard`` span, counted in the metrics registry as
``collective.reshard.calls``/``.bytes`` (and the fabric split) but not
in ``collectives.counts``, whose entries are the chunks' own exchanges.
:func:`~..resilience.faults.maybe_kill_reshard` fires before every plan
step.

:func:`place_replica` places a value every rank holds on the host (a
banked solver carry, a checkpoint's global value) onto a mesh, chunk by
chunk, each member copying only its own rows: the survivor's side of the
in-place recovery.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..diagnostics import trace as _trace
from . import collectives as _coll
from . import topology as _topo
from .partition import Partition, local_split, shard_offsets

__all__ = ["Layout", "ReshardStep", "ReshardPlan", "ReshardError",
           "reshard_budget", "plan_reshard", "reshard", "place_replica",
           "RESHARD_BUDGET_ENV"]

RESHARD_BUDGET_ENV = "PYLOPS_MPI_TPU_TORCH_RESHARD_BUDGET"


class _Unset:
    """Sentinel for "the caller passed nothing" (``None`` means
    unbounded)."""

    def __repr__(self) -> str:
        return "<env>"


_UNSET = _Unset()


def reshard_budget() -> Optional[int]:
    """The scratch budget in bytes from ``PYLOPS_MPI_TPU_TORCH_RESHARD_
    BUDGET`` (an integer, or with a ``k``/``m``/``g`` binary suffix), or
    ``None`` (unbounded: one chunk) when unset or empty. A malformed
    value raises: a typo must not become "unbounded"."""
    raw = os.environ.get(RESHARD_BUDGET_ENV, "").strip().lower()
    if not raw:
        return None
    mult = 1
    if raw[-1] in "kmg":
        mult = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30}[raw[-1]]
        raw = raw[:-1]
    try:
        val = int(float(raw) * mult)
    except ValueError:
        raise ValueError(
            f"{RESHARD_BUDGET_ENV}={raw!r}: expected bytes as an integer "
            "with optional k/m/g suffix, e.g. '8m'") from None
    if val <= 0:
        raise ValueError(f"{RESHARD_BUDGET_ENV} must be positive, got {val}")
    return val


class ReshardError(ValueError):
    """The planner refuses a move: the budget cannot hold one row of
    scratch (or the move has no meaning: a mask across worlds, a split
    axis shorter than the new world). ``min_budget`` is the least budget
    (bytes) under which the same move would succeed."""

    def __init__(self, msg: str, min_budget: int):
        super().__init__(msg)
        self.min_budget = int(min_budget)


@dataclass(frozen=True)
class Layout:
    """One side of a move: the partition, its split axis, and the
    logical rows of each shard along that axis (empty for replicated
    partitions)."""
    partition: Partition
    axis: int = 0
    sizes: Tuple[int, ...] = ()
    n_shards: int = 1

    @classmethod
    def scatter(cls, sizes: Sequence[int], axis: int = 0) -> "Layout":
        sizes = tuple(int(s) for s in sizes)
        return cls(Partition.SCATTER, int(axis), sizes, len(sizes))

    @classmethod
    def replicated(cls, n_shards: int,
                   partition: Partition = Partition.BROADCAST) -> "Layout":
        return cls(partition, 0, (), int(n_shards))

    @property
    def is_scatter(self) -> bool:
        return self.partition == Partition.SCATTER


@dataclass(frozen=True)
class ReshardStep:
    """One planner step: ``kind`` is the collective family
    (``dynamic_slice`` carves move nothing between ranks; a spilled
    plan's ``host_stage`` steps move bytes over PCIe instead,
    ``nbytes_h2d``/``nbytes_d2h``), ``nbytes`` the exchanged payload and
    its split ``nbytes_nvlink``/``nbytes_ib`` (JAX ``nbytes_ici``/
    ``nbytes_dcn``), ``scratch_bytes`` the live temporary the step
    holds."""
    kind: str
    chunk: int
    lo: int
    hi: int
    nbytes: int = 0
    nbytes_nvlink: Optional[int] = None
    nbytes_ib: Optional[int] = None
    scratch_bytes: int = 0
    nbytes_h2d: int = 0
    nbytes_d2h: int = 0


@dataclass(frozen=True)
class ReshardPlan:
    """The host-side decomposition of one move (JAX ``ReshardPlan``).
    A **spilled** plan stages every chunk through host RAM: its steps
    are all ``host_stage``, its payload between devices is zero, and
    ``host_dst`` marks a destination kept in host RAM because it would
    not fit the budget (``dst_device_bytes`` is the per-shard footprint
    it would need)."""
    global_shape: Tuple[int, ...]
    itemsize: int
    src: Layout
    dst: Layout
    move_axis: int
    kind: str
    chunks: int
    steps: Tuple[ReshardStep, ...]
    nbytes: int
    nbytes_nvlink: Optional[int]
    nbytes_ib: Optional[int]
    peak_scratch: int
    min_budget: int
    budget: Optional[int]
    spilled: bool = False
    host_dst: bool = False
    nbytes_h2d: int = 0
    nbytes_d2h: int = 0
    dst_device_bytes: int = 0

    def cost_model(self) -> int:
        """Modeled peak device scratch in bytes: the largest step
        temporary (one staging chunk for a spilled plan)."""
        return max((s.scratch_bytes for s in self.steps), default=0)


def _ceil_sizes(dim: int, n: int) -> Tuple[int, ...]:
    """The ceil-sized split of a dimension (a short, maybe empty,
    tail)."""
    s = -(-dim // n) if n else 0
    return tuple(max(0, min(s, dim - i * s)) for i in range(n))


def _pair_bytes(total: int, src: Layout, dst: Layout,
                move_axis: int, global_shape: Tuple[int, ...],
                itemsize: int) -> np.ndarray:
    """``B[i, j]``: bytes source shard ``i`` delivers to destination
    shard ``j`` (the diagonal, data already in place, is zeroed by the
    caller)."""
    if not src.is_scatter:
        return np.zeros((max(src.n_shards, 1), max(dst.n_shards, 1)))
    held = np.asarray(src.sizes, dtype=np.float64)
    held *= (total / max(global_shape[src.axis], 1))
    if not dst.is_scatter:
        return np.repeat(held[:, None], max(dst.n_shards, 1), axis=1)
    if src.axis == dst.axis:
        so = np.asarray(shard_offsets(src.sizes), dtype=np.int64)
        do = np.asarray(shard_offsets(dst.sizes), dtype=np.int64)
        s_lo, s_hi = so, so + np.asarray(src.sizes, dtype=np.int64)
        d_lo, d_hi = do, do + np.asarray(dst.sizes, dtype=np.int64)
        ov = (np.minimum(s_hi[:, None], d_hi[None, :])
              - np.maximum(s_lo[:, None], d_lo[None, :]))
        row_bytes = total / max(global_shape[move_axis], 1)
        return np.maximum(ov, 0).astype(np.float64) * row_bytes
    r = np.asarray(src.sizes, dtype=np.float64) / max(global_shape[src.axis], 1)
    c = np.asarray(dst.sizes, dtype=np.float64) / max(global_shape[dst.axis], 1)
    return total * r[:, None] * c[None, :]


def plan_reshard(global_shape: Sequence[int], itemsize: int,
                 src: Layout, dst: Layout, *,
                 budget=_UNSET, chunks: Optional[int] = None,
                 slice_ids: Optional[Sequence[int]] = None,
                 spill: Optional[str] = None, src_host: bool = False,
                 dst_host: Optional[bool] = None,
                 topo_key: Optional[str] = None) -> ReshardPlan:
    """Plan one move (JAX ``plan_reshard``). ``budget`` defaults to
    :func:`reshard_budget` (``None``: unbounded); ``chunks`` forces at
    least that many chunks; ``slice_ids`` (a host index per rank, from
    ``topology.slice_map``) drives the per-fabric split. ``spill``
    (default ``PYLOPS_MPI_TPU_TORCH_SPILL``): ``auto`` stages through
    host RAM only a move the device planner would refuse, ``on`` every
    move, ``off`` refuses. ``src_host`` marks a source in host RAM (no
    device-to-host half), ``dst_host`` pins the destination there
    (``None``: there when it would not fit the budget), and ``topo_key``
    is named in a refusal. Raises :class:`ReshardError` when the budget
    cannot hold one row."""
    global_shape = tuple(int(s) for s in global_shape)
    itemsize = int(itemsize)
    if budget is _UNSET:
        budget = reshard_budget()
    if spill is None:
        from ..utils.deps import spill_mode
        spill = spill_mode()
    if spill not in ("auto", "on", "off"):
        raise ValueError(f"spill={spill!r}: expected one of "
                         "['auto', 'on', 'off']")
    total = int(np.prod(global_shape, dtype=np.int64)) * itemsize

    if dst.is_scatter:
        move_axis = dst.axis
    elif src.is_scatter:
        move_axis = src.axis
    else:
        move_axis = 0
    rows = global_shape[move_axis] if global_shape else 0

    if src.is_scatter and not dst.is_scatter:
        kind = "all_gather"
    elif src.is_scatter and dst.is_scatter:
        kind = "ppermute" if src.axis == dst.axis else "all_to_all"
    else:
        kind = "local"

    if total == 0 or rows == 0:
        return ReshardPlan(global_shape, itemsize, src, dst, move_axis,
                           kind, 1, (), 0, None, None, 0, 0, budget)

    B = _pair_bytes(total, src, dst, move_axis, global_shape, itemsize)
    np.fill_diagonal(B, 0.0)
    comm = int(round(B.sum()))
    if comm == 0:
        kind = "local"

    nb_nv = nb_ib = None
    if slice_ids is not None and comm:
        sm = [int(s) for s in slice_ids]

        def _sid(r):
            return sm[min(r, len(sm) - 1)]
        cross = np.asarray([[_sid(i) != _sid(j) for j in range(B.shape[1])]
                            for i in range(B.shape[0])])
        nb_ib = int(round(B[cross].sum()))
        nb_nv = comm - nb_ib

    row_bytes = max(1, total // rows)
    factor = 1 if comm == 0 else 2   # the carved piece and its copy
    min_budget = factor * row_bytes
    topo_note = f" (topology {topo_key})" if topo_key else ""
    spilled = spill == "on"
    c_budget = 1
    if budget is not None and not spilled:
        w_max = int(budget) // (factor * row_bytes)
        if w_max < 1:
            if spill == "auto":
                spilled = True
            else:
                raise ReshardError(
                    f"reshard: budget {int(budget)} B cannot fit one "
                    f"{row_bytes}-byte row of axis {move_axis} "
                    f"({'x'.join(map(str, global_shape))}, {kind} move needs "
                    f"{factor} live buffers); the minimum budget that would "
                    f"succeed is {min_budget} B — raise "
                    f"{RESHARD_BUDGET_ENV} to at least {min_budget}"
                    f"{topo_note}",
                    min_budget)
        else:
            c_budget = -(-rows // w_max)
    if spilled:
        return _plan_spilled(global_shape, itemsize, src, dst, move_axis,
                             kind, rows, row_bytes, budget, chunks,
                             src_host, dst_host, topo_note)

    hint = _chunk_hint(rows, max(src.n_shards, dst.n_shards))
    n_chunks = min(rows, max(c_budget, int(chunks or 1), int(hint or 1)))
    width = -(-rows // n_chunks)
    n_chunks = -(-rows // width)

    steps = []
    peak = 0
    comm_left = comm
    nv_left = nb_nv or 0
    ib_left = nb_ib or 0
    for c in range(n_chunks):
        lo = c * width
        hi = min(rows, lo + width)
        cb = (hi - lo) * row_bytes
        steps.append(ReshardStep("dynamic_slice", c, lo, hi,
                                 scratch_bytes=cb))
        peak = max(peak, cb)
        if comm:
            last = c == n_chunks - 1
            share = comm_left if last else int(comm * (hi - lo) / rows)
            sn = nv_left if last else (
                int(nb_nv * (hi - lo) / rows) if nb_nv is not None else None)
            si = ib_left if last else (
                int(nb_ib * (hi - lo) / rows) if nb_ib is not None else None)
            comm_left -= share
            if nb_nv is not None:
                nv_left -= sn
                ib_left -= si
            steps.append(ReshardStep(
                kind, c, lo, hi, nbytes=share,
                nbytes_nvlink=sn if nb_nv is not None else None,
                nbytes_ib=si if nb_nv is not None else None,
                scratch_bytes=2 * cb))
            peak = max(peak, 2 * cb)

    return ReshardPlan(global_shape, itemsize, src, dst, move_axis, kind,
                       n_chunks, tuple(steps), comm, nb_nv, nb_ib,
                       peak, min_budget, budget)


def _plan_spilled(global_shape, itemsize, src: Layout, dst: Layout,
                  move_axis: int, kind: str, rows: int, row_bytes: int,
                  budget, chunks, src_host: bool,
                  dst_host: Optional[bool], topo_note: str) -> ReshardPlan:
    """An all-``host_stage`` plan: each chunk staged through host RAM,
    one device buffer live, so the floor is one row (JAX
    ``_plan_spilled``)."""
    if budget is not None and int(budget) < row_bytes:
        raise ReshardError(
            f"reshard: budget {int(budget)} B cannot fit one "
            f"{row_bytes}-byte row of axis {move_axis} "
            f"({'x'.join(map(str, global_shape))}, host-staged {kind} "
            f"move needs 1 live staging buffer); the minimum budget "
            f"that would succeed is {row_bytes} B — raise "
            f"{RESHARD_BUDGET_ENV} to at least {row_bytes}{topo_note}",
            row_bytes)
    w_max = rows if budget is None else max(1, int(budget) // row_bytes)
    c_budget = -(-rows // w_max)
    hint = _chunk_hint_spilled(rows, max(src.n_shards, dst.n_shards))
    n_chunks = min(rows, max(c_budget, int(chunks or 1), int(hint or 1)))
    width = -(-rows // n_chunks)
    n_chunks = -(-rows // width)
    if dst.is_scatter and dst.sizes:
        dst_rows = max(dst.sizes)
    else:
        dst_rows = rows
    dst_device_bytes = dst_rows * row_bytes
    if dst_host is None:
        host_dst = budget is not None and dst_device_bytes > int(budget)
    else:
        host_dst = bool(dst_host)
    steps = []
    peak = h2d = d2h = 0
    for c in range(n_chunks):
        lo = c * width
        hi = min(rows, lo + width)
        cb = (hi - lo) * row_bytes
        s_d2h = 0 if src_host else cb
        s_h2d = 0 if host_dst else cb
        scratch = cb if (s_d2h or s_h2d) else 0
        steps.append(ReshardStep("host_stage", c, lo, hi,
                                 scratch_bytes=scratch,
                                 nbytes_h2d=s_h2d, nbytes_d2h=s_d2h))
        peak = max(peak, scratch)
        h2d += s_h2d
        d2h += s_d2h
    return ReshardPlan(global_shape, itemsize, src, dst, move_axis, kind,
                       n_chunks, tuple(steps), 0, None, None, peak,
                       row_bytes, budget, spilled=True, host_dst=host_dst,
                       nbytes_h2d=h2d, nbytes_d2h=d2h,
                       dst_device_bytes=dst_device_bytes)


def _chunk_hint_spilled(width: int, n_shards: int) -> Optional[int]:
    """A spilled plan's banked chunk count: the larger of op
    ``"reshard"``'s and op ``"spill"``'s hints."""
    from . import spill as _spill
    vals = [int(h) for h in (_chunk_hint(width, n_shards),
                             _spill.chunk_hint_spill(width, n_shards)) if h]
    return max(vals) if vals else None


def _chunk_hint(width: int, n_shards: int) -> Optional[int]:
    """Op ``"reshard"``'s banked chunk count (``None`` with tuning off
    or no plan banked, so the default stays the plan above)."""
    from ..tuning import plan as _tplan
    try:
        return _tplan.chunk_hint("reshard", width, n_shards, op="reshard")
    except Exception:
        return None


# ------------------------------------------------------------- executor
@dataclass(frozen=True)
class _Side:
    """One side of a move as the executor sees it: the layout, the world
    rank of each shard, this rank's local tensor (``None`` when it holds
    no shard), and whether the side is a host array (a
    :class:`~.spill.HostArray`, or a value every rank holds) rather than
    a distributed array's storage."""
    layout: Layout
    ranks: Tuple[int, ...]
    local: Optional[torch.Tensor]
    host: bool = False

    def shard_of(self, r: int) -> int:
        return self.ranks.index(r) if r in self.ranks else -1

    def region(self, i: int) -> Dict[int, Tuple[int, int]]:
        """The global range shard ``i`` holds on its split axis (nothing
        for a replicated layout)."""
        lay = self.layout
        if not lay.is_scatter:
            return {}
        off = shard_offsets(lay.sizes)[i]
        return {lay.axis: (off, off + lay.sizes[i])}


def _intersect(a: Dict, b: Dict) -> Optional[Dict]:
    out = dict(a)
    for ax, (lo, hi) in b.items():
        if ax in out:
            lo, hi = max(lo, out[ax][0]), min(hi, out[ax][1])
        if hi <= lo:
            return None
        out[ax] = (lo, hi)
    return out


def _view(t: torch.Tensor, reg: Dict, origin: Dict) -> torch.Tensor:
    """The part ``reg`` (global ranges by axis) of a local tensor whose
    first element sits at ``origin`` (global offsets by axis)."""
    for ax, (lo, hi) in reg.items():
        t = t.narrow(ax, lo - origin.get(ax, (0, 0))[0], hi - lo)
    return t


def _shape(global_shape, reg: Dict) -> Tuple[int, ...]:
    shp = list(global_shape)
    for ax, (lo, hi) in reg.items():
        shp[ax] = hi - lo
    return tuple(shp)


def _transfers(plan: ReshardPlan, src: _Side, dst: _Side, lo: int,
               hi: int) -> List[Tuple[int, int, Dict]]:
    """``(src_rank, dst_rank, region)`` of every piece of chunk
    ``[lo, hi)`` (module docstring), the same list on every rank."""
    move = plan.move_axis
    chunk = {move: (lo, hi)}
    out = []
    n_src = len(src.ranks)
    for q, dr in enumerate(dst.ranks):
        need = _intersect(dst.region(q), chunk)
        if need is None:
            continue
        if src.layout.is_scatter:
            feeds = range(n_src)
        else:
            p = src.shard_of(dr)
            feeds = (p if p >= 0 else q % n_src,)
        for p in feeds:
            reg = _intersect(need, src.region(p))
            if reg is not None:
                out.append((src.ranks[p], dr, reg))
    return out


def _nbytes_of(global_shape, reg, itemsize) -> int:
    return int(np.prod(_shape(global_shape, reg), dtype=np.int64)) * itemsize


def _run_plan(plan: ReshardPlan, src: _Side, dst: _Side,
              dtype: torch.dtype) -> None:
    """Run a device plan into ``dst.local`` (this rank's output shard,
    allocated by the caller), chunk by chunk; ``dtype`` is the move's
    (every rank's buffers agree on it, members or not)."""
    from ..resilience import faults as _faults
    from .mesh import rank
    me = rank()
    g = plan.global_shape
    s_org = src.region(src.shard_of(me)) if src.local is not None else {}
    d_org = dst.region(dst.shard_of(me)) if dst.local is not None else {}
    name = plan.kind if plan.kind != "local" else "ppermute"
    per_chunk = 2 if plan.nbytes > 0 else 1
    for c in range(len(plan.steps) // per_chunk):  # none for an empty array
        st = plan.steps[c * per_chunk]
        _faults.maybe_kill_reshard()
        pieces = _transfers(plan, src, dst, st.lo, st.hi)
        carved: Dict[tuple, torch.Tensor] = {}
        sends, recvs = [], []
        for sr, dr, reg in pieces:
            if sr == me and dr == me:
                _view(dst.local, reg, d_org).copy_(
                    _view(src.local, reg, s_org))
            elif sr == me:
                key = tuple(sorted(reg.items()))
                if key not in carved:
                    carved[key] = _view(src.local, reg, s_org).contiguous()
                sends.append((carved[key], dr))
            elif dr == me:
                recvs.append((reg, sr))
        live = sum(t.numel() * t.element_size() for t in carved.values())
        _trace.event("collective.reshard.step", kind="dynamic_slice",
                     lo=st.lo, hi=st.hi, nbytes=0, scratch_bytes=live,
                     plan_scratch_bytes=st.scratch_bytes)
        # a replicated source on a smaller world still sends to the new
        # ranks, though its plan (every device holding it) moves nothing
        if per_chunk == 2 or any(sr != dr for sr, dr, _ in pieces):
            xst = plan.steps[c * per_chunk + 1] if per_chunk == 2 else st
            if per_chunk == 2:
                _faults.maybe_kill_reshard()
            bufs = _coll.exchange(
                name, sends, [(_shape(g, reg), sr) for reg, sr in recvs],
                dtype)
            live += sum(b.numel() * b.element_size() for b in bufs)
            for (reg, _), b in zip(recvs, bufs):
                _view(dst.local, reg, d_org).copy_(b)
            _trace.event("collective.reshard.step", kind=xst.kind, lo=st.lo,
                         hi=st.hi, nbytes=xst.nbytes, scratch_bytes=live,
                         plan_scratch_bytes=xst.scratch_bytes)
            del bufs
        del carved, sends


def _layout_of(x) -> Layout:
    if x.partition == Partition.SCATTER:
        return Layout.scatter(x._axis_sizes(), x.axis)
    return Layout.replicated(x.n_shards, x.partition)


def _dst_layout(global_shape, n_shards: int, partition: Partition,
                axis: int, local_shapes):
    """The destination :class:`Layout` and its normalized ``(axis,
    local_shapes)``, validated as the constructor validates them,
    without allocating the destination."""
    axis = int(axis)
    if axis < 0:
        axis += len(global_shape)
    if partition == Partition.SCATTER and not (0 <= axis < len(global_shape)):
        raise IndexError(f"axis {axis} out of range for shape {global_shape}")
    if local_shapes is None:
        lsh = local_split(global_shape, n_shards, partition, axis)
    else:
        lsh = tuple(tuple(int(v) for v in np.atleast_1d(s))
                    for s in local_shapes)
        if len(lsh) != n_shards:
            raise ValueError(f"need {n_shards} local shapes, got {len(lsh)}")
        if partition == Partition.SCATTER:
            tot = sum(s[axis] for s in lsh)
            if tot != global_shape[axis]:
                raise ValueError(
                    f"local shapes sum to {tot} != global dim "
                    f"{global_shape[axis]}")
    if partition == Partition.SCATTER:
        return Layout.scatter(tuple(s[axis] for s in lsh), axis), axis, lsh
    return Layout.replicated(n_shards, partition), axis, lsh


def _span_tags(plan: ReshardPlan, op: str) -> dict:
    return dict(cat="collective", op=op, kind=plan.kind, chunks=plan.chunks,
                shape=plan.global_shape, peak_scratch=plan.peak_scratch)


def _span_and_run(plan: ReshardPlan, src: _Side, dst: _Side, mesh,
                  dtype: torch.dtype, *, op: str = "reshard",
                  overlap=None) -> None:
    """Count the move in the metrics registry and run it under the
    ``collective.reshard`` span: spilled plans through
    :func:`~.spill.run_spilled`, device plans here."""
    tags = _span_tags(plan, op)
    if plan.spilled:
        from . import spill as _spill
        h2d, d2h = _spill.rank_staging(plan, src, dst)
        seq = _coll.count_metrics(
            "reshard", [(b, f) for b, f in ((h2d, "h2d"), (d2h, "d2h")) if b])
        tags.update(spilled=True, h2d_bytes=h2d, d2h_bytes=d2h,
                    host_dst=plan.host_dst)
        with _trace.span("collective.reshard", seq=seq, **tags):
            _spill.run_spilled(plan, src, dst, dtype, overlap=overlap)
        return
    if plan.nbytes_nvlink is not None:
        seq = _coll.count_metrics(
            "reshard", [(b, f) for b, f in ((plan.nbytes_nvlink, "nvlink"),
                                            (plan.nbytes_ib, "ib")) if b])
        tags.update(nvlink_bytes=plan.nbytes_nvlink, ib_bytes=plan.nbytes_ib)
    else:
        seq = _coll.count_metrics(
            "reshard", [(plan.nbytes, _topo.collective_fabric(mesh, None))])
        tags.update(nbytes=plan.nbytes)
    with _trace.span("collective.reshard", seq=seq, **tags):
        _run_plan(plan, src, dst, dtype)


def _world_mesh(mesh):
    from .mesh import default_mesh
    return default_mesh() if mesh is None else mesh


def reshard(x, *, mesh=None, partition: Optional[Partition] = None,
            axis: Optional[int] = None, local_shapes=None, budget=_UNSET,
            chunks: Optional[int] = None, spill: Optional[str] = None,
            overlap: Optional[str] = None, host_dst: Optional[bool] = None):
    """Move a :class:`~..distributedarray.DistributedArray` (or a
    :class:`~.spill.HostArray`) to a new layout: partition, split axis,
    ragged split, and/or another world (``mesh``, a
    :class:`~.mesh.Mesh` of :func:`~.mesh.sub_mesh` or the world's),
    with each rank's scratch bounded by the budget (module docstring).
    Every rank of the world calls it. A mask survives only a move that
    keeps the shard count; a SCATTER target whose axis is shorter than
    the new world refuses on another world (on the same one, as in the
    JAX package, some shards hold zero rows). ``spill``/``overlap``/
    ``host_dst`` reach the host-staging tier: a destination that does
    not fit the budget comes back as a :class:`~.spill.HostArray`."""
    from ..distributedarray import DistributedArray
    from . import spill as _spill
    if isinstance(x, _spill.HostArray):
        return _spill.reshard_from_host(
            x, mesh=mesh, partition=partition, axis=axis,
            local_shapes=local_shapes, budget=budget, chunks=chunks,
            spill=spill, overlap=overlap, host_dst=host_dst)
    src_mesh = x.mesh
    tgt_mesh = src_mesh if mesh is None else mesh
    tgt_part = partition if partition is not None else x.partition
    tgt_axis = x.axis if axis is None else int(axis)
    n_new = int(tgt_mesh.size)
    same = src_mesh.world_ranks() == tgt_mesh.world_ranks()
    if (tgt_part == Partition.SCATTER and local_shapes is None
            and x.global_shape[tgt_axis] < n_new and not same):
        raise ReshardError(
            f"reshard: SCATTER axis {tgt_axis} has "
            f"{x.global_shape[tgt_axis]} rows < {n_new} shards — the "
            "balanced split would leave at least one shard with zero "
            "rows; choose a different partition axis", 0)
    if x.mask is not None and n_new != x.n_shards:
        raise ReshardError(
            f"reshard: array carries a mask (per-shard group colors) and "
            f"the move changes the shard count {x.n_shards} -> {n_new}; "
            "drop the mask or re-derive it for the new world first", 0)
    dst_l, ax_n, lsh = _dst_layout(x.global_shape, n_new, tgt_part,
                                   tgt_axis, local_shapes)
    if (same and tgt_part == x.partition
            and (tgt_part != Partition.SCATTER
                 or (ax_n == x.axis and dst_l.sizes == tuple(
                     x._axis_sizes())))):
        return x.copy()
    if _coll.initialized():
        # received pieces arrive detached: raise rather than cut the
        # gradient (a world of one copies its own rows, which keep it)
        _coll._refuse_grad("reshard", x.array)
    itemsize = x.array.element_size()
    plan = plan_reshard(x.global_shape, itemsize, _layout_of(x), dst_l,
                        budget=budget, chunks=chunks,
                        slice_ids=_topo.slice_map(tgt_mesh), spill=spill,
                        dst_host=host_dst,
                        topo_key=_topo.topology_key(tgt_mesh))
    src = _Side(_layout_of(x), src_mesh.world_ranks(),
                x.array if src_mesh.member else None)
    me_dst = tgt_mesh.member
    if plan.spilled and plan.host_dst:
        out = (_spill.pinned_empty(lsh[tgt_mesh.rank], x.dtype, x.device)
               if me_dst else None)
        _span_and_run(plan, src,
                      _Side(dst_l, tgt_mesh.world_ranks(), out, host=True),
                      tgt_mesh, x.dtype, overlap=overlap)
        return _spill.HostArray(
            out if out is not None else torch.empty(0, dtype=x.dtype),
            x.global_shape, tgt_part, ax_n, lsh, x.mask, tgt_mesh, x.device)
    out = DistributedArray(x.global_shape, tgt_part, tgt_axis,
                           local_shapes=local_shapes, mask=x.mask,
                           dtype=x.dtype, device=x.device, mesh=tgt_mesh)
    _span_and_run(plan, src,
                  _Side(dst_l, tgt_mesh.world_ranks(),
                        out.array if me_dst else None),
                  tgt_mesh, x.dtype, overlap=overlap)
    return out


def place_replica(value, mesh=None, partition: Partition = Partition.SCATTER,
                  axis: int = 0, local_shapes=None, mask=None,
                  budget=_UNSET, chunks: Optional[int] = None, dtype=None,
                  spill: Optional[str] = None, overlap: Optional[str] = None,
                  device=None):
    """Place a value every rank holds on the host (a numpy array or a
    CPU tensor: a banked solver carry, a checkpoint's global value) onto
    ``mesh`` (default: the world) as a new
    :class:`~..distributedarray.DistributedArray` on ``device`` (default:
    the mesh's), chunk by chunk so that device scratch stays under the
    budget; each member copies its own rows, nothing moves between
    ranks. The survivor's primitive of the in-place recovery: no
    checkpoint read."""
    from ..distributedarray import DistributedArray
    from ..ops._precision import as_torch_dtype
    # the value is staged on the host, detached: raise rather than cut
    _coll._refuse_grad("place_replica", value)
    if isinstance(value, torch.Tensor):
        host = value.detach().cpu()
    else:
        host = torch.from_numpy(np.ascontiguousarray(np.asarray(value)))
    mesh = _world_mesh(mesh)
    dev = mesh.device if device is None else torch.device(device)
    dt = as_torch_dtype(dtype) if dtype is not None else host.dtype
    out = DistributedArray(tuple(host.shape), partition, axis,
                           local_shapes=local_shapes, mask=mask, dtype=dt,
                           device=dev, mesh=mesh)
    plan = plan_reshard(tuple(host.shape), out.array.element_size(),
                        Layout.replicated(1), _layout_of(out),
                        budget=budget, chunks=chunks,
                        slice_ids=_topo.slice_map(mesh), spill=spill,
                        src_host=True, dst_host=False,
                        topo_key=_topo.topology_key(mesh))
    # every rank holds the replica: the source's shard i is rank i's copy
    src = _Side(Layout.replicated(mesh.size), mesh.world_ranks(),
                host if mesh.member else None, host=True)
    dst = _Side(_layout_of(out), mesh.world_ranks(),
                out.array if mesh.member else None)
    if plan.steps:
        _span_and_run(plan, src, dst, mesh, dt, op="place_replica",
                      overlap=overlap)
    return out
