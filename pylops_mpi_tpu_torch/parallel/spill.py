"""Host-RAM spill tier: moves staged through pinned host memory.

PyTorch counterpart of ``pylops_mpi_tpu/parallel/spill.py:71-407``. The
planner (``parallel/reshard.py``) refuses a move whose budget cannot
hold one row of a device plan; this tier turns that refusal into a
slower move that works, by staging each chunk through host RAM:

- a spilled plan's ``host_stage`` steps: each rank copies its pieces of
  a chunk from the card into pinned host buffers (D2H), exchanges them
  with its peers on the host (gloo carries host tensors), and copies
  each received piece into its destination, on the card (H2D) or in a
  host buffer when the destination itself is over budget;
- :func:`run_spilled`, the double-buffered executor. With
  ``overlap="on"`` (the default) the D2H copies of chunk ``k`` run on a
  side ``torch.cuda.Stream``, ordered after the work that made the
  source by a wait on the current stream and read back through a CUDA
  event, while chunk ``k-1`` is finished (exchanged and copied into
  place) on the host and the current stream: the two copy directions
  use separate copy engines. The host buffers are pinned (a
  ``non_blocking`` copy into pageable memory is silently synchronous,
  the first thing to check when ``on`` and ``off`` time the same); a
  buffer that cannot be pinned raises. On the CPU a one-slot worker
  thread finishes chunk ``k-1`` while the main thread carves chunk
  ``k``, as in the JAX package. ``overlap="off"`` finishes each chunk
  before the next; both give the same bytes;
- :class:`HostArray`, a distributed array's layout parked in host RAM.
  In the SPMD port each rank holds **its own shard** there (the JAX
  package's single controller holds the whole value); :meth:`HostArray.
  asarray` gathers them, and :meth:`HostArray.to_device` or
  :func:`~.reshard.reshard` moves them back.

Mode: ``PYLOPS_MPI_TPU_TORCH_SPILL`` (``utils/deps.spill_mode``):
``off`` keeps the refusal, ``auto`` (default) stages only the moves the
device planner refuses, ``on`` stages every move. The floor stays one
row: even the host path stages a row at a time. The bytes each rank
copies land in ``collective.reshard.bytes_h2d``/``.bytes_d2h`` (its own
share: summed over the ranks of a split source and destination they are
the plan's ``nbytes_d2h``/``nbytes_h2d``), and in each step's event.
Chunk counts and the overlap choice are op ``"spill"`` of the tuning
space. :func:`~..resilience.faults.maybe_kill_reshard` and
``maybe_kill_spill`` fire once per staged chunk.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from typing import Optional, Tuple

import numpy as np
import torch

from ..diagnostics import trace as _trace
from . import collectives as _coll
from . import reshard as _rs
from . import topology as _topo
from .partition import Partition, local_split

__all__ = ["HostArray", "run_spilled", "to_host", "reshard_from_host",
           "chunk_hint_spill", "overlap_hint_spill", "record_spill_plan",
           "pinned_empty"]


def pinned_empty(shape, dtype, device) -> torch.Tensor:
    """An empty host tensor for staging from ``device``: pinned when
    ``device`` is a card (raising when it cannot be pinned: a pageable
    buffer would make every copy synchronous), plain on the CPU."""
    if torch.device(device).type != "cuda":
        return torch.empty(tuple(shape), dtype=dtype)
    t = torch.empty(tuple(shape), dtype=dtype, pin_memory=True)
    if t.numel() and not t.is_pinned():
        raise RuntimeError(f"spill: a {tuple(shape)} {dtype} host buffer "
                           "could not be pinned")
    return t


class HostArray:
    """A distributed array's layout, parked in host RAM: this rank's
    shard (``local``, pinned when it came from a card) and the layout
    every rank shares (global shape, partition, axis, local shapes,
    mask, the mesh), plus the device it goes back to. A rank outside the
    mesh holds an empty tensor."""

    def __init__(self, local: torch.Tensor, global_shape,
                 partition: Partition = Partition.SCATTER, axis: int = 0,
                 local_shapes=None, mask=None, mesh=None, device=None):
        from .mesh import default_mesh
        self.local = local
        self._global_shape = tuple(int(s) for s in global_shape)
        self.mesh = default_mesh() if mesh is None else mesh
        self.partition = partition
        self.axis = int(axis)
        n = int(self.mesh.size)
        self.local_shapes = (local_split(self._global_shape, n, partition,
                                         self.axis)
                             if local_shapes is None else
                             tuple(tuple(int(v) for v in s)
                                   for s in local_shapes))
        self.mask = None if mask is None else tuple(mask)
        self.device = torch.device(device) if device is not None \
            else self.mesh.device

    @property
    def global_shape(self) -> Tuple[int, ...]:
        return self._global_shape

    @property
    def dtype(self) -> torch.dtype:
        return self.local.dtype

    @property
    def ndim(self) -> int:
        return len(self._global_shape)

    @property
    def n_shards(self) -> int:
        return len(self.local_shapes)

    @property
    def nbytes(self) -> int:
        """This rank's bytes in host RAM."""
        return self.local.numel() * self.local.element_size()

    def _axis_sizes(self):
        return [int(s[self.axis]) for s in self.local_shapes]

    def asarray(self) -> np.ndarray:
        """The global value on the host, gathered from the members
        (collective over the mesh; bf16/f16 come back as float32)."""
        if not self.mesh.member:
            raise RuntimeError("asarray: this rank holds no shard of the "
                               "HostArray's mesh")
        t = self.local
        if self.partition == Partition.SCATTER and self.mesh.size > 1:
            if self.mesh.backend == "nccl":
                t = t.to(self.mesh.device)
            t = _coll.all_gather(t, self._axis_sizes(), self.axis,
                                 self.mesh.group).cpu()
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.float()
        return t.numpy()

    def to_device(self, *, budget=_rs._UNSET, chunks: Optional[int] = None,
                  overlap: Optional[str] = None, spill: Optional[str] = None):
        """Stream this array back onto its device and mesh as a
        :class:`~..distributedarray.DistributedArray`, chunk by chunk
        under the budget (the unspill)."""
        return reshard_from_host(self, budget=budget, chunks=chunks,
                                 overlap=overlap, spill=spill,
                                 host_dst=False)

    def __repr__(self) -> str:
        return (f"HostArray(shape={self.global_shape}, dtype={self.dtype}, "
                f"partition={self.partition.name}, axis={self.axis}, "
                f"n_shards={self.n_shards})")


# -------------------------------------------------- tuned spill params
def _spill_cached_params(width: int, n_shards: int) -> Optional[dict]:
    """Op ``"spill"``'s banked params (``comm_chunks``, ``overlap``), or
    ``None`` with tuning off, nothing banked or stale params."""
    from ..tuning import cache as _tcache
    from ..tuning import plan as _tplan
    from ..tuning import space as _tspace
    if _tplan.tune_mode() == "off":
        return None
    try:
        key = _tplan.plan_key("spill", (int(width),), None, int(n_shards),
                              None)
        entry = _tcache.lookup(key)
    except Exception:
        return None
    if entry is None:
        return None
    sp = _tspace.space_for("spill")
    params = entry.get("params")
    if not (isinstance(params, dict) and sp is not None
            and sp.validate(params)):
        return None
    return dict(params)


def chunk_hint_spill(width: int, n_shards: int) -> Optional[int]:
    """The banked ``comm_chunks`` of a spilled plan (``None``: none)."""
    params = _spill_cached_params(width, n_shards)
    if not params:
        return None
    k = int(params.get("comm_chunks", 0))
    return k if k >= 1 else None


def overlap_hint_spill(width: int, n_shards: int) -> Optional[str]:
    """The banked overlap choice (``"on"``/``"off"``) of a spilled plan."""
    params = _spill_cached_params(width, n_shards)
    if not params:
        return None
    ov = params.get("overlap")
    return ov if ov in ("on", "off") else None


def record_spill_plan(width: int, n_shards: int, chunks: int,
                      overlap: str = "on", trials=None,
                      path: Optional[str] = None) -> str:
    """Bank a measured spill schedule under op ``"spill"``; returns the
    key."""
    from ..tuning import cache as _tcache
    from ..tuning import plan as _tplan
    key = _tplan.plan_key("spill", (int(width),), None, int(n_shards), None)
    _tcache.store(key, {"params": {"comm_chunks": int(chunks),
                                   "overlap": str(overlap)},
                        "provenance": "tuned",
                        "trials": list(trials or [])}, path=path)
    return key


def _resolve_overlap(overlap, width: int, n_shards: int) -> str:
    """The argument beats the banked hint beats ``"on"``."""
    if overlap is not None:
        s = str(overlap).strip().lower()
        if s in ("1", "true"):
            s = "on"
        if s in ("0", "false"):
            s = "off"
        if s not in ("on", "off"):
            raise ValueError(f"overlap={overlap!r}: expected 'on' or 'off'")
        return s
    hint = overlap_hint_spill(width, n_shards)
    return hint if hint is not None else "on"


# ------------------------------------------------------------ executor
def _is_cuda(t: Optional[torch.Tensor]) -> bool:
    return t is not None and t.is_cuda


def rank_staging(plan, src, dst) -> Tuple[int, int]:
    """``(h2d, d2h)``: the bytes this rank stages into host RAM from a
    distributed array's storage and back into one, in a spilled ``plan``
    (each distinct carved piece once). On the CPU the copies are
    host-to-host and counted all the same, as the JAX package counts its
    CPU devices'."""
    from .mesh import rank
    me = rank()
    g, item = plan.global_shape, plan.itemsize
    h2d = d2h = 0
    for st in plan.steps:
        seen = set()
        for sr, dr, reg in _rs._transfers(plan, src, dst, st.lo, st.hi):
            nb = _rs._nbytes_of(g, reg, item)
            key = tuple(sorted(reg.items()))
            if sr == me and not src.host and key not in seen:
                seen.add(key)
                d2h += nb
            if dr == me and not dst.host:
                h2d += nb
    return h2d, d2h


class _Chunk:
    """One staged chunk: its step, the host pieces to send, the pieces
    to place, and the event that marks its D2H copies done."""

    def __init__(self, st):
        self.st = st
        self.sends = []      # (host tensor, peer)
        self.recvs = []      # (region, peer)
        self.local = []      # (region, host tensor)
        self.moves = False   # some piece of the chunk changes rank
        self.event = None
        self.live = 0


def run_spilled(plan, src, dst, dtype: torch.dtype,
                overlap: Optional[str] = None) -> None:
    """Run an all-``host_stage`` plan from ``src`` into ``dst`` (the
    :class:`~.reshard._Side` s of the move; either may sit on the host),
    chunk by chunk through host RAM (module docstring)."""
    from ..resilience import faults as _faults
    from .mesh import rank
    me = rank()
    g = plan.global_shape
    rows = g[plan.move_axis] if g else 0
    ov = _resolve_overlap(overlap, rows,
                          max(plan.src.n_shards, plan.dst.n_shards))
    s_org = src.region(src.shard_of(me)) if src.local is not None else {}
    d_org = dst.region(dst.shard_of(me)) if dst.local is not None else {}
    s_cuda = _is_cuda(src.local)
    dev = src.local.device if s_cuda else (
        dst.local.device if _is_cuda(dst.local) else None)
    side = torch.cuda.Stream(device=dev) if (dev is not None
                                             and ov == "on") else None
    if side is not None:
        side.wait_stream(torch.cuda.current_stream(dev))
    name = plan.kind if plan.kind != "local" else "ppermute"

    def stage(st) -> _Chunk:
        """Carve this rank's pieces of chunk ``st`` into host RAM (D2H on
        the side stream when overlapping)."""
        ck = _Chunk(st)
        carved = {}
        pieces = _rs._transfers(plan, src, dst, st.lo, st.hi)
        ck.moves = any(sr != dr for sr, dr, _ in pieces)
        ctx = torch.cuda.stream(side) if side is not None else nullcontext()
        with ctx:
            for sr, dr, reg in pieces:
                if sr != me:
                    if dr == me:
                        ck.recvs.append((reg, sr))
                    continue
                view = _rs._view(src.local, reg, s_org)
                if dr == me and not _is_cuda(dst.local) and s_cuda:
                    out = _rs._view(dst.local, reg, d_org)
                    if out.is_contiguous() and out.is_pinned():
                        # the destination is pinned host memory: copy
                        # straight into it
                        out.copy_(view, non_blocking=True)
                        ck.live += out.numel() * out.element_size()
                        continue
                key = tuple(sorted(reg.items()))
                if key not in carved:
                    if s_cuda:
                        h = pinned_empty(view.shape, view.dtype, view.device)
                        h.copy_(view, non_blocking=True)
                    else:
                        h = view.contiguous()
                    carved[key] = h
                    ck.live += h.numel() * h.element_size()
                if dr == me:
                    ck.local.append((reg, carved[key]))
                else:
                    ck.sends.append((carved[key], dr))
            if s_cuda:
                ck.event = torch.cuda.Event()
                ck.event.record()
        return ck

    def finish(ck: _Chunk) -> None:
        """Wait for chunk ``ck``'s D2H copies, exchange its pieces on the
        host and copy each into its destination."""
        if ck.event is not None:
            ck.event.synchronize()
        bufs = []
        if ck.moves:
            bufs = _coll.exchange(
                name, ck.sends,
                [(_rs._shape(g, reg), sr) for reg, sr in ck.recvs], dtype)
        # from pinned buffers the H2D copies run on the current stream
        # beside the next chunk's D2H (the run ends in a device sync)
        for (reg, h) in ck.local + [(reg, b) for (reg, _), b in
                                     zip(ck.recvs, bufs)]:
            _rs._view(dst.local, reg, d_org).copy_(h, non_blocking=True)
        st = ck.st
        _trace.event("collective.reshard.step", kind="host_stage",
                     lo=st.lo, hi=st.hi, nbytes=st.nbytes,
                     nbytes_h2d=st.nbytes_h2d, nbytes_d2h=st.nbytes_d2h,
                     scratch_bytes=st.scratch_bytes, overlap=ov,
                     staged_bytes=ck.live + sum(
                         b.numel() * b.element_size() for b in bufs))

    pool = ThreadPoolExecutor(max_workers=1) \
        if (ov == "on" and dev is None) else None
    try:
        pending, fut = None, None
        for st in plan.steps:
            _faults.maybe_kill_reshard()
            _faults.maybe_kill_spill()
            ck = stage(st)
            if ov == "off":
                finish(ck)
                if dev is not None:
                    torch.cuda.synchronize(dev)
                continue
            if pool is not None:
                # one slot: chunk k-1 finishes on the worker while this
                # thread carves chunk k
                if fut is not None:
                    fut.result()
                fut = pool.submit(finish, ck)
                continue
            if pending is not None:
                finish(pending)
            pending = ck
        if pending is not None:
            finish(pending)
        if fut is not None:
            fut.result()
    finally:
        if pool is not None:
            pool.shutdown(wait=True)
    if dev is not None:
        torch.cuda.synchronize(dev)


# ------------------------------------------------------- entry points
def to_host(x, *, budget=_rs._UNSET, chunks: Optional[int] = None,
            overlap: Optional[str] = None) -> HostArray:
    """Move a :class:`~..distributedarray.DistributedArray` to host RAM,
    chunk by chunk under the budget, keeping its layout (the explicit
    spill; each rank stages its own shard). The inverse is
    :meth:`HostArray.to_device`."""
    _rs._coll._refuse_grad("to_host", x.array)  # host RAM keeps no graph
    lay = _rs._layout_of(x)
    mesh = x.mesh
    plan = _rs.plan_reshard(x.global_shape, x.array.element_size(), lay, lay,
                            budget=budget, chunks=chunks,
                            slice_ids=_topo.slice_map(mesh), spill="on",
                            dst_host=True,
                            topo_key=_topo.topology_key(mesh))
    out = pinned_empty(x.local_shape, x.dtype, x.device) if mesh.member \
        else torch.empty(0, dtype=x.dtype)
    if plan.steps:
        ranks = mesh.world_ranks()
        _rs._span_and_run(plan,
                          _rs._Side(lay, ranks,
                                    x.array if mesh.member else None),
                          _rs._Side(lay, ranks,
                                    out if mesh.member else None, host=True),
                          mesh, x.dtype, op="to_host", overlap=overlap)
    return HostArray(out, x.global_shape, x.partition, x.axis,
                     x.local_shapes, x.mask, mesh, x.device)


def reshard_from_host(h: HostArray, *, mesh=None, partition=None, axis=None,
                      local_shapes=None, budget=_rs._UNSET,
                      chunks: Optional[int] = None,
                      spill: Optional[str] = None,
                      overlap: Optional[str] = None,
                      host_dst: Optional[bool] = None):
    """Move a :class:`HostArray` to a layout on its device (or, with
    ``host_dst=True`` or a spilled destination over budget, to another
    :class:`HostArray`), chunk by chunk under the budget. A host result
    of the same layout and world aliases ``h``'s shard. Mask and
    short-axis refusals are :func:`~.reshard.reshard`'s."""
    from ..distributedarray import DistributedArray
    tgt_mesh = h.mesh if mesh is None else mesh
    tgt_part = h.partition if partition is None else partition
    tgt_axis = h.axis if axis is None else int(axis)
    n_new = int(tgt_mesh.size)
    if h.mask is not None and n_new != h.n_shards:
        raise _rs.ReshardError(
            f"reshard: array carries a mask (per-shard group colors) and "
            f"the move changes the shard count {h.n_shards} -> {n_new}; "
            "drop the mask or re-derive it for the new world first", 0)
    dst_l, ax_n, lsh = _rs._dst_layout(h.global_shape, n_new, tgt_part,
                                       tgt_axis, local_shapes)
    plan = _rs.plan_reshard(h.global_shape, h.local.element_size(),
                            _rs.Layout.replicated(1), dst_l,
                            budget=budget, chunks=chunks,
                            slice_ids=_topo.slice_map(tgt_mesh),
                            spill=spill, src_host=True, dst_host=host_dst,
                            topo_key=_topo.topology_key(tgt_mesh))
    same_world = h.mesh.world_ranks() == tgt_mesh.world_ranks()
    src_l = _rs.Layout.scatter(h._axis_sizes(), h.axis) \
        if h.partition == Partition.SCATTER else \
        _rs.Layout.replicated(h.n_shards, h.partition)
    src = _rs._Side(src_l, h.mesh.world_ranks(),
                    h.local if h.mesh.member else None, host=True)
    member = tgt_mesh.member
    if plan.spilled and plan.host_dst:
        if same_world and src_l == dst_l:
            return HostArray(h.local, h.global_shape, tgt_part, ax_n, lsh,
                             h.mask, tgt_mesh, h.device)
        out = pinned_empty(lsh[tgt_mesh.rank], h.dtype, h.device) \
            if member else torch.empty(0, dtype=h.dtype)
        _rs._span_and_run(plan, src,
                          _rs._Side(dst_l, tgt_mesh.world_ranks(),
                                    out if member else None, host=True),
                          tgt_mesh, h.dtype, overlap=overlap)
        return HostArray(out, h.global_shape, tgt_part, ax_n, lsh, h.mask,
                         tgt_mesh, h.device)
    out = DistributedArray(h.global_shape, tgt_part, tgt_axis,
                           local_shapes=local_shapes, mask=h.mask,
                           dtype=h.dtype, device=h.device, mesh=tgt_mesh)
    _rs._span_and_run(plan, src,
                      _rs._Side(dst_l, tgt_mesh.world_ranks(),
                                out.array if member else None),
                      tgt_mesh, h.dtype, overlap=overlap)
    return out
