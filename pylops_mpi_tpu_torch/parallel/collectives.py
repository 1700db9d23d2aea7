"""Collectives over the process group.

PyTorch counterpart of the parts of ``pylops_mpi_tpu/parallel/collectives.py``
the sharded arrays and operators use: reductions of solver scalars
(:func:`all_reduce`), gathers of ragged shards (:func:`all_gather`),
the reduce-scatter of partial products (:func:`reduce_scatter`), the
all-to-all of a change of sharded axis or of a pencil transpose
(:func:`all_to_all`), the
neighbour exchange of stencil ghost rows (:func:`halo_exchange`, the
counterpart of ``halo_slab``) and its Cartesian form, one grid axis at a
time (:func:`cart_halo_extend`, the counterpart of ``cart_halo_extend``'s
plain path), the pipelined layer of the overlap schedules
(:func:`ring_pass`, :func:`ring_reduce_scatter`, :func:`ring_halo_ghosts`,
:func:`post_cart_halo`, :func:`resolve_chunks`,
:func:`chunked_pencil_transpose`: transfers posted before the compute
that does not need them, waited on where their data is read; their
steps, ring hops and pencil chunks, land in :data:`steps`), and the
two-level layer of a world laid out hosts × ranks (``ring_pass``'s
``slice_size``, :func:`hier_reduce_scatter`, :func:`hier_all_gather`,
:func:`hier_pencil_transpose` and :func:`chunked_pencil_transpose`'s
``two_level``: one phase over the ranks of a host, one across hosts).

Every function is called at every world size, one included: under a
group of one rank on the card the reductions still go through NCCL.
``group`` is ``None`` for the whole world or a sub-group (a mask's
color group, a row or column of a 2-D grid of ranks); pieces and sizes
are then listed in the group's rank order.
Without a process group they return at once and communicate nothing.
Each call under a group goes through :func:`_count` (the counterpart of
the JAX package's ``_count_collective``): it adds one to ``counts[name]``
and the bytes this rank receives to ``received[name]`` (padding
included), which tests and ``chip_smoke.py`` read, and the same call and
bytes to the metrics registry as ``collective.<name>.calls`` and
``collective.<name>.bytes``. On a world that spans hosts with several
ranks a host (``parallel/topology.py``), the same bytes also land in
``collective.<name>.bytes_nvlink`` when the call's group stays on one
host and ``.bytes_ib`` when it crosses hosts (the world group does); the
neighbour exchanges (:func:`halo_exchange`, :func:`ring_halo_ghosts`,
:func:`cart_halo_extend` and their adjoints) charge each received piece
to the fabric between this rank and its sender, and a two-level call
each phase to its own; a flat world adds no counter.

gloo moves CPU tensors only for point-to-point sends and gathers. Under
a gloo group, CUDA tensors are staged through host copies: this is
transport, the arithmetic around it stays on the tensors' device.

**Gradients.** Under grad mode, a tensor that requires grad goes through
an ``autograd.Function`` whose backward is the adjoint collective, with
the typing of the JAX package's collectives under ``jax.grad``:

- :func:`all_reduce` ``"sum"`` reduces per-rank partials into one value
  that every rank holds (``psum``, whose output is replicated): the
  value's cotangent is the same on every rank, and each rank's partial
  receives it unchanged, so a replicated loss gives the one-rank
  gradient. ``"max"``/``"min"`` raise, as ``jax.grad`` has no rule for
  ``pmax``/``pmin``.
- :func:`all_gather` and :func:`reduce_scatter` are each other's
  adjoints (``all_gather``'s output is per-rank: each rank goes on with
  its own use of the whole, as ``_global()`` callers keep their shard).
- :func:`all_to_all`'s backward is an ``all_to_all`` of the cotangent
  pieces with the send and receive shapes swapped (counted as
  ``all_to_all_adjoint``); this rank's own piece passes through.
- :func:`exchange`'s backward sends each received buffer's cotangent
  back to its sender and receives the cotangents of what this rank sent
  (counted as ``<name>_adjoint``).
- :func:`halo_exchange` and :func:`cart_halo_extend` send each received
  ghost's cotangent back to its owner, which adds it to the edge slices
  it sent (``halo_exchange_adjoint``, ``cart_halo_extend_adjoint``). On
  a 2-D grid the Cartesian calls run one axis at a time, so a corner's
  cotangent travels back through both.
- A posted hop of :func:`ring_pass` or :func:`ring_reduce_scatter` is
  waited on through an ``autograd.Function`` whose backward is the hop
  reversed (``<name>_adjoint``); :func:`ring_halo_ghosts` and
  :func:`post_cart_halo` have :func:`halo_exchange`'s rule.
- :func:`replicated` marks a tensor every rank holds the same (a scaled
  operator's factor) where it enters each rank's own part of a
  computation: its cotangent is the sum of the ranks' parts.

Every backward is collective: every rank runs it, which a loss that
depends on every rank's outputs (a sum reduced with :func:`all_reduce`)
ensures. :func:`broadcast` has no rule: the JAX package has no broadcast
collective. Given a tensor that requires grad under grad mode it raises
``NotImplementedError`` rather than cut the gradient.
"""

from __future__ import annotations

import logging
from collections import Counter
from contextlib import nullcontext
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..diagnostics import metrics as _metrics
from ..diagnostics import trace as _trace
from . import topology as _topo
from .mesh import initialized, rank, world_size
from .partition import Partition, local_split, padded_shard_size

_logger = logging.getLogger(__name__)

__all__ = ["counts", "received", "steps", "reset_counts", "mask_group",
           "rank_group", "forget_groups", "all_reduce", "all_gather",
           "reduce_scatter", "all_to_all", "exchange", "count_metrics",
           "halo_exchange", "cart_halo_extend", "broadcast", "replicated",
           "reduce_stall", "stall_signature", "ring_pass",
           "ring_reduce_scatter", "ring_halo_ghosts", "ring_halo_extend",
           "post_cart_halo", "resolve_chunks", "chunked_pencil_transpose",
           "hier_reduce_scatter", "hier_all_gather", "hier_pencil_transpose"]

# collective calls under a group, and the bytes this rank received in
# them, since the last reset_counts()
counts: Counter = Counter()
received: Counter = Counter()
# the pipelined collectives' steps since the last reset_counts(): the
# hops of ring_pass and ring_reduce_scatter (and of their backwards, as
# "<name>_adjoint"), the chunks of chunked_pencil_transpose
steps: Counter = Counter()

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}

# mask (tuple of colors, one per rank) -> this rank's sub-group
_GROUPS: Dict[tuple, object] = {}


# per-name sequence numbers of the calls, for the event tags
_SEQ: Counter = Counter()


def reset_counts() -> None:
    counts.clear()
    received.clear()
    steps.clear()


def _count(name: str, nbytes: int, group=None) -> int:
    """One call of collective ``name`` over ``group`` receiving ``nbytes``
    on this rank: ``counts``/``received`` and the metrics registry (with
    the fabric split, module docstring); returns the call's sequence
    number."""
    return _count_shares(name, [(nbytes, _topo.group_fabric(group))])


def _count_shares(name: str,
                  shares: Sequence[Tuple[int, Optional[str]]]) -> int:
    """One call of collective ``name`` whose bytes arrived over several
    fabrics, ``(nbytes, fabric)`` each: ``counts``/``received`` take the
    call and the sum, :func:`count_metrics` each share."""
    counts[name] += 1
    received[name] += sum(int(nb) for nb, _ in shares)
    return count_metrics(name, shares)


def _peer_shares(nbytes_by_peer: Sequence[Tuple[int, int]]
                 ) -> List[Tuple[int, Optional[str]]]:
    """The shares of bytes received from world ranks, ``(nbytes, peer)``
    each, by the fabric between this rank and the peer
    (:func:`~.topology.peer_fabric`): ``[(total, None)]`` on a world
    that is not laid out hosts × ranks."""
    total = sum(int(nb) for nb, _ in nbytes_by_peer)
    by: Dict[str, int] = {}
    for nb, peer in nbytes_by_peer:
        fab = _topo.peer_fabric(peer)
        if fab is None:
            return [(total, None)]
        by[fab] = by.get(fab, 0) + int(nb)
    return [(nb, fab) for fab, nb in sorted(by.items(), reverse=True)] \
        or [(0, None)]


def count_metrics(name: str,
                  shares: Sequence[Tuple[int, Optional[str]]]) -> int:
    """The metrics half of :func:`_count` (JAX ``_count_collective``,
    ``collectives.py:160-185``), without ``counts``/``received``: one
    ``collective.<name>.calls``, and each ``(nbytes, fabric)`` share
    through :func:`~..diagnostics.metrics.collective_bytes` (a fabric of
    ``None`` counts ``.bytes`` only; ``"h2d"``/``"d2h"`` count host
    staging only). Returns the call's sequence number. The resharding
    planner's span uses it alone: its chunks' exchanges are counted as
    collectives of their own."""
    _metrics.inc(f"collective.{name}.calls")
    for nbytes, fabric in shares:
        _metrics.collective_bytes(name, int(nbytes), fabric)
    seq = _SEQ[name]
    _SEQ[name] += 1
    return seq


def _span(name: str, nbytes: int, group=None):
    """One call of collective ``name`` counted (:func:`_count`), and the
    ``collective.<name>`` span of its transfer (module docstring); the
    shared no-op with tracing off."""
    seq = _count(name, nbytes, group)
    return _trace.span(f"collective.{name}", cat="collective", seq=seq,
                       bytes=nbytes)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def reduce_stall(k: torch.Tensor, steps: Optional[int] = None):
    """``k`` after a chain of ``steps`` serial device ops seeded from it
    (``None`` reads ``PYLOPS_MPI_TPU_TORCH_REDUCE_STALL``), each waiting
    on the one before, folded back in as ``+ 0·z``: the value is ``k``
    bit for bit (finite ``k``), but whatever reads it waits for the
    chain. ``steps`` 0 returns ``k`` itself (JAX ``:108-126``)."""
    if steps is None:
        from ..utils import deps as _deps
        steps = _deps.reduce_stall_steps()
    if not steps:
        return k
    z = (torch.sum(k.detach()) * 1e-30).to(torch.float32).reshape(1)
    mul = torch.full((1,), 1.0000001, dtype=torch.float32, device=z.device)
    add = torch.full((1,), 1e-9, dtype=torch.float32, device=z.device)
    for _ in range(int(steps)):
        z = torch.addcmul(add, z, mul)
    return k + (z * 0.0).to(k.dtype).reshape(())


def stall_signature() -> tuple:
    """:func:`reduce_stall`'s part of a captured loop's key: ``()`` when
    off, else ``(("stall", n),)`` (JAX ``:128-135``)."""
    from ..utils import deps as _deps
    n = _deps.reduce_stall_steps()
    return (("stall", n),) if n else ()


def forget_groups() -> None:
    """Drop the cached mask and rank sub-groups (their default group
    ended)."""
    _GROUPS.clear()
    _topo.forget()


def rank_group(ranks: Sequence[int]) -> Optional[object]:
    """The sub-group of the world ranks ``ranks`` (``dist.new_group``,
    which every rank of the world calls in the same order; cached, and
    the same object on members and non-members, as ``new_group`` returns
    a placeholder outside the group). ``None`` without a group."""
    if not initialized():
        return None
    key = ("ranks",) + tuple(int(r) for r in ranks)
    if key not in _GROUPS:
        _GROUPS[key] = dist.new_group(list(key[1:]))
    return _GROUPS[key]


def mask_group(mask: Optional[Sequence]) -> Optional[object]:
    """This rank's sub-group for a ``mask`` of colors, one per rank (the
    reference's ``base_comm.Split(color)``); ``None`` means the whole
    group. ``dist.new_group`` is collective over the world, so every rank
    creates every color's group, in sorted order of the colors, and the
    groups are cached per mask."""
    if mask is None or not initialized():
        return None
    key = tuple(mask)
    if len(key) != world_size():
        raise ValueError(f"mask must have {world_size()} entries, got "
                         f"{len(key)}")
    if key not in _GROUPS:
        mine = None
        for color in sorted(set(key)):
            g = dist.new_group([r for r, c in enumerate(key) if c == color])
            if key[rank()] == color:
                mine = g
        _GROUPS[key] = mine
    return _GROUPS[key]


def _gloo(group) -> bool:
    return dist.get_backend(group) == "gloo"


def _needs_grad(*ts) -> bool:
    """Grad mode is on and one of ``ts`` is a tensor that requires grad."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in ts)


def _refuse_grad(name: str, why: str, *ts) -> None:
    """Raise rather than cut a gradient at a call that has no rule,
    saying ``why``."""
    if _needs_grad(*ts):
        raise NotImplementedError(
            f"{name} has no gradient: {why}. Call it outside grad mode, or "
            "on tensors that do not require grad")


class _AllReduceSum(torch.autograd.Function):
    """``all_reduce(sum)`` whose backward hands the replicated output's
    cotangent to each rank's partial (module docstring)."""

    @staticmethod
    def forward(ctx, t, group):
        return _all_reduce(t.clone(), "sum", group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Replicated(torch.autograd.Function):
    """Identity forward; the cotangent summed over the group."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.clone()

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), "sum", ctx.group), None


def replicated(t: torch.Tensor, group: Optional[object] = None):
    """``t``, which every rank of the group holds the same, as it enters a
    computation that differs by rank (each rank's shard): under grad mode
    its cotangent is summed over the group, so that every rank's copy
    gets the whole gradient. Without a group, or outside grad mode, ``t``
    itself."""
    if not initialized() or not _needs_grad(t):
        return t
    return _Replicated.apply(t, group)


def all_reduce(t: torch.Tensor, op: str = "sum",
               group: Optional[object] = None) -> torch.Tensor:
    """``op`` (``"sum"``, ``"max"``, ``"min"``) of a contiguous tensor
    over the group (the whole world for ``None``), in place; returns
    ``t``. A tensor that requires grad under grad mode is reduced into a
    new tensor, differentiably for ``"sum"`` (module docstring); ``"max"``
    and ``"min"`` then raise."""
    if not initialized():
        return t
    if not t.is_contiguous():
        raise ValueError("all_reduce takes contiguous tensors")
    if _needs_grad(t):
        if op != "sum":
            raise NotImplementedError(
                f"all_reduce({op!r}) has no gradient, as jax.grad has no "
                "rule through pmax/pmin: differentiate a 'sum' reduction "
                "(a 2-norm) instead")
        return _AllReduceSum.apply(t, group)
    return _all_reduce(t, op, group)


def _all_reduce(t: torch.Tensor, op: str, group) -> torch.Tensor:
    nb = _nbytes(t)
    with _span("all_reduce", nb, group):
        if t.is_cuda and _gloo(group):
            host = t.cpu()
            dist.all_reduce(host, op=_OPS[op], group=group)
            return t.copy_(host)
        dist.all_reduce(t, op=_OPS[op], group=group)
        return t


class _AllGather(torch.autograd.Function):
    """:func:`all_gather` with :func:`reduce_scatter` as its backward."""

    @staticmethod
    def forward(ctx, t, sizes, axis, group):
        ctx.args = (sizes, axis, group)
        return _all_gather(t, sizes, axis, group)

    @staticmethod
    def backward(ctx, g):
        return (_ReduceScatter.apply(g.contiguous(), *ctx.args), None, None,
                None)


class _ReduceScatter(torch.autograd.Function):
    """:func:`reduce_scatter` with :func:`all_gather` as its backward."""

    @staticmethod
    def forward(ctx, t, sizes, axis, group):
        ctx.args = (sizes, axis, group)
        return _reduce_scatter(t, sizes, axis, group)

    @staticmethod
    def backward(ctx, g):
        return (_AllGather.apply(g.contiguous(), *ctx.args), None, None,
                None)


def all_gather(t: torch.Tensor, sizes: Sequence[int], axis: int = 0,
               group: Optional[object] = None) -> torch.Tensor:
    """The shards of every rank joined along ``axis``: rank ``p`` holds
    ``sizes[p]`` entries along ``axis``. Ragged shards are padded to the
    largest (NCCL moves equal sizes), gathered, and unpadded. Under grad
    mode its backward is :func:`reduce_scatter`."""
    if not initialized():
        return t
    if _needs_grad(t):
        return _AllGather.apply(t, tuple(sizes), axis, group)
    return _all_gather(t, sizes, axis, group)


def _all_gather(t: torch.Tensor, sizes: Sequence[int], axis: int,
                group, name: Optional[str] = "all_gather") -> torch.Tensor:
    """The gather, counted as ``name`` (``None``: not counted, a phase of
    a two-level gather)."""
    pad = padded_shard_size(sizes) - t.shape[axis]
    v = t
    if pad:
        shp = list(t.shape)
        shp[axis] = pad
        v = torch.cat([t, t.new_zeros(shp)], dim=axis)
    v = v.contiguous()
    stage = v.is_cuda and _gloo(group)
    if stage:
        v = v.cpu()
    parts = [torch.empty_like(v) for _ in sizes]
    nb = _nbytes(v) * (len(sizes) - 1)
    with _span(name, nb, group) if name else nullcontext():
        dist.all_gather(parts, v, group=group)
    parts = [p.narrow(axis, 0, n) for p, n in zip(parts, sizes)]
    out = torch.cat(parts, dim=axis)
    return out.to(t.device) if stage else out


def _p2p(sends: List[Tuple[torch.Tensor, int]],
         recvs: List[Tuple[torch.Tensor, int]], group) -> None:
    """One ``batch_isend_irecv`` of the given (tensor, peer) pairs, peers
    as ranks of the default group, waited on; empty tensors travel
    nowhere."""
    _Posted(sends, recvs, group).wait()


def _comm_device() -> torch.device:
    """Where point-to-point tensors travel: the host under gloo, the
    rank's card under NCCL."""
    if _gloo(None):
        return torch.device("cpu")
    from .mesh import default_mesh
    return default_mesh().device


def exchange(name: str, sends: Sequence[Tuple[torch.Tensor, int]],
             recvs: Sequence[Tuple[Tuple[int, ...], int]],
             dtype: torch.dtype) -> List[torch.Tensor]:
    """One step of point-to-point transfers between world ranks: send
    each ``(tensor, peer)`` and receive a tensor of each ``(shape,
    peer)``, as one ``batch_isend_irecv``. Tensors travel on the
    backend's device (the host under gloo, the rank's card under NCCL;
    a tensor elsewhere is copied there, as :func:`all_to_all` stages),
    and the received ones are returned there, in order. Counted as one
    call of ``name`` receiving their bytes (every rank counts the step,
    as every rank counts an :func:`all_to_all`). Without a group there
    are no peers: nothing moves and nothing is counted. Under grad mode
    its backward is the same step reversed (module docstring)."""
    if not initialized():
        return []
    recvs = tuple((tuple(int(v) for v in shape), int(peer))
                  for shape, peer in recvs)
    if _needs_grad(*(t for t, _ in sends)):
        out = _Exchange.apply(name, tuple(int(p) for _, p in sends), recvs,
                              dtype, *(t for t, _ in sends))
        return list(out[:len(recvs)])
    return _p2p_step(name, sends, recvs, dtype)


def _p2p_step(name: str, sends, recvs, dtype) -> List[torch.Tensor]:
    """:func:`exchange`'s transfer, counted as ``name``."""
    dev = _comm_device()
    tx = [(t.contiguous().to(dev), peer) for t, peer in sends]
    rx = [torch.empty(shape, dtype=dtype, device=dev) for shape, _ in recvs]
    nb = sum(_nbytes(b) for b in rx)
    with _span(name, nb):
        _p2p(tx, [(b, peer) for b, (_, peer) in zip(rx, recvs)], None)
    return rx


class _Exchange(torch.autograd.Function):
    """:func:`exchange` whose backward sends each received buffer's
    cotangent back to its sender and receives, from each peer this rank
    sent to, the cotangent of what it sent: the same pairs in the same
    order, so messages between two ranks match as in the forward. A rank
    that receives nothing returns one empty tensor, which
    :func:`exchange` drops."""

    @staticmethod
    def forward(ctx, name, peers, recvs, dtype, *tensors):
        ctx.meta = (name, peers, recvs,
                    [(tuple(t.shape), t.dtype, t.device) for t in tensors])
        out = _p2p_step(name, list(zip(tensors, peers)), recvs, dtype)
        return tuple(out) if out else (torch.empty(0, dtype=dtype),)

    @staticmethod
    def backward(ctx, *gs):
        name, peers, recvs, sent = ctx.meta
        back = _p2p_step(f"{name}_adjoint",
                         [(g, p) for g, (_, p) in zip(gs, recvs)],
                         [(shape, p) for (shape, _, _), p in zip(sent, peers)],
                         gs[0].dtype)
        return (None, None, None, None,
                *(b.to(device=dev, dtype=dt)
                  for b, (_, dt, dev) in zip(back, sent)))


def reduce_scatter(t: torch.Tensor, sizes: Sequence[int], axis: int = 0,
                   group: Optional[object] = None) -> torch.Tensor:
    """The sum over the group of every rank's ``t``, of which this rank
    keeps its piece along ``axis``: the group's rank ``q`` keeps
    ``sizes[q]`` entries, in order (the counterpart of ``psum_scatter``).
    Ragged pieces are padded to the largest (NCCL moves equal sizes),
    reduced and unpadded. Under grad mode its backward is
    :func:`all_gather`."""
    if not initialized():
        return t
    if _needs_grad(t):
        return _ReduceScatter.apply(t, tuple(sizes), axis, group)
    return _reduce_scatter(t, sizes, axis, group)


def _reduce_scatter(t: torch.Tensor, sizes: Sequence[int], axis: int,
                    group, name: Optional[str] = "reduce_scatter"
                    ) -> torch.Tensor:
    """The reduction, counted as ``name`` (``None``: not counted, a phase
    of a two-level reduce-scatter)."""
    me = dist.get_group_rank(group, rank()) if group is not None else rank()
    width = padded_shard_size(sizes)
    pieces = []
    for piece in torch.split(t, list(sizes), dim=axis):
        pad = width - piece.shape[axis]
        if pad:
            shp = list(piece.shape)
            shp[axis] = pad
            piece = torch.cat([piece, piece.new_zeros(shp)], dim=axis)
        pieces.append(piece.contiguous())
    stage = t.is_cuda and _gloo(group)
    if stage:
        pieces = [p.cpu() for p in pieces]
    out = torch.empty_like(pieces[me])
    nb = _nbytes(out) * (len(sizes) - 1)
    with _span(name, nb, group) if name else nullcontext():
        dist.reduce_scatter(out, pieces, op=dist.ReduceOp.SUM, group=group)
    out = out.narrow(axis, 0, int(sizes[me]))
    return out.to(t.device) if stage else out


def _group_rank(group) -> int:
    return dist.get_group_rank(group, rank()) if group is not None \
        else rank()


def all_to_all(sends: Sequence[torch.Tensor],
               recv_shapes: Sequence[Tuple[int, ...]],
               group: Optional[object] = None) -> List[torch.Tensor]:
    """Rank ``p`` sends ``sends[q]`` to every rank ``q`` and receives a
    tensor of ``recv_shapes[q]`` from each (sizes may differ, which
    gloo's own ``all_to_all`` refuses): point-to-point pairs in one
    batch, this rank's own piece copied locally. On a sub-group, ``p``
    and ``q`` are ranks of the group, mapped to their global ranks for
    the transfers. Under grad mode its backward is the same call on the
    cotangents with the shapes swapped (module docstring)."""
    if not initialized():
        return [sends[0]]
    recv_shapes = tuple(tuple(int(v) for v in s) for s in recv_shapes)
    if _needs_grad(*sends):
        return list(_AllToAll.apply(group, recv_shapes, *sends))
    return _all_to_all("all_to_all", sends, recv_shapes, group)


def _a2a_buffers(sends, recv_shapes, group):
    """An all-to-all's transfers: ``(out, tx, rx, stage)``, the receive
    buffers in group rank order (on the host for CUDA tensors under
    gloo), the (tensor, global peer) sends and receives, and whether the
    pieces are staged."""
    me = _group_rank(group)
    like = sends[me]
    stage = like.is_cuda and _gloo(group)
    dev = torch.device("cpu") if stage else like.device
    out = [torch.empty(tuple(s), dtype=like.dtype, device=dev)
           for s in recv_shapes]
    tx = [(t.contiguous().cpu() if stage else t.contiguous(),
           _global(group, q)) for q, t in enumerate(sends) if q != me]
    rx = [(out[q], _global(group, q))
          for q in range(len(recv_shapes)) if q != me]
    return out, tx, rx, stage


def _a2a_result(out, sends, group, stage) -> List[torch.Tensor]:
    """The received pieces on the senders' device, this rank's own the
    piece it kept."""
    me = _group_rank(group)
    like = sends[me]
    out = [o.to(like.device) for o in out] if stage else list(out)
    out[me] = like
    return out


def _all_to_all(name: str, sends, recv_shapes, group) -> List[torch.Tensor]:
    out, tx, rx, stage = _a2a_buffers(sends, recv_shapes, group)
    nb = sum(_nbytes(t) for t, _ in rx)
    with _span(name, nb, group):
        _p2p(tx, rx, group)
    return _a2a_result(out, sends, group, stage)


class _AllToAll(torch.autograd.Function):
    """:func:`all_to_all` whose backward is an ``all_to_all`` of the
    cotangents back to the ranks that sent the pieces, counted as
    ``all_to_all_adjoint``."""

    @staticmethod
    def forward(ctx, group, recv_shapes, *sends):
        ctx.meta = (group, tuple(tuple(t.shape) for t in sends))
        return tuple(_all_to_all("all_to_all", sends, recv_shapes, group))

    @staticmethod
    def backward(ctx, *gs):
        group, send_shapes = ctx.meta
        back = _all_to_all("all_to_all_adjoint", gs, send_shapes, group)
        return (None, None, *back)


Piece = Union[int, torch.Tensor]


def _neighbour_buffers(block: torch.Tensor, axis: int, front: int,
                      back: int, prev: Optional[int], nxt: Optional[int]):
    """A neighbour exchange's transfers: ``(top, bottom, sends, recvs,
    stage)``, the receive pieces (buffers, or counts of zero slices past
    the ends), the (tensor, peer) sends and receives, and whether they
    are staged through the host (CUDA tensors under gloo)."""
    shape = list(block.shape)
    stage = block.is_cuda and _gloo(None)
    dev = torch.device("cpu") if stage else block.device

    def out(n):
        shape[axis] = n
        return torch.empty(shape, dtype=block.dtype, device=dev)

    def send(t):
        t = t.detach().contiguous()
        return t.cpu() if stage else t

    rows = int(block.shape[axis])
    top = out(front) if prev is not None and front else front
    bottom = out(back) if nxt is not None and back else back
    sends, recvs = [], []
    if prev is not None:
        if back:
            sends.append((send(block.narrow(axis, 0, back)), prev))
        if front:
            recvs.append((top, prev))
    if nxt is not None:
        if front:
            sends.append((send(block.narrow(axis, rows - front, front)), nxt))
        if back:
            recvs.append((bottom, nxt))
    return top, bottom, sends, recvs, stage


def _unstage(pieces, device) -> Tuple[Piece, Piece]:
    return tuple(p.to(device) if isinstance(p, torch.Tensor) else p
                 for p in pieces)


def halo_exchange(block: torch.Tensor, front: int,
                  back: int) -> Tuple[Piece, Piece]:
    """Ghost rows of ``block`` (axis 0) from the neighbouring ranks: the
    previous rank's last ``front`` rows and the next rank's first
    ``back`` rows, posted as one ``batch_isend_irecv`` with both
    neighbours and waited on at once (:func:`ring_halo_ghosts` is the
    same exchange left pending). Returns the pieces ``(top, bottom)``:
    contiguous received tensors, or row counts (of zeros) at the ends of
    the world. No concatenated slab is built; the tap kernel takes the
    pieces as they are.

    The counterpart of the JAX package's ``halo_slab``. Its relocation
    of the back ghost after a ragged shard's last valid row has nothing
    to do here: a rank's shard is a tensor of its exact size, not a
    padded block. A rank sends its last ``front`` rows forward and its
    first ``back`` rows back, so it must hold that many."""
    pending = _post_ring("halo_exchange", block, front, back)
    return pending.wait() if pending is not None else (front, back)


def _post_ring(name: str, block: torch.Tensor, front: int,
               back: int) -> Optional["_PostedNeighbours"]:
    """The 1-D ring's neighbour exchange along axis 0, posted and counted
    as ``name``; ``None`` without a group."""
    if not initialized():
        return None
    P, r = world_size(), rank()
    rows = int(block.shape[0])
    if rows < max(front if r < P - 1 else 0, back if r > 0 else 0):
        raise ValueError(f"rank {r} holds {rows} rows, fewer than the "
                         f"ghost widths ({front}, {back}) it sends")
    return _PostedNeighbours(name, block, 0, front, back,
                             r - 1 if r > 0 else None,
                             r + 1 if r < P - 1 else None)


def _neighbour_backward(meta, gtop, gbottom) -> torch.Tensor:
    """The cotangent of a neighbour exchange's block: the forward's
    exchange reversed, the ghosts' cotangents, joined, leaving as a block's
    edge slices (``gtop`` to prev, ``gbottom`` to nxt), and the cotangents
    of this rank's own edges arriving in their place."""
    name, axis, front, back, prev, nxt, event, shape = meta
    first, last = _PostedNeighbours(
        f"{name}_adjoint", torch.cat([gtop, gbottom], dim=axis), axis,
        back, front, prev, nxt, event)._arrive()
    grad = gtop.new_zeros(shape)
    if isinstance(first, torch.Tensor):
        grad.narrow(axis, 0, back).add_(first)
    if isinstance(last, torch.Tensor):
        grad.narrow(axis, shape[axis] - front, front).add_(last)
    return grad


def cart_halo_extend(block: torch.Tensor, grid: Sequence[int], ax: int,
                     hm: int, hp: int) -> torch.Tensor:
    """``block`` extended along axis ``ax`` with ``hm`` ghost slices from
    its minus neighbour on the Cartesian ``grid`` and ``hp`` from its plus
    neighbour, zeros past the grid's ends (the plain path of the JAX
    package's ``cart_halo_extend``): :func:`post_cart_halo` waited on at
    once. The ranks map onto ``grid`` row-major,
    so the neighbours along ``ax`` are ``rank ∓ prod(grid[ax + 1:])``.
    Called once per axis in turn, each call sends slabs of the block the
    earlier calls extended, which relays the corner values. Along an axis
    of one rank, or without a group, the ghosts are zeros and nothing
    moves; a call that moves nothing is not counted. A call that moves
    records the ``collective.cart_halo_extend`` event (JAX ``:338``; its
    ``axis`` tag, a mesh axis name, is ``None`` here). Under grad mode
    the ghosts' cotangents go back to their owners (module docstring)."""
    return post_cart_halo(block, grid, ax, hm, hp).wait()


def _stitch(pieces: Tuple[Piece, Piece], block: torch.Tensor,
            ax: int) -> torch.Tensor:
    """``block`` between its two ghost pieces along ``ax`` (a count is
    that many zero slices)."""
    parts = []
    for p in (pieces[0], block, pieces[1]):
        if isinstance(p, torch.Tensor):
            parts.append(p)
        elif p:
            shape = list(block.shape)
            shape[ax] = p
            parts.append(block.new_zeros(shape))
    return torch.cat(parts, dim=ax) if len(parts) > 1 else block


def broadcast(t: torch.Tensor, src: int = 0,
              group: Optional[object] = None) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank, in place (the other ranks pass
    a tensor of the same shape and dtype to fill); returns ``t``. Under a
    gloo group a CUDA tensor is staged through the host. It has no
    gradient: the JAX package has no broadcast collective (the port's
    carries the solve service's host data)."""
    if not initialized():
        return t
    _refuse_grad("broadcast", "the JAX package has no broadcast collective, "
                 "so there is no rule to port", t)
    nb = _nbytes(t) if rank() != src else 0
    with _span("broadcast", nb, group):
        if t.is_cuda and _gloo(group):
            host = t.cpu()
            dist.broadcast(host, src=src, group=group)
            return t.copy_(host)
        dist.broadcast(t, src=src, group=group)
        return t


# --------------------------------------------------------------------------
# The pipelined layer (JAX ``parallel/collectives.py:394-653``): collectives
# decomposed into steps whose transfers are posted before the compute that
# does not need them and waited on only where their data is read. The bulk
# collectives above lay out the same buffers and wait at once (``_p2p``;
# the neighbour exchanges are :class:`_PostedNeighbours` waited on at
# once); an operator with overlap off calls only those.


def _group_size(group) -> int:
    return dist.get_world_size(group) if group is not None else world_size()


def _global(group, q: int) -> int:
    return dist.get_global_rank(group, q) if group is not None else q


class _Posted:
    """Point-to-point transfers posted as one ``batch_isend_irecv`` and not
    yet waited on. Every send and receive buffer is held until
    :meth:`wait`, so none is freed or reused while its transfer is in
    flight. Under NCCL the transfers run on NCCL's stream, and ``wait``
    makes the current stream wait for them before anything reads a
    received buffer; under gloo they run on gloo's threads while the host
    goes on."""

    def __init__(self, sends, recvs, group=None):
        ops = [dist.P2POp(dist.isend, t, peer, group)
               for t, peer in sends if t.numel()]
        ops += [dist.P2POp(dist.irecv, t, peer, group)
                for t, peer in recvs if t.numel()]
        self._works = dist.batch_isend_irecv(ops) if ops else []
        self._held = (sends, recvs)

    def wait(self) -> None:
        for w in self._works:
            w.wait()
        self._works, self._held = [], None


def _differentiable(t: torch.Tensor) -> bool:
    return t.is_floating_point() or t.is_complex()


class _Hop:
    """One ring hop, posted at construction: the tensors ``wire`` (on the
    transport device) go to ``to`` and tensors of their shapes come from
    ``frm`` (global ranks). :meth:`finish` waits and returns the received
    tensors on the devices of ``inputs`` (what this rank sent, as its
    caller holds them), through :class:`_HopWait` when one of those
    requires grad. ``rx`` stays on the transport device, ready to be sent
    on by the next hop without another copy."""

    def __init__(self, name: str, wire, to: int, frm: int, group,
                 last: bool, hops: int, split: Optional[Tuple[int, int]] = None):
        self.name, self.to, self.frm, self.group = name, to, frm, group
        self.last, self.hops, self.split = last, hops, split
        self.rx = tuple(torch.empty_like(t) for t in wire)
        self._posted = _Posted([(t, to) for t in wire],
                               [(b, frm) for b in self.rx], group)
        steps[name] += 1

    def _arrive(self, devices) -> Tuple[torch.Tensor, ...]:
        self._posted.wait()
        return tuple(b.to(d) for b, d in zip(self.rx, devices))

    def finish(self, inputs) -> Tuple[torch.Tensor, ...]:
        if _needs_grad(*inputs):
            return tuple(_HopWait.apply(self, *inputs))
        return self._arrive([t.device for t in inputs])


class _HopWait(torch.autograd.Function):
    """The wait of a posted :class:`_Hop`; its backward is the hop
    reversed: each received tensor's cotangent goes back to the rank it
    came from, and the cotangents of what this rank sent come from the
    rank it went to. Counted as ``<name>_adjoint``: one call a ring (at
    the backward of its last hop, which runs first), one step a hop.
    Integer tensors (the sparse ring's columns) carry no cotangent."""

    @staticmethod
    def forward(ctx, hop, *inputs):
        ctx.hop = hop
        ctx.meta = [(tuple(t.shape), t.dtype, t.device) for t in inputs]
        out = hop._arrive([t.device for t in inputs])
        ctx.mark_non_differentiable(
            *[o for o in out if not _differentiable(o)])
        return out

    @staticmethod
    def backward(ctx, *gs):
        hop = ctx.hop
        dev = _comm_device()
        diff = [k for k, (_, dt, _) in enumerate(ctx.meta)
                if dt.is_floating_point or dt.is_complex]
        tx = [(gs[k].contiguous().to(dev), hop.frm) for k in diff]
        rx = [torch.empty(ctx.meta[k][0], dtype=ctx.meta[k][1], device=dev)
              for k in diff]
        name = f"{hop.name}_adjoint"
        if hop.last:
            blk = sum(_nbytes(b) for b in rx)
            if hop.split is None:
                _count(name, blk * hop.hops, hop.group)
            else:
                _count_shares(name, _ring_shares(blk, *hop.split, hop.group))
        steps[name] += 1
        _Posted(tx, [(b, hop.to) for b in rx], hop.group).wait()
        grads: List[Optional[torch.Tensor]] = [None] * len(ctx.meta)
        for k, b in zip(diff, rx):
            grads[k] = b.to(ctx.meta[k][2])
        return (None, *grads)


def _ring_peers(group, shift: int) -> Tuple[int, int, int, int]:
    """``(n, i, to, frm)``: the group's size, this rank's place in it, and
    the global ranks it sends to (``i - shift``) and receives from
    (``i + shift``) on the ring; ``(1, 0, 0, 0)`` without a group."""
    if not initialized():
        return 1, 0, 0, 0
    n, i = _group_size(group), _group_rank(group)
    return (n, i, _global(group, (i - shift) % n),
            _global(group, (i + shift) % n))


def _ring_shares(blk: int, D: int, L: int, group
                 ) -> List[Tuple[int, Optional[str]]]:
    """The host-blocked ring's bytes on this rank, ``blk`` a hop:
    ``D·(L - 1)`` inner hops on NVLink and ``D - 1`` outer hops on IB
    (JAX ``:470-478``); one share of them all where the world is not
    laid out hosts × ranks."""
    if _topo.group_fabric(group) is None:
        return [(blk * (D * L - 1), None)]
    return [(blk * D * (L - 1), "nvlink"), (blk * (D - 1), "ib")]


def ring_pass(block, body: Callable, init=None, shift: int = 1,
              group: Optional[object] = None,
              slice_size: Optional[int] = None):
    """Double-buffered ring pipeline over ``group`` (JAX ``:402-456``): the
    resident buffer starts as this rank's ``block`` (a tensor or a tuple
    of tensors) and moves ``shift`` places down the ring at each step, so
    that after ``n`` steps every rank has seen every rank's block. At step
    ``s`` the resident is the block of owner ``(i + s·shift) mod n``, and
    ``body(acc, resident, owner, s)`` folds it into the accumulator
    (``init`` at the first step); the result is the last ``acc``.

    Hop ``s + 1`` is posted BEFORE ``body`` runs step ``s`` and waited on
    only at the next step, so the transfer carries no dependence on the
    compute: ``n - 1`` hops interleaved with ``n`` calls of ``body``. The
    body must not write the resident it is given (the next hop may be
    sending it). Under gloo, CUDA tensors are staged through the host once,
    at the first hop; a received block is sent on from the host buffer it
    arrived in, and copied to the card for the body.

    Counted as one call of ``ring_pass`` receiving the ``n - 1`` blocks,
    its hops in :data:`steps`. Under grad mode each hop's backward sends
    the cotangents back down the ring (``ring_pass_adjoint``). Without a
    group, or in a group of one, ``body(init, block, i, 0)`` runs once
    and nothing moves or is counted.

    ``slice_size`` ``L`` (JAX ``:402-503``): the group's ranks lie on
    hosts in runs of ``L`` (``topology.slice_run``), and the hops follow
    the host-blocked order: inner hops rotate the resident within this
    rank's run (NVLink), and after each lap of ``L - 1`` inner hops one
    outer hop moves every resident one run down (IB): ``n/L - 1`` host
    crossings a ring, not up to one a hop. At step ``t``, with ``k = t //
    L`` outer hops made, rank ``(d, l)`` (its run, its place in it) holds
    the block of owner ``((d + k) % D)·L + (l + t - k) % L``: every owner
    once, in another order than the flat ring's, so a body that depends
    on the order must place by ``owner``. The same hop count, double
    buffering, ``steps`` and gradient (each hop's backward reverses that
    hop); counted as one ``ring_pass`` call with ``blk·D·(L - 1)`` bytes
    on NVLink and ``blk·(D - 1)`` on IB. It engages only for ``1 < L <
    n``, ``n % L == 0`` and ``shift == 1``; otherwise the flat ring
    runs."""
    tup = isinstance(block, (tuple, list))
    blocks = tuple(block) if tup else (block,)
    n, i, to, frm = _ring_peers(group, shift)
    if n == 1:
        return body(init, block, i, 0)
    L = int(slice_size) if slice_size else 0
    if 1 < L < n and n % L == 0 and shift == 1:
        return _ring_pass_hier(block, blocks, tup, body, init, group, n, i,
                               L)
    dev = _comm_device()
    nb = sum(_nbytes(t) for t in blocks) * (n - 1)
    with _span("ring_pass", nb, group):
        resident = blocks
        wire = tuple(t.detach().contiguous().to(dev) for t in blocks)
        acc = init
        for s in range(n):
            hop = (_Hop("ring_pass", wire, to, frm, group, s == n - 2, n - 1)
                   if s < n - 1 else None)
            acc = body(acc, resident if tup else resident[0],
                       (i + s * shift) % n, s)
            if hop is not None:
                resident, wire = hop.finish(resident), hop.rx
    return acc


def _ring_pass_hier(block, blocks, tup, body, init, group, n: int, i: int,
                    L: int):
    """:func:`ring_pass`'s host-blocked hop order (JAX ``_ring_pass_hier``,
    ``:459-503``), rank ``i = d·L + l`` of ``n = D·L``."""
    D, d, l = n // L, i // L, i % L
    dev = _comm_device()
    blk = sum(_nbytes(t) for t in blocks)
    # an inner hop sends to the previous place of the run and receives
    # from the next; an outer hop to the same place of the previous run
    inner = (_global(group, d * L + (l - 1) % L),
             _global(group, d * L + (l + 1) % L))
    outer = (_global(group, (i - L) % n), _global(group, (i + L) % n))
    shares = _ring_shares(blk, D, L, group)
    seq = _count_shares("ring_pass", shares)
    with _trace.span("collective.ring_pass", cat="collective", seq=seq,
                     bytes=blk * (n - 1), slice_size=L):
        resident = blocks
        wire = tuple(t.detach().contiguous().to(dev) for t in blocks)
        acc = init
        for t in range(n):
            hop = None
            if t < n - 1:
                to, frm = outer if (t + 1) % L == 0 else inner
                hop = _Hop("ring_pass", wire, to, frm, group, t == n - 2,
                           n - 1, (D, L))
            k = t // L
            owner = ((d + k) % D) * L + (l + t - k) % L
            acc = body(acc, resident if tup else resident[0], owner, t)
            if hop is not None:
                resident, wire = hop.finish(resident), hop.rx
    return acc


def ring_reduce_scatter(chunk: Callable[[int], torch.Tensor],
                        group: Optional[object] = None) -> torch.Tensor:
    """Reduce-scatter as a ring (JAX ``ops/stack.py:177-233``,
    ``ops/matrixmult.py:475-508``): ``chunk(j)`` is this rank's partial of
    output chunk ``j`` (one shape for every ``j``), and the group's rank
    ``i`` ends with the sum over the group of ``chunk(i)``. An accumulator
    moves down the ring ``n - 1`` times; at each step the next partial is
    computed while the hop is in flight and added when it lands
    (``received + chunk(j)``). Counted as one call of
    ``ring_reduce_scatter``, its hops in :data:`steps`; differentiable as
    :func:`ring_pass`. Without a group, or in a group of one,
    ``chunk(i)``."""
    n, i, to, frm = _ring_peers(group, 1)
    if n == 1:
        return chunk(i)
    dev = _comm_device()
    buf = chunk((i + 1) % n)
    with _span("ring_reduce_scatter", _nbytes(buf) * (n - 1), group):
        for s in range(n - 1):
            hop = _Hop("ring_reduce_scatter",
                       (buf.detach().contiguous().to(dev),), to, frm, group,
                       s == n - 2, n - 1)
            c = chunk((i + s + 2) % n)
            buf = hop.finish((buf,))[0] + c
    return buf


class _PostedNeighbours:
    """A neighbour exchange along ``axis`` of ``block``, split at its
    wait: this rank receives the ``prev`` rank's last ``front`` slices and
    the ``nxt`` rank's first ``back`` ones, and sends its own to them, as
    one ``batch_isend_irecv``. ``prev``/``nxt`` are ``None`` past the
    ends; there the piece is a count of (zero) slices instead of a
    tensor. Slabs along an axis other than 0 go as contiguous copies.
    The transfers are posted, and counted as ``name`` (with the
    Cartesian exchange's event when ``event`` is given), at
    construction; :meth:`wait` returns the pieces (under the
    ``collective.<name>`` span when there is no event), through
    :class:`_NeighbourWait` when ``block`` requires grad. The bulk
    exchanges (:func:`halo_exchange`, :func:`cart_halo_extend`) wait at
    once."""

    def __init__(self, name: str, block: torch.Tensor, axis: int, front: int,
                 back: int, prev: Optional[int], nxt: Optional[int],
                 event: Optional[dict] = None):
        self.top, self.bottom, sends, recvs, self.stage = \
            _neighbour_buffers(block, axis, front, back, prev, nxt)
        self.nbytes = sum(_nbytes(t) for t, _ in recvs)
        # each piece is charged to the fabric between this rank and its
        # sender (JAX ``parallel/collectives.py:310-336``, ``:520-540``)
        self.seq = _count_shares(name, _peer_shares(
            [(_nbytes(t), peer) for t, peer in recvs]))
        if event is not None:
            _trace.event(f"collective.{name}", cat="collective", seq=self.seq,
                         **event)
        self._posted = _Posted(sends, recvs, None)
        self.name, self.block, self.device = name, block, block.device
        self.event = event
        self.meta = (name, axis, front, back, prev, nxt, event,
                     tuple(block.shape))

    def _arrive(self) -> Tuple[Piece, Piece]:
        if self.event is None:
            with _trace.span(f"collective.{self.name}", cat="collective",
                             seq=self.seq, bytes=self.nbytes):
                self._posted.wait()
        else:
            self._posted.wait()
        pieces = (self.top, self.bottom)
        return _unstage(pieces, self.device) if self.stage else pieces

    def wait(self) -> Tuple[Piece, Piece]:
        if not _needs_grad(self.block):
            return self._arrive()
        top, bottom = _NeighbourWait.apply(self.block, self)
        return (top if isinstance(self.top, torch.Tensor) else self.top,
                bottom if isinstance(self.bottom, torch.Tensor)
                else self.bottom)


class _NeighbourWait(torch.autograd.Function):
    """The wait of a :class:`_PostedNeighbours`. Its backward sends each
    received ghost's cotangent back to the rank that owns those slices,
    which adds it to its edge slices (:func:`_neighbour_backward`),
    counted as ``<name>_adjoint`` (with its event for the Cartesian
    exchange). Absent pieces are empty tensors."""

    @staticmethod
    def forward(ctx, block, pending):
        ctx.meta = pending.meta
        axis = pending.meta[1]

        def piece(p):
            if isinstance(p, torch.Tensor):
                return p
            return block.new_empty(block.shape[:axis] + (0,)
                                   + block.shape[axis + 1:])
        top, bottom = pending._arrive()
        return piece(top), piece(bottom)

    @staticmethod
    def backward(ctx, gtop, gbottom):
        return _neighbour_backward(ctx.meta, gtop, gbottom), None


class _Ghosts:
    """The pending ghosts of :func:`ring_halo_ghosts`."""

    def __init__(self, block: torch.Tensor, front: int, back: int,
                 pending: Optional[_PostedNeighbours]):
        self.block, self.front, self.back = block, front, back
        self._pending = pending

    def wait(self) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        """``(front_ghost, back_ghost)``: the received slabs, zeros past
        the domain's edges, ``None`` for a zero-width side."""
        pieces = (self._pending.wait() if self._pending is not None
                  else (self.front, self.back))
        tail = tuple(self.block.shape[1:])
        return tuple(
            None if not width else
            p if isinstance(p, torch.Tensor) else
            self.block.new_zeros((width,) + tail)
            for p, width in zip(pieces, (self.front, self.back)))


def ring_halo_ghosts(block: torch.Tensor, front: int, back: int) -> _Ghosts:
    """The 1-D ring halo exchange's two ghost slabs along axis 0, NOT
    stitched onto the block (JAX ``:504-560``): the previous rank's last
    ``front`` rows and the next rank's first ``back`` rows. The sends and
    receives are posted here; the caller computes what needs no ghost and
    then calls ``.wait()``, which returns ``(front_ghost, back_ghost)``,
    zero at the domain's edges and ``None`` for a zero-width side.
    Counted as ``ring_halo_ghosts``, with the bytes :func:`halo_exchange`
    receives for the same widths; under grad mode the ghosts' cotangents
    go home as :func:`halo_exchange`'s do (``ring_halo_ghosts_adjoint``).
    The two ranks of a pair post their messages in the same order, so at
    two ranks, where both directions join the same peer, they match."""
    return _Ghosts(block, front, back,
                   _post_ring("ring_halo_ghosts", block, front, back))


def ring_halo_extend(block: torch.Tensor, front: int = 0,
                     back: int = 0) -> torch.Tensor:
    """``block`` extended along axis 0 with the previous rank's last
    ``front`` rows and the next rank's first ``back`` rows, zeros at the
    domain's edges (JAX ``:946-959``), through :func:`ring_halo_ghosts`."""
    gf, gb = ring_halo_ghosts(block, front, back).wait()
    parts = [p for p in (gf, block, gb) if p is not None]
    return torch.cat(parts) if len(parts) > 1 else block


class _CartPending:
    """The pending result of :func:`post_cart_halo`."""

    def __init__(self, block, ax, pieces, pending):
        self.block, self.ax = block, ax
        self._pieces, self._pending = pieces, pending

    def wait(self) -> torch.Tensor:
        pieces = (self._pending.wait() if self._pending is not None
                  else self._pieces)
        return _stitch(pieces, self.block, self.ax)


def post_cart_halo(block: torch.Tensor, grid: Sequence[int], ax: int,
                   hm: int, hp: int) -> _CartPending:
    """:func:`cart_halo_extend` split at its wait: the exchange along
    ``ax`` is posted (and counted, with its event) here, and ``.wait()``
    returns what :func:`cart_halo_extend` returns, so that the caller can
    work on what needs no ghost meanwhile (the overlap path of
    ``MPIHalo``)."""
    grid = tuple(int(g) for g in grid)
    if (hm or hp) and initialized() and grid[ax] > 1:
        if int(np.prod(grid)) != world_size():
            raise ValueError(f"grid {grid} does not match the world of "
                             f"{world_size()} ranks")
        r = rank()
        coord = int(np.unravel_index(r, grid)[ax])
        stride = int(np.prod(grid[ax + 1:]))
        pending = _PostedNeighbours(
            "cart_halo_extend", block, ax, hm, hp,
            r - stride if coord > 0 else None,
            r + stride if coord < grid[ax] - 1 else None,
            dict(shape=tuple(block.shape), dtype=block.dtype, axis=None,
                 grid=grid, ax=ax, hm=hm, hp=hp))
        return _CartPending(block, ax, None, pending)
    return _CartPending(block, ax, (hm, hp), None)


def resolve_chunks(width: int, n_shards: int, chunks: int,
                   where: str = "pencil transpose",
                   allow_plan: bool = False) -> int:
    """The usable chunk count for streaming an axis of ``width`` through
    chunked all-to-alls over ``n_shards`` ranks (JAX ``:563-604``): every
    chunk must carry at least one column per rank, so the count is capped
    at ``width // n_shards``; a request past the cap falls back to it (1
    is the bulk schedule) with a logged note and a
    ``collective.resolve_chunks_fallback`` event, never an error.

    ``allow_plan``: a ``chunks`` that came from the default, not from the
    user (the caller says so), may be replaced by the tuner's banked chunk
    plan (:func:`~..tuning.plan.chunk_hint`, inert with tuning off); an
    explicit ``comm_chunks=`` never passes ``True``, so a pinned count
    always wins."""
    chunks = int(chunks)
    if allow_plan:
        from ..tuning.plan import chunk_hint
        hint = chunk_hint(where, int(width), int(n_shards))
        if hint is not None and hint != chunks:
            _trace.event("tuning.chunk_plan", cat="tuning", where=where,
                         width=int(width), n_shards=int(n_shards),
                         requested=chunks, planned=int(hint))
            chunks = int(hint)
    if chunks <= 1 or n_shards <= 1:
        return 1
    cap = max(1, int(width) // int(n_shards))
    if chunks > cap:
        _logger.info(
            "%s: comm_chunks=%d does not fit an axis of length %d over %d "
            "shards; falling back to %d chunk(s)", where, chunks, width,
            n_shards, cap)
        _trace.event("collective.resolve_chunks_fallback", cat="fallback",
                     where=where, requested=chunks, width=int(width),
                     n_shards=int(n_shards), resolved=cap)
        return cap
    return chunks


def _split_sizes(n: int, parts: int) -> List[int]:
    return [s[0] for s in local_split((int(n),), int(parts),
                                      Partition.SCATTER, 0)]


def _a2a_shapes(like: torch.Tensor, ax: int, n_ax: int, other: int,
                sizes: Sequence[int]) -> List[Tuple[int, ...]]:
    """Receive shapes: ``like``'s shape with ``n_ax`` along ``ax`` and each
    of ``sizes`` along ``other``."""
    out = []
    for k in sizes:
        shp = list(like.shape)
        shp[ax], shp[other] = n_ax, k
        out.append(tuple(shp))
    return out


class _PostedA2A:
    """An all-to-all of exact-size pieces over ``group`` posted as one
    batch (:func:`all_to_all`'s transfer, not counted: the chunked
    transpose counts itself); :meth:`wait` returns the pieces in group
    rank order, this rank's own the piece it kept, or them joined along
    ``join``; :attr:`shares` its bytes by fabric."""

    def __init__(self, sends, recv_shapes, group, join=None):
        self.out, tx, rx, self.stage = _a2a_buffers(sends, recv_shapes,
                                                    group)
        self.nbytes = sum(_nbytes(t) for t, _ in rx)
        self._posted = _Posted(tx, rx, group)
        self.sends, self.group, self.join = sends, group, join

    @property
    def shares(self) -> List[Tuple[int, Optional[str]]]:
        return [(self.nbytes, _topo.group_fabric(self.group))]

    def wait(self):
        self._posted.wait()
        got = _a2a_result(self.out, self.sends, self.group, self.stage)
        return got if self.join is None else torch.cat(got, dim=self.join)


def chunked_pencil_transpose(b: torch.Tensor, out_ax: int, chunks: int,
                             mid: Callable[[torch.Tensor], torch.Tensor],
                             rows_in: Sequence[int],
                             rows_out: Sequence[int],
                             group: Optional[object] = None,
                             two_level: bool = False) -> torch.Tensor:
    """The streamed double pencil transpose (JAX ``:615-653``): ``b`` holds
    this rank's ``rows_in[me]`` rows (axis 0) of the whole ``out_ax``
    width, which is cut into ``chunks`` contiguous chunks, each cut again
    over the ranks. Each chunk goes through ``all_to_all`` (this rank gets
    every row, ``sum(rows_in)``, of its columns of the chunk), ``mid`` (the
    axis-0 work, returning ``sum(rows_out)`` rows) and ``all_to_all`` back
    (``rows_out[me]`` rows, the whole chunk), and the chunks are joined
    along ``out_ax``: what the bulk transpose, ``mid`` and the transpose
    back give, pieces at their exact sizes as there.

    Chunk ``k + 1``'s transfer is posted before ``mid`` runs on chunk
    ``k``, and each chunk's way back is posted as soon as ``mid`` is done
    and waited on at the end, so transfers fly while the transforms run.
    Counted as one call of ``chunked_pencil_transpose`` receiving both
    directions' bytes, its chunks in :data:`steps`. Under grad mode, with
    a ``b`` or a ``mid`` output that requires grad, each chunk's exchanges
    are the differentiable :func:`all_to_all` (counted as such) and are not
    posted ahead. ``chunks`` must fit (:func:`resolve_chunks`).

    ``two_level`` (JAX ``hier_chunked_pencil_transpose``, ``:803-839``;
    over the world, on a world laid out hosts × ranks) sends each chunk
    through the two-level transpose (:func:`hier_pencil_transpose`:
    NVLink, then IB; back IB, then NVLink), posted ahead as above, bit
    for bit the flat stream; counted as ``hier_chunked_pencil_transpose``
    with both directions' bytes by fabric, and under grad mode each
    chunk runs the differentiable :func:`hier_pencil_transpose`. Without
    a process group it is the flat stream."""
    K = int(chunks)
    groups = _hier(None) if two_level and initialized() else None
    name = ("hier_chunked_pencil_transpose" if groups is not None
            else "chunked_pencil_transpose")
    n = _group_size(group) if initialized() else 1
    me = _group_rank(group) if initialized() else 0
    widths = _split_sizes(b.shape[out_ax], K)
    if min(widths) < n:
        raise ValueError(f"{name}: {K} chunks of an axis of "
                         f"{b.shape[out_ax]} leave a chunk narrower than "
                         f"the {n} ranks (resolve_chunks caps the count)")
    chunk_in = torch.split(b, widths, dim=out_ax)
    cols = [_split_sizes(w, n) for w in widths]
    grad = _needs_grad(b)
    by: Dict[Optional[str], int] = {}

    def move(t, send_ax, recv_ax, send_sizes, recv_sizes, forward, grad):
        """One chunk's transfer: posted, or done at once under grad mode
        (and in a world of one)."""
        if groups is not None:
            if grad:
                return hier_pencil_transpose(t, send_ax, recv_ax, send_sizes,
                                             recv_sizes, forward, groups)
            return _TwoLevelA2A(t, send_ax, recv_ax, send_sizes, recv_sizes,
                                groups, forward)
        sends = list(torch.split(t, list(send_sizes), dim=send_ax))
        shapes = _a2a_shapes(t, send_ax, send_sizes[me], recv_ax,
                             recv_sizes)
        if grad or n == 1:
            return torch.cat(all_to_all(sends, shapes, group), dim=recv_ax)
        return _PostedA2A(sends, shapes, group, join=recv_ax)

    def done(p):
        if isinstance(p, torch.Tensor):
            return p
        out = p.wait()
        for nb, fab in p.shares:
            by[fab] = by.get(fab, 0) + nb
        return out

    def ahead_of(k):
        return move(chunk_in[k], out_ax, 0, cols[k], rows_in, True, grad)

    with _trace.span(f"collective.{name}", cat="collective",
                     shape=tuple(b.shape), out_ax=out_ax, chunks=K,
                     n_shards=n):
        ahead = ahead_of(0)
        backs = []
        for k in range(K):
            tile = done(ahead)
            if k + 1 < K:
                ahead = ahead_of(k + 1)
            t = mid(tile)
            backs.append(move(t, 0, out_ax, rows_out, cols[k], False,
                              grad or _needs_grad(t)))
        out = [done(p) for p in backs]
    if n > 1:
        none = ([(0, "nvlink"), (0, "ib")] if groups is not None
                else [(0, _topo.group_fabric(group))])
        _count_shares(name, [(nb, f) for f, nb in by.items()] or none)
        steps[name] += K
    return torch.cat(out, dim=out_ax) if K > 1 else out[0]


# --------------------------------------------------------------------------
# The two-level layer (JAX ``parallel/collectives.py:700-945``): on a world
# laid out as D hosts of I ranks (``topology.hier_groups``), a collective
# over the world runs as one phase over the NVLink group (the ranks of
# this rank's host) and one over the IB group (its peers at the same place
# on the other hosts), so that the slow fabric carries fewer or larger
# messages. World rank ``r`` is ``(d, l) = divmod(r, I)``. Each call is
# counted once, under the JAX package's name, with the bytes this rank
# received in each phase charged to that phase's fabric.


def _hier(groups):
    """``groups`` (``(ib, nvlink, D, I)``) or the world's; raises where
    the world is not laid out hosts × ranks."""
    g = groups if groups is not None else _topo.hier_groups()
    if g is None:
        raise ValueError("the two-level collectives need a world laid out "
                         "as hosts x ranks (topology.world_shape); this "
                         "one is not")
    return g


def _row_bytes(t: torch.Tensor, axis: int) -> int:
    """Bytes of one slice of ``t`` along ``axis``."""
    return t.element_size() * int(np.prod(
        [v for k, v in enumerate(t.shape) if k != axis], dtype=np.int64))


def _hier_rs(t, sizes, axis, groups):
    """:func:`hier_reduce_scatter`'s transfer and count."""
    ib, nv, D, I = groups
    l = rank() % I
    pieces = torch.split(t, list(sizes), dim=axis)
    # NVLink-major order: place l' gathers the pieces of (·, l')
    t = torch.cat([pieces[dd * I + ll] for ll in range(I)
                   for dd in range(D)], dim=axis)
    s1 = [sum(int(sizes[dd * I + ll]) for dd in range(D)) for ll in range(I)]
    s2 = [int(sizes[dd * I + l]) for dd in range(D)]
    row = _row_bytes(t, axis)
    shares = [(row * padded_shard_size(s1) * (I - 1), "nvlink"),
              (row * padded_shard_size(s2) * (D - 1), "ib")]
    seq = _count_shares("hier_psum_scatter", shares)
    with _trace.span("collective.hier_psum_scatter", cat="collective",
                     seq=seq, bytes=sum(nb for nb, _ in shares)):
        t = _reduce_scatter(t, s1, axis, nv, None)
        return _reduce_scatter(t.contiguous(), s2, axis, ib, None)


def _hier_ag(t, sizes, axis, groups):
    """:func:`hier_all_gather`'s transfer and count."""
    ib, nv, D, I = groups
    d = rank() // I
    s1 = [int(sizes[d * I + ll]) for ll in range(I)]
    s2 = [sum(int(sizes[dd * I + ll]) for ll in range(I)) for dd in range(D)]
    row = _row_bytes(t, axis)
    shares = [(row * padded_shard_size(s1) * (I - 1), "nvlink"),
              (row * padded_shard_size(s2) * (D - 1), "ib")]
    seq = _count_shares("hier_all_gather", shares)
    with _trace.span("collective.hier_all_gather", cat="collective",
                     seq=seq, bytes=sum(nb for nb, _ in shares)):
        t = _all_gather(t, s1, axis, nv, None)
        return _all_gather(t, s2, axis, ib, None)


class _HierReduceScatter(torch.autograd.Function):
    """:func:`hier_reduce_scatter` with :func:`hier_all_gather` as its
    backward."""

    @staticmethod
    def forward(ctx, t, sizes, axis, groups):
        ctx.args = (sizes, axis, groups)
        return _hier_rs(t, sizes, axis, groups)

    @staticmethod
    def backward(ctx, g):
        return (_HierAllGather.apply(g.contiguous(), *ctx.args), None, None,
                None)


class _HierAllGather(torch.autograd.Function):
    """:func:`hier_all_gather` with :func:`hier_reduce_scatter` as its
    backward."""

    @staticmethod
    def forward(ctx, t, sizes, axis, groups):
        ctx.args = (sizes, axis, groups)
        return _hier_ag(t, sizes, axis, groups)

    @staticmethod
    def backward(ctx, g):
        return (_HierReduceScatter.apply(g.contiguous(), *ctx.args), None,
                None, None)


def hier_reduce_scatter(t: torch.Tensor, sizes: Sequence[int], axis: int = 0,
                        groups=None) -> torch.Tensor:
    """:func:`reduce_scatter` over the world in two levels (JAX
    ``hier_psum_scatter``, ``:886-916``): world rank ``q`` keeps
    ``sizes[q]`` entries of the sum along ``axis``. The pieces are put in
    NVLink-major order locally (JAX ``_hier_reorder``), reduce-scattered
    over the NVLink group (this rank keeps the partial of the pieces of
    every host's rank at its own place), then over the IB group on those
    partials, already ``1/I`` of the size: IB carries ``I`` times fewer
    bytes than the flat ring would push through it. The same sum in
    another order. Counted as one call of ``hier_psum_scatter``; under
    grad mode its backward is :func:`hier_all_gather`. ``groups`` is
    ``topology.hier_groups()`` by default; without a group ``t``."""
    if not initialized():
        return t
    groups = _hier(groups)
    sizes = tuple(int(v) for v in sizes)
    if _needs_grad(t):
        return _HierReduceScatter.apply(t, sizes, axis, groups)
    return _hier_rs(t, sizes, axis, groups)


def hier_all_gather(t: torch.Tensor, sizes: Sequence[int], axis: int = 0,
                    groups=None) -> torch.Tensor:
    """:func:`all_gather` over the world in two levels (JAX
    ``hier_all_gather``, ``:919-945``): the shards of this rank's host are
    gathered over the NVLink group, then the hosts' superblocks over the
    IB group (``I`` times fewer, larger IB messages). Bit for bit the flat
    gather. Counted as one call of ``hier_all_gather``; under grad mode
    its backward is :func:`hier_reduce_scatter`."""
    if not initialized():
        return t
    groups = _hier(groups)
    sizes = tuple(int(v) for v in sizes)
    if _needs_grad(t):
        return _HierAllGather.apply(t, sizes, axis, groups)
    return _hier_ag(t, sizes, axis, groups)


class _TwoLevelA2A:
    """The two phases of a pencil transpose over the world (module
    section comment), phase 1 posted at construction. Rank ``r`` is
    ``(a, c)`` in the phase-1 and phase-2 coordinates (``(l, d)`` NVLink
    first, ``(d, l)`` IB first). Phase 1 sends to its group's rank
    ``a'`` every piece bound for ``(a', ·)``, joined along ``send_ax``;
    phase 2 forwards to its group's rank ``c'`` the slices bound for
    ``(a, c')`` of every piece phase 1 brought, joined along
    ``recv_ax``. :meth:`wait` runs phase 2 and returns what the flat
    all-to-all gives, the pieces from every rank joined along
    ``recv_ax`` in rank order; :attr:`shares` the bytes of each phase by
    fabric."""

    def __init__(self, b, send_ax, recv_ax, send_sizes, recv_sizes, groups,
                 nvlink_first: bool):
        ib, nv, D, I = groups
        d, l = divmod(rank(), I)
        if nvlink_first:
            self.g1, self.g2, A, C, a, c = nv, ib, I, D, l, d

            def idx(aa, cc):
                return cc * I + aa
        else:
            self.g1, self.g2, A, C, a, c = ib, nv, D, I, d, l

            def idx(aa, cc):
                return aa * I + cc
        self.fab = ("nvlink", "ib") if nvlink_first else ("ib", "nvlink")
        self.idx, self.A, self.C, self.c = idx, A, C, c
        self.send_ax, self.recv_ax = send_ax, recv_ax
        self.send_sizes = [int(v) for v in send_sizes]
        self.recv_sizes = [int(v) for v in recv_sizes]
        pieces = torch.split(b, self.send_sizes, dim=send_ax)
        sends = [torch.cat([pieces[idx(aa, cc)] for cc in range(C)],
                           dim=send_ax) for aa in range(A)]
        self.seg = [self.send_sizes[idx(a, cc)] for cc in range(C)]
        shapes = []
        for aa in range(A):
            shp = list(b.shape)
            shp[send_ax] = sum(self.seg)
            shp[recv_ax] = self.recv_sizes[idx(aa, c)]
            shapes.append(tuple(shp))
        self._p1 = _PostedA2A(sends, shapes, self.g1)
        self.shares = []

    def wait(self) -> torch.Tensor:
        A, C, idx = self.A, self.C, self.idx
        got = self._p1.wait()
        self.shares.append((self._p1.nbytes, self.fab[0]))
        cut = [torch.split(t, self.seg, dim=self.send_ax) for t in got]
        sends = [torch.cat([cut[aa][cc] for aa in range(A)],
                           dim=self.recv_ax) for cc in range(C)]
        shapes = []
        for cc in range(C):
            shp = list(got[0].shape)
            shp[self.send_ax] = self.seg[self.c]
            shp[self.recv_ax] = sum(self.recv_sizes[idx(aa, cc)]
                                    for aa in range(A))
            shapes.append(tuple(shp))
        p2 = _PostedA2A(sends, shapes, self.g2)
        got = p2.wait()
        self.shares.append((p2.nbytes, self.fab[1]))
        blocks = {}
        for cc, t in enumerate(got):
            parts = torch.split(t, [self.recv_sizes[idx(aa, cc)]
                                    for aa in range(A)], dim=self.recv_ax)
            for aa, p in enumerate(parts):
                blocks[idx(aa, cc)] = p
        return torch.cat([blocks[q] for q in range(A * C)], dim=self.recv_ax)


def _hier_transpose(name, b, send_ax, recv_ax, send_sizes, recv_sizes,
                    groups, forward) -> torch.Tensor:
    """One counted two-level transpose (:func:`hier_pencil_transpose`)."""
    with _trace.span(f"collective.{name}", cat="collective",
                     shape=tuple(b.shape), send_ax=send_ax, recv_ax=recv_ax,
                     forward=forward):
        p = _TwoLevelA2A(b, send_ax, recv_ax, send_sizes, recv_sizes,
                         groups, forward)
        out = p.wait()
    _count_shares(name, p.shares)
    return out


class _HierTranspose(torch.autograd.Function):
    """:func:`hier_pencil_transpose` whose backward is the transpose of
    the cotangent with the axes, sizes and phase order swapped, counted
    as ``hier_pencil_transpose_adjoint``."""

    @staticmethod
    def forward(ctx, b, send_ax, recv_ax, send_sizes, recv_sizes, groups,
                forward):
        ctx.args = (send_ax, recv_ax, send_sizes, recv_sizes, groups,
                    forward)
        return _hier_transpose("hier_pencil_transpose", b, send_ax, recv_ax,
                               send_sizes, recv_sizes, groups, forward)

    @staticmethod
    def backward(ctx, g):
        send_ax, recv_ax, send_sizes, recv_sizes, groups, forward = ctx.args
        back = _hier_transpose("hier_pencil_transpose_adjoint",
                               g.contiguous(), recv_ax, send_ax, recv_sizes,
                               send_sizes, groups, not forward)
        return back, None, None, None, None, None, None


def hier_pencil_transpose(b: torch.Tensor, send_ax: int, recv_ax: int,
                          send_sizes: Sequence[int],
                          recv_sizes: Sequence[int], forward: bool = True,
                          groups=None) -> torch.Tensor:
    """The pencil transpose over the world in two levels (JAX
    ``hier_pencil_transpose``, ``:729-776``): ``b``'s ``send_ax`` is cut
    into ``send_sizes`` pieces, one for each world rank, and the pieces
    from every rank (``recv_sizes[q]`` long along ``recv_ax``) are
    joined along ``recv_ax``, bit for bit the flat transpose's (the FFT's
    ``_pencil_transpose``). ``forward`` runs an ``all_to_all`` over the
    NVLink group, then one over the IB group; ``forward=False`` (the
    transpose back) the IB phase first. The pieces keep their exact,
    possibly ragged, sizes: phase 1 sends to each NVLink peer ``l'`` (IB
    peer ``d'``) every piece bound for its place (its host), phase 2
    forwards each piece to its owner, and the receive shapes come from
    the same size tables. Each rank's IB bytes fall from ``(n - I)/n`` of
    its block (the flat all-to-all's share bound off its host) to ``(D -
    1)/D``. Counted as one call of ``hier_pencil_transpose`` with both
    phases' bytes by fabric; under grad mode its backward is the
    transpose back (``hier_pencil_transpose_adjoint``)."""
    if not initialized():
        return b
    groups = _hier(groups)
    send_sizes = tuple(int(v) for v in send_sizes)
    recv_sizes = tuple(int(v) for v in recv_sizes)
    if _needs_grad(b):
        return _HierTranspose.apply(b, send_ax, recv_ax, send_sizes,
                                    recv_sizes, groups, bool(forward))
    return _hier_transpose("hier_pencil_transpose", b, send_ax, recv_ax,
                           send_sizes, recv_sizes, groups, bool(forward))
