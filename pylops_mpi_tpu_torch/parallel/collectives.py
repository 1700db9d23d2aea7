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
plain path), and the pipelined layer of the overlap schedules
(:func:`ring_pass`, :func:`ring_reduce_scatter`, :func:`ring_halo_ghosts`,
:func:`post_cart_halo`, :func:`resolve_chunks`,
:func:`chunked_pencil_transpose`: transfers posted before the compute
that does not need them, waited on where their data is read; their
steps, ring hops and pencil chunks, land in :data:`steps`).

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
host and ``.bytes_ib`` when it crosses hosts (the world group does); a
flat world adds no counter.

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
           "post_cart_halo", "resolve_chunks", "chunked_pencil_transpose"]

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
    counts[name] += 1
    received[name] += nbytes
    return count_metrics(name, [(nbytes, _topo.group_fabric(group))])


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
                group) -> torch.Tensor:
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
    with _span("all_gather", nb, group):
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
                    group) -> torch.Tensor:
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
    with _span("reduce_scatter", nb, group):
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
                 last: bool, hops: int):
        self.name, self.to, self.frm, self.group = name, to, frm, group
        self.last, self.hops = last, hops
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
            _count(name, sum(_nbytes(b) for b in rx) * hop.hops, hop.group)
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


def ring_pass(block, body: Callable, init=None, shift: int = 1,
              group: Optional[object] = None):
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
    and nothing moves or is counted."""
    tup = isinstance(block, (tuple, list))
    blocks = tuple(block) if tup else (block,)
    n, i, to, frm = _ring_peers(group, shift)
    if n == 1:
        return body(init, block, i, 0)
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
        self.seq = _count(name, self.nbytes)
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
    rank order, this rank's own the piece it kept."""

    def __init__(self, sends, recv_shapes, group):
        self.out, tx, rx, self.stage = _a2a_buffers(sends, recv_shapes,
                                                    group)
        self.nbytes = sum(_nbytes(t) for t, _ in rx)
        self._posted = _Posted(tx, rx, group)
        self.sends, self.group = sends, group

    def wait(self) -> List[torch.Tensor]:
        self._posted.wait()
        return _a2a_result(self.out, self.sends, self.group, self.stage)


def chunked_pencil_transpose(b: torch.Tensor, out_ax: int, chunks: int,
                             mid: Callable[[torch.Tensor], torch.Tensor],
                             rows_in: Sequence[int],
                             rows_out: Sequence[int],
                             group: Optional[object] = None) -> torch.Tensor:
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
    posted ahead. ``chunks`` must fit (:func:`resolve_chunks`)."""
    K = int(chunks)
    n = _group_size(group) if initialized() else 1
    me = _group_rank(group) if initialized() else 0
    widths = _split_sizes(b.shape[out_ax], K)
    if min(widths) < n:
        raise ValueError(f"chunked_pencil_transpose: {K} chunks of an axis "
                         f"of {b.shape[out_ax]} leave a chunk narrower than "
                         f"the {n} ranks (resolve_chunks caps the count)")
    chunk_in = torch.split(b, widths, dim=out_ax)
    cols = [_split_sizes(w, n) for w in widths]
    grad = _needs_grad(b)
    nb = 0

    def forward(k):
        sends = list(torch.split(chunk_in[k], cols[k], dim=out_ax))
        shapes = _a2a_shapes(chunk_in[k], out_ax, cols[k][me], 0, rows_in)
        if grad or n == 1:
            return all_to_all(sends, shapes, group)
        return _PostedA2A(sends, shapes, group)

    def backward(k, t):
        sends = list(torch.split(t, list(rows_out), dim=0))
        shapes = _a2a_shapes(t, 0, rows_out[me], out_ax, cols[k])
        if grad or _needs_grad(t) or n == 1:
            return all_to_all(sends, shapes, group)
        return _PostedA2A(sends, shapes, group)

    def done(p):
        nonlocal nb
        if isinstance(p, _PostedA2A):
            nb += p.nbytes
            return p.wait()
        return p

    with _trace.span("collective.chunked_pencil_transpose", cat="collective",
                     shape=tuple(b.shape), out_ax=out_ax, chunks=K,
                     n_shards=n):
        ahead = forward(0)
        backs = []
        for k in range(K):
            tile = torch.cat(done(ahead), dim=0)
            if k + 1 < K:
                ahead = forward(k + 1)
            backs.append(backward(k, mid(tile)))
        out = [torch.cat(done(p), dim=out_ax) for p in backs]
    if n > 1:
        _count("chunked_pencil_transpose", nb, group)
        steps["chunked_pencil_transpose"] += K
    return torch.cat(out, dim=out_ax) if K > 1 else out[0]
