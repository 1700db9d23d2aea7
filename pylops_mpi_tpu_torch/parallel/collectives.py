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
plain path).

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

from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..diagnostics import metrics as _metrics
from ..diagnostics import trace as _trace
from . import topology as _topo
from .mesh import initialized, rank, world_size
from .partition import padded_shard_size

__all__ = ["counts", "received", "reset_counts", "mask_group",
           "rank_group", "forget_groups", "all_reduce", "all_gather",
           "reduce_scatter", "all_to_all", "exchange", "count_metrics",
           "halo_exchange", "cart_halo_extend", "broadcast", "replicated",
           "reduce_stall", "stall_signature"]

# collective calls under a group, and the bytes this rank received in
# them, since the last reset_counts()
counts: Counter = Counter()
received: Counter = Counter()

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}

# mask (tuple of colors, one per rank) -> this rank's sub-group
_GROUPS: Dict[tuple, object] = {}


# per-name sequence numbers of the calls, for the event tags
_SEQ: Counter = Counter()


def reset_counts() -> None:
    counts.clear()
    received.clear()


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
    as ranks of the default group; empty tensors travel nowhere."""
    ops = [dist.P2POp(dist.isend, t, peer, group)
           for t, peer in sends if t.numel()]
    ops += [dist.P2POp(dist.irecv, t, peer, group)
            for t, peer in recvs if t.numel()]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


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


def _all_to_all(name: str, sends, recv_shapes, group) -> List[torch.Tensor]:
    me = _group_rank(group)

    def peer(q):
        return dist.get_global_rank(group, q) if group is not None else q

    like = sends[me]
    stage = like.is_cuda and _gloo(group)
    dev = torch.device("cpu") if stage else like.device
    out = [torch.empty(tuple(s), dtype=like.dtype, device=dev)
           for s in recv_shapes]
    tx = [(s.contiguous().cpu() if stage else s.contiguous(), peer(q))
          for q, s in enumerate(sends) if q != me]
    rx = [(out[q], peer(q)) for q in range(len(recv_shapes)) if q != me]
    nb = sum(_nbytes(t) for t, _ in rx)
    with _span(name, nb, group):
        _p2p(tx, rx, group)
    out = [o.to(like.device) for o in out] if stage else out
    out[me] = like
    return out


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


def _exchange(name: str, block: torch.Tensor, axis: int, front: int,
              back: int, prev: Optional[int], nxt: Optional[int],
              event: Optional[dict] = None) -> Tuple[Piece, Piece]:
    """The neighbour exchange along ``axis`` of ``block``: receive the
    ``prev`` rank's last ``front`` slices and the ``nxt`` rank's first
    ``back`` ones, and send this rank's to them, as one
    ``batch_isend_irecv``. ``prev``/``nxt`` are ``None`` past the ends;
    there the piece is a count of (zero) slices instead of a tensor.
    Slabs along an axis other than 0 go as contiguous copies. The call
    is counted as ``name``, under a span, or, given ``event`` (the
    Cartesian exchange's tags), with a ``collective.<name>`` event."""
    shape = list(block.shape)
    stage = block.is_cuda and _gloo(None)
    dev = torch.device("cpu") if stage else block.device

    def out(n):
        shape[axis] = n
        return torch.empty(shape, dtype=block.dtype, device=dev)

    def send(t):
        t = t.contiguous()
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
    _transfer(name, sends, recvs, event)
    if stage:
        top = top.to(block.device) if isinstance(top, torch.Tensor) else top
        bottom = (bottom.to(block.device) if isinstance(bottom, torch.Tensor)
                  else bottom)
    return top, bottom


def _transfer(name: str, sends, recvs, event: Optional[dict]) -> None:
    """One counted neighbour step: under the ``collective.<name>`` span,
    or counted and recorded as an event with ``event``'s tags."""
    nb = sum(_nbytes(t) for t, _ in recvs)
    if event is None:
        with _span(name, nb):
            _p2p(sends, recvs, None)
        return
    seq = _count(name, nb)
    _p2p(sends, recvs, None)
    _trace.event(f"collective.{name}", cat="collective", seq=seq, **event)


def halo_exchange(block: torch.Tensor, front: int,
                  back: int) -> Tuple[Piece, Piece]:
    """Ghost rows of ``block`` (axis 0) from the neighbouring ranks: the
    previous rank's last ``front`` rows and the next rank's first
    ``back`` rows, posted as one ``batch_isend_irecv`` with both
    neighbours. Returns the pieces ``(top, bottom)``: contiguous received
    tensors, or row counts (of zeros) at the ends of the world. No
    concatenated slab is built; the tap kernel takes the pieces as they
    are.

    The counterpart of the JAX package's ``halo_slab``. Its relocation
    of the back ghost after a ragged shard's last valid row has nothing
    to do here: a rank's shard is a tensor of its exact size, not a
    padded block. A rank sends its last ``front`` rows forward and its
    first ``back`` rows back, so it must hold that many."""
    if not initialized():
        return front, back
    P, r = world_size(), rank()
    rows = int(block.shape[0])
    if rows < max(front if r < P - 1 else 0, back if r > 0 else 0):
        raise ValueError(f"rank {r} holds {rows} rows, fewer than the "
                         f"ghost widths ({front}, {back}) it sends")
    prev = r - 1 if r > 0 else None
    nxt = r + 1 if r < P - 1 else None
    return _neighbours("halo_exchange", block, 0, front, back, prev, nxt)


def _neighbours(name: str, block: torch.Tensor, axis: int, front: int,
                back: int, prev: Optional[int], nxt: Optional[int],
                event: Optional[dict] = None) -> Tuple[Piece, Piece]:
    """:func:`_exchange`, through :class:`_NeighbourExchange` under grad
    mode."""
    if not _needs_grad(block):
        return _exchange(name, block, axis, front, back, prev, nxt, event)
    top, bottom = _NeighbourExchange.apply(block, name, axis, front, back,
                                           prev, nxt, event)
    # absent pieces travel through the Function as empty tensors
    return (top if prev is not None and front else front,
            bottom if nxt is not None and back else back)


class _NeighbourExchange(torch.autograd.Function):
    """The neighbour exchange of :func:`_exchange` whose backward sends
    each received ghost's cotangent back to the rank that owns those
    slices, which adds it to its edge slices: the previous rank's last
    ``front`` and the next rank's first ``back`` along ``axis``. Counted
    as ``<name>_adjoint`` (with its event for the Cartesian exchange).
    Absent pieces are empty tensors."""

    @staticmethod
    def forward(ctx, block, name, axis, front, back, prev, nxt, event):
        top, bottom = _exchange(name, block, axis, front, back, prev, nxt,
                                event)
        ctx.meta = (name, axis, front, back, prev, nxt, event,
                    tuple(block.shape))

        def piece(p):
            if isinstance(p, torch.Tensor):
                return p
            return block.new_empty(block.shape[:axis] + (0,)
                                   + block.shape[axis + 1:])
        return piece(top), piece(bottom)

    @staticmethod
    def backward(ctx, gtop, gbottom):
        # the forward's exchange reversed: the ghosts' cotangents, joined,
        # leave as a block's edge slices (gtop to prev, gbottom to nxt),
        # and the cotangents of this rank's own edges arrive in their place
        name, axis, front, back, prev, nxt, event, shape = ctx.meta
        first, last = _exchange(f"{name}_adjoint",
                                torch.cat([gtop, gbottom], dim=axis), axis,
                                back, front, prev, nxt, event)
        grad = gtop.new_zeros(shape)
        if isinstance(first, torch.Tensor):
            grad.narrow(axis, 0, back).add_(first)
        if isinstance(last, torch.Tensor):
            grad.narrow(axis, shape[axis] - front, front).add_(last)
        return grad, None, None, None, None, None, None, None


def cart_halo_extend(block: torch.Tensor, grid: Sequence[int], ax: int,
                     hm: int, hp: int) -> torch.Tensor:
    """``block`` extended along axis ``ax`` with ``hm`` ghost slices from
    its minus neighbour on the Cartesian ``grid`` and ``hp`` from its plus
    neighbour, zeros past the grid's ends (the plain path of the JAX
    package's ``cart_halo_extend``). The ranks map onto ``grid`` row-major,
    so the neighbours along ``ax`` are ``rank ∓ prod(grid[ax + 1:])``.
    Called once per axis in turn, each call sends slabs of the block the
    earlier calls extended, which relays the corner values. Along an axis
    of one rank, or without a group, the ghosts are zeros and nothing
    moves; a call that moves nothing is not counted. A call that moves
    records the ``collective.cart_halo_extend`` event (JAX ``:338``; its
    ``axis`` tag, a mesh axis name, is ``None`` here). Under grad mode
    the ghosts' cotangents go back to their owners (module docstring)."""
    if not hm and not hp:
        return block
    grid = tuple(int(g) for g in grid)
    pieces: Tuple[Piece, Piece] = (hm, hp)
    if initialized() and grid[ax] > 1:
        if int(np.prod(grid)) != world_size():
            raise ValueError(f"grid {grid} does not match the world of "
                             f"{world_size()} ranks")
        r = rank()
        coord = int(np.unravel_index(r, grid)[ax])
        stride = int(np.prod(grid[ax + 1:]))
        pieces = _neighbours(
            "cart_halo_extend", block, ax, hm, hp,
            r - stride if coord > 0 else None,
            r + stride if coord < grid[ax] - 1 else None,
            dict(shape=tuple(block.shape), dtype=block.dtype, axis=None,
                 grid=grid, ax=ax, hm=hm, hp=hp))
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
