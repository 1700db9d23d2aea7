"""Collectives over the process group.

PyTorch counterpart of the parts of ``pylops_mpi_tpu/parallel/collectives.py``
the sharded arrays and operators use: reductions of solver scalars
(:func:`all_reduce`), gathers of ragged shards (:func:`all_gather`),
the all-to-all of a change of sharded axis (:func:`all_to_all`), and the
neighbour exchange of stencil ghost rows (:func:`halo_exchange`, the
counterpart of ``halo_slab``).

Every function is called at every world size, one included: under a
group of one rank on the card the reductions still go through NCCL.
Without a process group they return at once and communicate nothing.
Each call under a group adds one to ``counts[name]`` (the counterpart of
the JAX package's ``_count_collective``), which tests and
``chip_smoke.py`` read.

gloo moves CPU tensors only for point-to-point sends and gathers. Under
a gloo group, CUDA tensors are staged through host copies: this is
transport, the arithmetic around it stays on the tensors' device.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from .mesh import initialized, rank, world_size
from .partition import padded_shard_size

__all__ = ["counts", "reset_counts", "mask_group", "forget_groups",
           "all_reduce", "all_gather", "all_to_all", "halo_exchange"]

# collective calls under a group since the last reset_counts()
counts: Counter = Counter()

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}

# mask (tuple of colors, one per rank) -> this rank's sub-group
_GROUPS: Dict[tuple, object] = {}


def reset_counts() -> None:
    counts.clear()


def forget_groups() -> None:
    """Drop the cached mask sub-groups (their default group ended)."""
    _GROUPS.clear()


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


def all_reduce(t: torch.Tensor, op: str = "sum",
               group: Optional[object] = None) -> torch.Tensor:
    """``op`` (``"sum"``, ``"max"``, ``"min"``) of a 0-d or 1-d tensor
    over the group (the whole world for ``None``), in place; returns
    ``t``."""
    if not initialized():
        return t
    counts["all_reduce"] += 1
    if t.ndim > 1:
        raise ValueError(f"all_reduce takes 0-d or 1-d tensors, got "
                         f"{tuple(t.shape)}")
    if t.is_cuda and _gloo(group):
        host = t.cpu()
        dist.all_reduce(host, op=_OPS[op], group=group)
        return t.copy_(host)
    dist.all_reduce(t, op=_OPS[op], group=group)
    return t


def all_gather(t: torch.Tensor, sizes: Sequence[int], axis: int = 0,
               group: Optional[object] = None) -> torch.Tensor:
    """The shards of every rank joined along ``axis``: rank ``p`` holds
    ``sizes[p]`` entries along ``axis``. Ragged shards are padded to the
    largest (NCCL moves equal sizes), gathered, and unpadded."""
    if not initialized():
        return t
    counts["all_gather"] += 1
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


def all_to_all(sends: Sequence[torch.Tensor],
               recv_shapes: Sequence[Tuple[int, ...]],
               group: Optional[object] = None) -> List[torch.Tensor]:
    """Rank ``p`` sends ``sends[q]`` to every rank ``q`` and receives a
    tensor of ``recv_shapes[q]`` from each (sizes may differ, which
    gloo's own ``all_to_all`` refuses): point-to-point pairs in one
    batch, this rank's own piece copied locally."""
    if not initialized():
        return [sends[0]]
    counts["all_to_all"] += 1
    me = rank()
    like = sends[me]
    stage = like.is_cuda and _gloo(group)
    dev = torch.device("cpu") if stage else like.device
    out = [torch.empty(tuple(s), dtype=like.dtype, device=dev)
           for s in recv_shapes]
    tx = [(s.contiguous().cpu() if stage else s.contiguous(), q)
          for q, s in enumerate(sends) if q != me]
    rx = [(out[q], q) for q in range(len(recv_shapes)) if q != me]
    _p2p(tx, rx, group)
    out = [o.to(like.device) for o in out] if stage else out
    out[me] = like
    return out


Piece = Union[int, torch.Tensor]


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
    counts["halo_exchange"] += 1
    P, r = world_size(), rank()
    rows = int(block.shape[0])
    if rows < max(front if r < P - 1 else 0, back if r > 0 else 0):
        raise ValueError(f"rank {r} holds {rows} rows, fewer than the "
                         f"ghost widths ({front}, {back}) it sends")
    tail = tuple(block.shape[1:])
    stage = block.is_cuda and _gloo(None)
    dev = torch.device("cpu") if stage else block.device

    def out(n):
        return torch.empty((n,) + tail, dtype=block.dtype, device=dev)

    def send(t):
        t = t.contiguous()
        return t.cpu() if stage else t

    top = out(front) if r > 0 and front else front
    bottom = out(back) if r < P - 1 and back else back
    sends, recvs = [], []
    if r > 0:
        if back:
            sends.append((send(block[:back]), r - 1))
        if front:
            recvs.append((top, r - 1))
    if r < P - 1:
        if front:
            sends.append((send(block[rows - front:]), r + 1))
        if back:
            recvs.append((bottom, r + 1))
    _p2p(sends, recvs, None)
    if stage:
        top = top.to(block.device) if isinstance(top, torch.Tensor) else top
        bottom = (bottom.to(block.device) if isinstance(bottom, torch.Tensor)
                  else bottom)
    return top, bottom
