"""Least-squares (Kirchhoff) migration.

PyTorch counterpart of ``pylops_mpi_tpu/models/lsm.py``, the analog of
the reference's ``tutorials/lsm.py``: each rank builds a Kirchhoff
demigration for its batch of sources, and the batches are stacked with
``MPIVStack`` (model BROADCAST, data SCATTER over sources, adjoint
summed over the ranks). Travel times are straight rays in a
constant-velocity medium, amplitudes the geometrical spreading
``1/sqrt(d_s d_r)``.

The JAX package sprays with a one-hot contraction per trace, which is
O(pairs · pixels · nt); here the forward is a scatter-add
(``index_add_``) of ``amp · m`` onto each trace's travel-time samples
and the adjoint a gather (``index_select``) weighted by ``conj(amp)``
and summed over the traces. Both work through the tables in chunks of
traces, so no ``(pairs, pixels)`` temporary is made per apply.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..distributedarray import DistributedArray, Partition
from ..ops._precision import as_torch_dtype
from ..ops.blockdiag import _chunk_ops
from ..ops.local import Conv1D, LocalOperator, ShapeOnly, _tensor
from ..ops.stack import MPIVStack
from ..parallel.mesh import (DeviceLike, check_mesh, rank, resolve_device,
                             world_size)
from ..solvers.basic import cgls

__all__ = ["TravelTimeSpray", "KirchhoffDemigration", "MPILSM", "lsm"]

# entries of the (traces × pixels) chunk an apply or the table build
# works on at a time
_CHUNK = 1 << 25


class TravelTimeSpray(LocalOperator):
    """Spray image-point amplitudes onto the travel-time samples of
    source–receiver traces: ``y[p, itrav[p, i]] += amp[p, i] · m[i]``
    (JAX package ``models/lsm.py:44-78``). Entries with ``itrav >= nt``
    carry ``amp = 0`` and index 0, as in the JAX package.

    ``itrav`` (``(npairs, npix)``) and ``amp`` are tensors (kept on their
    device) or arrays (placed on ``device``, default ``"cuda"``). The
    operator keeps ``amp`` at ``dtype`` and, in place of ``itrav``, the
    flat sample index ``index = p · nt + itrav`` (int32 below 2^31
    samples), both contiguous: an apply then indexes the flat data with
    the table as it is. ``itrav`` is recovered from it on request.

    On a CUDA device the forward's ``index_add_`` adds with atomics in
    no fixed order, so two forward applies of the same model may differ
    in the last bits; the adjoint (a gather and fixed-order sums) gives
    the same bits every time."""

    def __init__(self, itrav, amp, nt: int, dtype=torch.float32,
                 device: DeviceLike = None):
        itrav = _tensor(itrav, device)
        amp = _tensor(amp, itrav.device)
        valid = itrav < nt
        rows = torch.arange(itrav.shape[0], device=itrav.device)[:, None]
        self._set_tables(torch.where(valid, itrav, 0) + rows * int(nt),
                         torch.where(valid, amp, 0), nt, dtype)

    def _set_tables(self, index, amp, nt, dtype):
        npairs, npix = index.shape
        self.nt = int(nt)
        self.index = index.to(_index_dtype(npairs, nt)).contiguous()
        self.amp = amp.to(as_torch_dtype(dtype)).contiguous()
        LocalOperator.__init__(self, dims=npix, dimsd=(npairs, nt),
                               dtype=dtype)

    @classmethod
    def _from_tables(cls, index, amp, nt, dtype) -> "TravelTimeSpray":
        """A spray over a flat index table and amplitudes already masked
        (``amp`` 0 where the JAX package drops the entry)."""
        op = cls.__new__(cls)
        op._set_tables(index, amp, nt, dtype)
        return op

    @property
    def itrav(self) -> torch.Tensor:
        """The travel-time sample of each entry, int32 (0 where dropped)."""
        rows = torch.arange(self.index.shape[0], device=self.index.device)
        return (self.index - rows[:, None] * self.nt).to(torch.int32)

    def _chunks(self):
        """``(rows, flat sample index of each entry)`` per chunk of
        traces."""
        npairs, npix = self.index.shape
        step = max(1, _CHUNK // npix)
        for p0 in range(0, npairs, step):
            rows = slice(p0, min(p0 + step, npairs))
            yield rows, self.index[rows].view(-1)

    def _matvec(self, x):
        dt = torch.promote_types(self.amp.dtype, x.dtype)
        x = x.to(dt)
        y = x.new_zeros(self.shape[0])
        for rows, idx in self._chunks():
            y.index_add_(0, idx, (self.amp[rows] * x).view(-1))
        return y

    def _rmatvec(self, x):
        dt = torch.promote_types(self.amp.dtype, x.dtype)
        x = x.to(dt)
        out = x.new_zeros(self.shape[1])
        for rows, idx in self._chunks():
            picked = x.index_select(0, idx).view(-1, self.shape[1])
            out += torch.linalg.vecdot(self.amp[rows].to(dt), picked, dim=0)
        return out


def _index_dtype(npairs: int, nt: int) -> torch.dtype:
    """int32 flat sample indices while the data has fewer than 2^31
    samples, int64 beyond."""
    return torch.int32 if npairs * nt < 2 ** 31 else torch.int64


def _sqrt(v: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root, as numpy's: CUDA's f64 ``sqrt`` is;
    on the CPU ``torch.sqrt`` goes through a vector math library that
    can be an ulp off, so numpy computes it there."""
    if v.device.type == "cpu":
        return torch.from_numpy(np.sqrt(v.numpy()))
    return torch.sqrt(v)


def _straight_ray(points: torch.Tensor, pix: torch.Tensor,
                  vel: torch.Tensor):
    """``(npts, npix)`` travel time and distance of straight rays in a
    constant-velocity medium, with the JAX package's f64 arithmetic
    (``d = sqrt(dx² + dz²)``, ``t = d / vel``); ``vel`` is a 0-d tensor,
    because CUDA divides by a host scalar as a product with its
    reciprocal."""
    dx = points[:, None, 0] - pix[None, :, 0]
    dz = points[:, None, 1] - pix[None, :, 1]
    d = _sqrt(dx * dx + dz * dz)
    return d / vel, d


def KirchhoffDemigration(z, x, t, sources, recs, vel: float, wav,
                         wavcenter: int, dtype=torch.float32,
                         device: DeviceLike = None) -> LocalOperator:
    """Kirchhoff demigration ``d(s, r, t) = w(t) * Σ_x a(x) m(x)
    δ(t − t_s(x) − t_r(x))`` for one batch of sources (JAX package
    ``models/lsm.py:81-107``): ``Conv1D(wav) * TravelTimeSpray``.

    The tables are built on ``device`` (default ``"cuda"``) a few
    sources at a time, with the JAX package's f64 arithmetic: straight-
    ray times and distances, ``itrav = round(ttot / dt)`` (half to
    even, as numpy's ``rint``) and ``amp = 1 / sqrt(d_s d_r + 1e-10)``,
    so they equal the JAX package's bit for bit; the spray keeps
    ``itrav`` as its flat sample index. The host never holds the
    ``(ns, nr, npix)`` cubes."""
    dev = resolve_device(device)
    dtype = as_torch_dtype(dtype)
    f64 = torch.float64
    zz, xx = np.meshgrid(z, x, indexing="ij")
    pix = torch.from_numpy(np.stack([xx.ravel(), zz.ravel()], axis=1)
                           .astype(float)).to(dev)
    srcs = torch.from_numpy(np.asarray(sources, dtype=float).T.copy()).to(dev)
    rcvs = torch.from_numpy(np.asarray(recs, dtype=float).T.copy()).to(dev)
    nt = len(t)
    dt = torch.tensor(float(t[1] - t[0]), dtype=f64, device=dev)
    velt = torch.tensor(float(vel), dtype=f64, device=dev)
    one = torch.ones((), dtype=f64, device=dev)
    ns, nr, npix = srcs.shape[0], rcvs.shape[0], pix.shape[0]
    tr, dr = _straight_ray(rcvs, pix, velt)
    index = torch.empty((ns * nr, npix), dtype=_index_dtype(ns * nr, nt),
                        device=dev)
    amp = torch.empty((ns * nr, npix), dtype=dtype, device=dev)
    # the first sample of each of a source's nr traces in the flat data
    first = (torch.arange(nr, dtype=f64, device=dev) * nt)[:, None]
    step = max(1, _CHUNK // (nr * npix))
    for s0 in range(0, ns, step):
        s1 = min(s0 + step, ns)
        ts, ds = _straight_ray(srcs[s0:s1], pix, velt)
        it = torch.round((ts[:, None, :] + tr[None, :, :]) / dt)
        a = one / _sqrt(ds[:, None, :] * dr[None, :, :] + 1e-10)
        valid = it < nt
        rows = slice(s0 * nr, s1 * nr)
        base = (torch.arange(s0, s1, dtype=f64, device=dev)
                * (nr * nt))[:, None, None]
        index[rows] = (torch.where(valid, it, 0) + first + base).view(-1, npix)
        amp[rows] = torch.where(valid, a, 0).view(-1, npix)
    spray = TravelTimeSpray._from_tables(index, amp, nt, dtype)
    conv = Conv1D(spray.dimsd, _tensor(wav, dev).to(dtype), axis=-1,
                  offset=wavcenter, dtype=dtype)
    return conv * spray


def MPILSM(z, x, t, sources, recs, vel: float, wav, wavcenter: int,
           mesh=None, dtype=torch.float32, *,
           device: DeviceLike = None) -> MPIVStack:
    """Distributed LSM operator (JAX package ``models/lsm.py:110-124``):
    the sources split over the ranks (``np.array_split``), one Kirchhoff
    demigration per batch, stacked with :class:`MPIVStack`. Each rank
    builds the travel-time tables of its own batch only; the other
    batches enter the stack by their shapes. ``mesh`` keeps the JAX
    package's argument order and must describe the process group."""
    check_mesh(mesh)
    dtype = as_torch_dtype(dtype)
    sources = np.asarray(sources, dtype=float)
    nr, nt, npix = np.shape(recs)[1], len(t), len(z) * len(x)
    chunks = [c for c in np.array_split(np.arange(sources.shape[1]),
                                        world_size()) if len(c)]
    # batch i is rank i's (MPIVStack's chunks of one row each)
    mine = _chunk_ops(list(range(len(chunks))), world_size())[rank()]
    return MPIVStack([KirchhoffDemigration(z, x, t, sources[:, c], recs, vel,
                                           wav, wavcenter, dtype=dtype,
                                           device=device)
                      if i in mine else
                      ShapeOnly(npix, (len(c) * nr, nt), dtype=dtype)
                      for i, c in enumerate(chunks)])


def lsm(z, x, t, sources, recs, vel: float, wav, wavcenter: int,
        refl: np.ndarray, niter: int = 20, mesh=None, dtype=torch.float32,
        *, device: DeviceLike = None
        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Model data from ``refl`` and invert it with CGLS (JAX package
    ``models/lsm.py:127-140``). Returns ``(minv, d, cost)`` as numpy
    arrays on every rank, ``minv`` on the ``(nz, nx)`` grid and ``d``
    gathered."""
    dev = resolve_device(device)
    dtype = as_torch_dtype(dtype)
    Op = MPILSM(z, x, t, sources, recs, vel, wav, wavcenter, mesh, dtype,
                device=dev)
    m = DistributedArray.to_dist(
        torch.from_numpy(np.asarray(refl).ravel()).to(dev, dtype),
        partition=Partition.BROADCAST)
    d = Op.matvec(m)
    x0 = DistributedArray(global_shape=Op.shape[1],
                          partition=Partition.BROADCAST, dtype=dtype,
                          device=dev)
    out = cgls(Op, d, x0=x0, niter=niter, tol=0.0)
    minv, cost = out[0], out[5]
    return (minv.asarray().reshape(len(z), len(x)), d.asarray(),
            cost.cpu().numpy())
