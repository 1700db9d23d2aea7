"""Distributed N-D FFTs by pencil decomposition.

PyTorch counterpart of ``pylops_mpi_tpu/ops/fft.py`` (the reference's
``pylops_mpi/signalprocessing/FFTND.py``, ``FFT2D.py`` and
``_baseffts.py``), complex engine: pylops' conventions (unnormalized
forward and ``N·ifft`` adjoint for ``norm="none"``, a ``1/N``-scaled
pair for ``"1/n"``, the √2 scaling of the positive non-Nyquist bins for
``real=True``, per-axis ``ifftshift_before``/``fftshift_after``).

Two paths, as in the JAX package:

- **aligned** (the input sharded on axis 0, ``ndim > 1``): the flat
  model and data vectors carry the row-aligned splits
  ``model_local_shapes``/``data_local_shapes`` (each rank whole rows of
  the cube, :func:`~..parallel.partition.flat_outer_shapes`), so the
  flat ↔ cube conversions are per-rank reshapes. Each rank transforms
  its rows along the local axes, one ``all_to_all`` transposes the
  pencils so axis 0 is local (this rank gets every row of its chunk of
  the next axis), axis 0 is transformed with its shifts, and a second
  ``all_to_all`` transposes back to whole rows of the data. The pieces
  travel point-to-point at their exact, possibly ragged, sizes: unlike
  the JAX package's tiled ``lax.all_to_all``, nothing is padded. A
  vector that does not carry the aligned split is re-split first (a
  gather).
- **generic** (1-D transforms, and ``axes[-1] == 0``, where the JAX
  package shards the input on axis 1): every rank gathers the whole
  array, transforms it and keeps its shard of the default split (the
  JAX package lets XLA partition the logical program and replicates the
  1-D case).

Without a process group, or in a world of one rank, both run on the
whole array with nothing to move. Local transforms are ``torch.fft``
(cuFFT on the card), as the JAX package leaves them to XLA's FFT; every
axis of a rank's block in one ``fftn``/``rfftn`` call. The adjoint of a
real transform runs the complex inverse over the other axes first and
``irfft`` last, with the imaginary parts of the DC and an even
``nfft``'s Nyquist bin zeroed before it: what numpy's ``irfft`` does
implicitly, and what cuFFT's leaves undefined.

With overlap on (``overlap=``, ``PYLOPS_MPI_TPU_TORCH_OVERLAP``) the
aligned path streams its two transposes in ``comm_chunks`` chunks
(``PYLOPS_MPI_TPU_TORCH_COMM_CHUNKS``, default 4; JAX ``ops/fft.py:
256-266``, ``:519-548``, ``:627-643``): each chunk of the out-axis goes
through its ``all_to_all``, the axis-0 transform and its ``all_to_all``
back, the next chunk's transfer in flight meanwhile
(:func:`~..parallel.collectives.chunked_pencil_transpose`). A count that
does not fit the axis falls back with a logged note
(:func:`~..parallel.collectives.resolve_chunks`); a default count may
come from the tuner's chunk plan.

With ``hierarchical`` (``PYLOPS_MPI_TPU_TORCH_HIERARCHICAL``; JAX
``ops/fft.py:195-208``, ``:533-543``, ``:628-638``) on a world laid out
hosts × ranks, each transpose runs in two levels
(:func:`~..parallel.collectives.hier_pencil_transpose`: an all-to-all
over the ranks of a host, then one across hosts; the transpose back in
reverse order), and with overlap on and more than one chunk the chunked
stream does so tile by tile
(:func:`~..parallel.collectives.chunked_pencil_transpose`'s
``two_level``, counted ``hier_chunked_pencil_transpose``): bit for
bit the flat transposes, with less traffic across hosts. ``._hier`` is
what the setting resolved to on this world; a flat world, a world of one
and ``off`` keep the flat transposes.

Not ported: the planar engine (``matvec_planes``/``rmatvec_planes``,
``ops/dft.py``), the TPU's workaround for its missing complex lowering,
and with it the two-level transposes' ``_planes`` variants (ROADMAP.md
§A.5).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..distributedarray import DistributedArray
from ..linearoperator import MPILinearOperator
from ..parallel import collectives
from ..parallel.mesh import check_mesh, rank, world_size
from ..parallel.partition import (Partition, flat_outer_shapes, local_split,
                                  shard_offsets)
from ._precision import as_torch_dtype

__all__ = ["MPIFFTND", "MPIFFT2D"]


def _astuple(v, n, cast=float):
    if np.ndim(v) == 0:
        return (cast(v),) * n
    v = tuple(cast(x) for x in v)
    if len(v) != n:
        raise ValueError(f"expected {n} values, got {len(v)}")
    return v


def _pencil_transpose(b: torch.Tensor, send_ax: int, recv_ax: int,
                      send_sizes: Sequence[int],
                      recv_sizes: Sequence[int]) -> torch.Tensor:
    """One ``all_to_all`` over the world: ``b``'s ``send_ax`` is cut into
    ``send_sizes`` pieces, one for each rank, and the pieces received
    from every rank (``recv_sizes[p]`` long along ``recv_ax``) are joined
    along ``recv_ax``."""
    me = rank()
    shapes = []
    for n in recv_sizes:
        shp = list(b.shape)
        shp[send_ax] = send_sizes[me]
        shp[recv_ax] = n
        shapes.append(tuple(shp))
    parts = collectives.all_to_all(
        list(torch.split(b, list(send_sizes), dim=send_ax)), shapes)
    return torch.cat(parts, dim=recv_ax)


class _MPIBaseFFTND(MPILinearOperator):
    """Shared bookkeeping (JAX ``ops/fft.py:97-239``, ref
    ``_baseffts.py:15-134``): ``nffts``, sample frequencies ``fs``, real
    and complex dtypes, norm, shifts, the pencil axes and the row-aligned
    splits."""

    def __init__(self, dims, axes, nffts=None, sampling=1.0, norm="none",
                 real=False, ifftshift_before=False, fftshift_after=False,
                 mesh=None, dtype="complex128", overlap=None,
                 comm_chunks=None, hierarchical=None):
        check_mesh(mesh)
        if comm_chunks is not None and int(comm_chunks) < 1:
            raise ValueError(f"comm_chunks={comm_chunks}: must be >= 1")
        self.overlap, self.comm_chunks = overlap, comm_chunks
        self.hierarchical = hierarchical
        self.dims_nd = tuple(int(d) for d in np.atleast_1d(dims))
        ndim = len(self.dims_nd)
        axes = tuple(int(ax) % ndim for ax in np.atleast_1d(axes))
        self.axes = np.asarray(axes)
        if nffts is None:
            nffts = tuple(self.dims_nd[ax] for ax in axes)
        self.nffts = _astuple(nffts, len(axes), int)
        self.sampling = _astuple(sampling, len(axes), float)
        if norm == "backward":
            raise ValueError(
                'To use no scaling on the forward transform, use "none". '
                "Note that in this case the adjoint transform will *not* "
                "have a 1/n scaling.")
        if norm == "forward":
            raise ValueError(
                'To use 1/n scaling on the forward transform, use "1/n". '
                "Note that in this case the adjoint transform will *also* "
                "have a 1/n scaling.")
        if isinstance(norm, str) and norm.lower() == "1/n":
            norm = "1/n"
        if norm not in ("none", "1/n"):
            raise ValueError(f"norm must be 'none' or '1/n', got {norm!r}")
        self.norm = norm
        # torch's names for the scaling of each transform: no scaling on
        # the forward ("none") or 1/n on it ("1/n"); the adjoint is then
        # the unscaled inverse (N·ifft) or the 1/n-scaled one, with no
        # separate pass over the result
        self._fwd_norm = "forward" if norm == "1/n" else "backward"
        self._inv_norm = "forward" if norm == "none" else "backward"
        self.real = bool(real)
        self.ifftshift_before = np.broadcast_to(
            np.atleast_1d(ifftshift_before), (len(axes),)).copy()
        self.fftshift_after = np.broadcast_to(
            np.atleast_1d(fftshift_after), (len(axes),)).copy()
        self.fs = []
        for i, (nfft, samp) in enumerate(zip(self.nffts, self.sampling)):
            if self.real and i == len(axes) - 1:
                f = np.fft.rfftfreq(nfft, d=samp)
            else:
                f = np.fft.fftfreq(nfft, d=samp)
                if self.fftshift_after[i]:
                    f = np.fft.fftshift(f)
            self.fs.append(f)
        dt = as_torch_dtype(dtype)
        self.cdtype = torch.promote_types(dt, torch.complex64)
        self.rdtype = self.cdtype.to_real() if self.real else self.cdtype
        self.clinear = not (self.real or dt.is_floating_point)
        dimsd = list(self.dims_nd)
        for i, ax in enumerate(axes):
            dimsd[ax] = self.nffts[i]
        if self.real:
            dimsd[axes[-1]] = self.nffts[-1] // 2 + 1
        self.dimsd_nd = tuple(dimsd)
        self.dims = self.dims_nd
        self.dimsd = self.dimsd_nd
        super().__init__(shape=(int(np.prod(dimsd)),
                                int(np.prod(self.dims_nd))),
                         dtype=self.cdtype)
        # the input is sharded on axis 0 unless the last transform axis
        # is 0, then on 1 (JAX :215-220, ref FFTND.py:188-211)
        self._in_axis = 1 if axes[-1] == 0 and ndim > 1 else 0
        if self._in_axis in axes and ndim > 1:
            self._out_axis = [ax for ax in range(ndim)
                              if ax != self._in_axis][0]
        else:
            self._out_axis = self._in_axis
        self._scale = float(np.prod(self.nffts))
        self._P, self._rank = world_size(), rank()
        P = self._P
        self._rows_m = tuple(s[0] for s in local_split(
            self.dims_nd, P, Partition.SCATTER, 0))
        self._rows_d = tuple(s[0] for s in local_split(
            self.dimsd_nd, P, Partition.SCATTER, 0))
        inner_m = int(np.prod(self.dims_nd[1:])) if ndim > 1 else 1
        inner_d = int(np.prod(self.dimsd_nd[1:])) if ndim > 1 else 1
        self._mlocals = flat_outer_shapes(self.dims_nd[0], inner_m, P)
        self._dlocals = flat_outer_shapes(self.dimsd_nd[0], inner_d, P)
        # the tuner's seam (JAX ``ops/fft.py:165-193``): overlap, chunks
        # and staging left at None, and not pinned by the environment,
        # come from the plan; ``_overlap`` and ``_comm_chunks`` are what
        # they resolve to
        from ..utils.deps import (comm_chunks_default, comm_chunks_env_pinned,
                                  hierarchical_active,
                                  hierarchical_env_pinned, overlap_enabled,
                                  overlap_env_pinned)
        want_overlap = overlap is None and not overlap_env_pinned()
        want_chunks = comm_chunks is None and not comm_chunks_env_pinned()
        want_hier = hierarchical is None and not hierarchical_env_pinned()
        self._chunks_from_user = not want_chunks
        if want_overlap or want_chunks or want_hier:
            from ..tuning import plan as _tuneplan
            tplan = _tuneplan.get_plan(
                "fft", shape=self.dims_nd, dtype=self.cdtype, n_dev=P,
                extra={"fft_axes": tuple(int(a) for a in self.axes),
                       "real": self.real})
            if tplan is not None:
                if want_overlap and tplan.get("overlap") in ("on", "off"):
                    self.overlap = tplan.get("overlap")
                if want_chunks and tplan.get("comm_chunks"):
                    self.comm_chunks = max(1, int(tplan.get("comm_chunks")))
                if want_hier and tplan.get("hierarchical") in (
                        "auto", "on", "off"):
                    self.hierarchical = tplan.get("hierarchical")
        self._overlap = overlap_enabled(self.overlap)
        self._hier = hierarchical_active(self.hierarchical)
        self._comm_chunks = (int(self.comm_chunks)
                             if self.comm_chunks is not None
                             else comm_chunks_default())

    @property
    def model_local_shapes(self):
        """Row-aligned flat split of the model: a vector carrying it
        enters the aligned path with a reshape; ``rmatvec`` outputs carry
        it."""
        return self._mlocals

    @property
    def data_local_shapes(self):
        """Row-aligned flat split of the data; ``matvec`` outputs carry
        it."""
        return self._dlocals

    def matvec_planes(self, *args, **kwargs):
        raise NotImplementedError(
            "matvec_planes (the planar engine) is not ported: the port "
            "keeps complex spectra (ROADMAP.md §A.5)")

    rmatvec_planes = matvec_planes

    # ------------------------------------------------------------- helpers
    def _shift_axes(self, flags) -> Tuple[int, ...]:
        return tuple(int(ax) for ax, f in zip(self.axes, flags) if f)

    def _scale_real(self, y: torch.Tensor, inverse: bool) -> torch.Tensor:
        """√2 scaling of the strictly positive non-Nyquist bins of the
        real axis (JAX ``_scale_real``, ``:271-286``), in ``y``'s real
        dtype."""
        ax = int(self.axes[-1])
        hi = 1 + (self.nffts[-1] - 1) // 2
        fac = 1 / math.sqrt(2) if inverse else math.sqrt(2)
        vec = torch.ones(y.shape[ax], device=y.device,
                         dtype=y.real.dtype if y.is_complex() else y.dtype)
        vec[1:hi] = fac
        shape = [1] * y.ndim
        shape[ax] = y.shape[ax]
        return y * vec.reshape(shape)

    def _nfft(self, ax: int) -> int:
        return self.nffts[list(self.axes).index(ax)]

    def _transform(self, b: torch.Tensor, axes: List[int]) -> torch.Tensor:
        """Forward transforms of ``b`` along ``axes`` in one call, the real
        axis (``axes[-1]`` of the operator) as ``rfft``."""
        if not axes:
            return b
        last = int(self.axes[-1])
        if self.real and last in axes:
            order = [a for a in axes if a != last] + [last]
            return torch.fft.rfftn(b, s=[self._nfft(a) for a in order],
                                   dim=order, norm=self._fwd_norm)
        return torch.fft.fftn(b, s=[self._nfft(a) for a in axes], dim=axes,
                              norm=self._fwd_norm)

    def _inverse(self, b: torch.Tensor, axes: List[int]) -> torch.Tensor:
        """Inverse transforms of ``b`` along ``axes``: the complex axes
        first, the real axis last as ``irfft`` with its DC (and an even
        ``nfft``'s Nyquist) imaginary parts zeroed."""
        last = int(self.axes[-1])
        cplx = [a for a in axes if not (self.real and a == last)]
        if cplx:
            b = torch.fft.ifftn(b, s=[self._nfft(a) for a in cplx], dim=cplx,
                                norm=self._inv_norm)
        if self.real and last in axes:
            n = self.nffts[-1]
            # b is never the caller's tensor here: _scale_real made it
            im = torch.view_as_real(b).select(-1, 1)
            im.narrow(last, 0, 1).zero_()
            if n % 2 == 0:
                im.narrow(last, n // 2, 1).zero_()
            b = torch.fft.irfft(b, n=n, dim=last, norm=self._inv_norm)
        return b

    @property
    def _two_level(self) -> bool:
        """Whether a two-level schedule runs (the graph bank's key,
        :func:`~..aot.signature.schedule_signature`): every transpose."""
        return self._hier

    def _pencil_chunks(self, width: int) -> int:
        """The chunk count of the streamed transposes at this operator's
        settings (1: the bulk transposes; JAX ``:256-266``)."""
        if not self._overlap or self._P <= 1:
            return 1
        return collectives.resolve_chunks(
            width, self._P, self._comm_chunks,
            allow_plan=not self._chunks_from_user)

    def _transposed(self, b: torch.Tensor, mid, rows_in, rows_out):
        """``b``'s out-axis pencils through the transpose, ``mid`` (the
        axis-0 section) and the transpose back: two bulk ``all_to_all``
        calls, or the chunked stream, each in two levels under ``_hier``
        (module docstring)."""
        out_ax, P = self._out_axis, self._P
        K = self._pencil_chunks(b.shape[out_ax])
        if K > 1:
            return collectives.chunked_pencil_transpose(
                b, out_ax, K, mid, rows_in, rows_out, two_level=self._hier)
        chunks = [s[0] for s in local_split((b.shape[out_ax],), P,
                                            Partition.SCATTER, 0)]
        if self._hier:
            b = collectives.hier_pencil_transpose(b, out_ax, 0, chunks,
                                                  rows_in)
            b = mid(b)
            return collectives.hier_pencil_transpose(b, 0, out_ax, rows_out,
                                                     chunks, forward=False)
        b = _pencil_transpose(b, out_ax, 0, chunks, rows_in)
        b = mid(b)
        return _pencil_transpose(b, 0, out_ax, rows_out, chunks)

    # --------------------------------------------------------------- apply
    def _split(self) -> bool:
        """The aligned path with pencils to transpose."""
        return len(self.dims_nd) > 1 and self._in_axis == 0 and self._P > 1

    def _forward(self, b: torch.Tensor, split: bool) -> torch.Tensor:
        """The transform of ``b``: this rank's rows (``split``) or the
        whole array."""
        axes = [int(a) for a in self.axes]
        before = self._shift_axes(self.ifftshift_before)
        after = self._shift_axes(self.fftshift_after)
        mid = split and 0 in axes     # axis 0 waits for the transposes
        loc = [a for a in axes if not (mid and a == 0)]
        pre = [a for a in before if not (mid and a == 0)]
        if pre:
            b = torch.fft.ifftshift(b, dim=pre)
        if not self.clinear:
            b = b.real
        b = self._transform(b, loc)
        if self.real:
            b = self._scale_real(b, inverse=False)
        if mid:
            def axis0(t):
                if 0 in before:
                    t = torch.fft.ifftshift(t, dim=0)
                t = torch.fft.fft(t, n=self._nfft(0), dim=0,
                                  norm=self._fwd_norm)
                if 0 in after:
                    t = torch.fft.fftshift(t, dim=0)
                return t
            b = self._transposed(b, axis0, self._rows_m, self._rows_d)
        post = [a for a in after if not (mid and a == 0)]
        if post:
            b = torch.fft.fftshift(b, dim=post)
        return b.to(self.cdtype)

    def _adjoint(self, b: torch.Tensor, split: bool) -> torch.Tensor:
        axes = [int(a) for a in self.axes]
        before = self._shift_axes(self.ifftshift_before)
        after = self._shift_axes(self.fftshift_after)
        mid = split and 0 in axes
        post = [a for a in after if not (mid and a == 0)]
        if post:
            b = torch.fft.ifftshift(b, dim=post)
        if self.real:
            b = self._scale_real(b, inverse=True)
        if mid:
            def axis0(t):
                if 0 in after:
                    t = torch.fft.ifftshift(t, dim=0)
                t = torch.fft.ifft(t, n=self._nfft(0), dim=0,
                                   norm=self._inv_norm)[:self.dims_nd[0]]
                if 0 in before:
                    t = torch.fft.fftshift(t, dim=0)
                return t
            b = self._transposed(b, axis0, self._rows_d, self._rows_m)
        b = self._inverse(b, [a for a in axes if not (mid and a == 0)])
        b = b[(slice(None),) * (1 if split else 0)
              + tuple(slice(0, d) for d in self.dims_nd[1 if split else 0:])]
        if not self.clinear:
            b = b.real
        pre = [a for a in before if not (mid and a == 0)]
        if pre:
            b = torch.fft.fftshift(b, dim=pre)
        return b.to(self.rdtype if not self.clinear else self.cdtype)

    def _apply(self, x: DistributedArray, forward: bool) -> DistributedArray:
        if x.partition != Partition.SCATTER:
            raise ValueError(f"x should have partition={Partition.SCATTER}"
                             f" Got {x.partition} instead...")
        dims, locs = ((self.dims_nd, self._mlocals) if forward
                      else (self.dimsd_nd, self._dlocals))
        out_dims, out_locs = ((self.dimsd_nd, self._dlocals) if forward
                              else (self.dims_nd, self._mlocals))
        fn = self._forward if forward else self._adjoint
        n_out = int(np.prod(out_dims))
        if self._split():
            if tuple(x.local_shapes) != tuple(locs):
                x = x._relayout(locs)  # not row-aligned: a gather
            rows = locs[self._rank][0] // int(np.prod(dims[1:]))
            y = fn(x.array.reshape((rows,) + dims[1:]), True).reshape(-1)
        else:
            g = x.array if self._P == 1 else x._global()
            y = fn(g.reshape(dims), False).reshape(-1)
            if len(self.dims_nd) == 1 or self._in_axis != 0:
                out_locs = local_split((n_out,), self._P,
                                       Partition.SCATTER, 0)
            if self._P > 1:
                off = shard_offsets([s[0] for s in out_locs])[self._rank]
                y = y[off:off + out_locs[self._rank][0]]
        return DistributedArray._wrap(y, x, global_shape=(n_out,),
                                      local_shapes=out_locs, axis=0,
                                      mask=None)

    def _matvec(self, x: DistributedArray) -> DistributedArray:
        return self._apply(x, True)

    def _rmatvec(self, x: DistributedArray) -> DistributedArray:
        return self._apply(x, False)


class MPIFFTND(_MPIBaseFFTND):
    """N-dimensional distributed FFT (JAX ``ops/fft.py:1199-1212``, ref
    ``FFTND.py:22-314``)."""

    def __init__(self, dims, axes=(0, 1, 2), nffts=None, sampling=1.0,
                 norm="none", real=False, ifftshift_before=False,
                 fftshift_after=False, mesh=None, dtype="complex128",
                 overlap=None, comm_chunks=None, hierarchical=None):
        super().__init__(dims, axes, nffts, sampling, norm, real,
                         ifftshift_before, fftshift_after, mesh, dtype,
                         overlap, comm_chunks, hierarchical)


class MPIFFT2D(_MPIBaseFFTND):
    """2-dimensional distributed FFT (JAX ``ops/fft.py:1215-1231``, ref
    ``FFT2D.py:11-172``)."""

    def __init__(self, dims, axes=(0, 1), nffts=None, sampling=1.0,
                 norm="none", real=False, ifftshift_before=False,
                 fftshift_after=False, mesh=None, dtype="complex128",
                 overlap=None, comm_chunks=None, hierarchical=None):
        if len(np.atleast_1d(axes)) != 2:
            raise ValueError("MPIFFT2D requires exactly two axes")
        super().__init__(dims, axes, nffts, sampling, norm, real,
                         ifftshift_before, fftshift_after, mesh, dtype,
                         overlap, comm_chunks, hierarchical)


# the operator's parameters (JAX ``ops/fft.py`` registrations)
from ..linearoperator import register_operator_params  # noqa: E402

register_operator_params(MPIFFTND)
register_operator_params(MPIFFT2D)
