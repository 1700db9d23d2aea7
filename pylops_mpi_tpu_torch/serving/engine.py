"""The warm pool: registered operator families, packed solves, prewarm.

PyTorch counterpart of ``pylops_mpi_tpu/serving/engine.py``.

- **Families**: a :class:`FamilySpec` names one operator instance and
  its solver settings (``cg``/``cgls``, ``niter``, ``tol``, ``damp``,
  ``M``). Every solve of the family uses that instance.
- **K buckets**: a fill of k single-RHS requests is solved as one block
  of the next width in ``PYLOPS_MPI_TPU_TORCH_SERVE_K_BUCKETS`` (default
  ``1,2,4,8,16``), the short side padded with zero columns. Padding is
  exact: every recurrence scalar of the block solvers is per column, a
  zero column's residual is zero so it freezes at iteration 0, and it
  stays exactly zero. A packed result equals ``block_cg``/``block_cgls``
  on the same padded block bit for bit.
- **Prewarm**: the JAX package compiles a (family, bucket) program with
  a zero-RHS solve whose loop never runs. Here nothing is compiled; the
  first solve of a (family, bucket) pays instead for the caching
  allocator's growth, the cuBLAS handle and workspace of the calling
  thread, the library's choice of algorithm for each shape and lazy
  module loading. The zero-RHS solve does that work: its loop body runs
  (with every column frozen) up to the first host check, so every
  operation of a real solve has been launched once, on the calling
  thread (the daemon prewarms on its dispatcher thread). Buckets come
  from the plan cache's banked block widths
  (:func:`~..tuning.plan.cached_batch_widths`), else every bucket.
- **The graph bank** (``PYLOPS_MPI_TPU_TORCH_AOT=on``, :mod:`..aot`):
  the zero-RHS solve would end at its first host check, before any
  capture, so prewarm captures each (family, bucket) explicitly
  (:func:`~..aot.graphs.capturing`) and the first request replays it. A
  (family, bucket) whose solve went through the bank is recorded in the
  process-wide ``_WARMED_SIGS`` with the bank keys its loop used, and a
  later prewarm skips it while the bank still holds those keys, as the
  JAX package's skips a banked one. Unlike the JAX package's, the
  signature (:meth:`FamilySpec.bank_signature`) names the operator
  instance and its tensor addresses, which a graph bakes in: a fresh
  instance of the same operator (a restarted daemon's) captures again.

One tenant must not hurt its batch-mates: columns freeze on their own
convergence test, and with ``PYLOPS_MPI_TPU_TORCH_GUARDS=on`` a column
that breaks down is frozen with its own verdict while the others run on.
Without guards a non-finite column ends the loop for the whole batch at
entry (the block solvers then return ``x0``), so serve with guards on.

Under a process group every rank calls :meth:`WarmPool.solve` with the
same ``Y`` (SPMD, as every entry point of the port). The daemon's
batches depend on timing, so under a group rank 0 forms them and sends
each to the other ranks before it solves (``serving/service.py``).
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..aot import aot_enabled, graphs
from ..diagnostics import metrics as _metrics
from ..diagnostics import trace as _trace
from ..distributedarray import DistributedArray
from ..ops._precision import as_torch_dtype
from ..parallel.mesh import default_device

__all__ = ["k_buckets", "bucket_for", "FamilySpec", "BlockOutcome",
           "WarmPool", "clear_warmed_signatures"]

_DEFAULT_BUCKETS = (1, 2, 4, 8, 16)

# (bank signature, bucket) -> the graph bank keys its solve went through
# in this process, shared across WarmPool instances (JAX
# ``serving/engine.py:62-67``)
_WARMED_SIGS: Dict[Tuple, Tuple] = {}


def clear_warmed_signatures() -> None:
    """Drop the process-wide prewarm ledger (test isolation)."""
    _WARMED_SIGS.clear()


def k_buckets() -> Tuple[int, ...]:
    """``PYLOPS_MPI_TPU_TORCH_SERVE_K_BUCKETS`` as a sorted tuple of
    distinct positive widths; malformed entries are dropped and an empty
    result takes the default ``(1, 2, 4, 8, 16)``."""
    raw = os.environ.get("PYLOPS_MPI_TPU_TORCH_SERVE_K_BUCKETS", "")
    vals = set()
    for tok in raw.split(","):
        tok = tok.strip()
        if tok.isdigit() and int(tok) >= 1:
            vals.add(int(tok))
    return tuple(sorted(vals)) if vals else _DEFAULT_BUCKETS


def bucket_for(count: int, buckets: Optional[Sequence[int]] = None) -> int:
    """The smallest bucket holding ``count`` columns (the largest when
    none does: the dispatcher never packs more than that)."""
    bs = tuple(buckets) if buckets else k_buckets()
    for b in bs:
        if b >= count:
            return b
    return bs[-1]


@dataclass(frozen=True)
class FamilySpec:
    """One servable family: the operator instance, the engine and its
    fixed parameters. ``tol`` is absolute on the squared recurrence norm;
    ``tol=0`` runs every column the full ``niter``. ``M`` is an optional
    preconditioner (:mod:`~..ops.precond`) of the block solvers."""
    name: str
    operator: object
    solver: str = "cgls"          # "cg" | "cgls"
    niter: int = 10
    tol: float = 0.0
    damp: float = 0.0
    dtype: object = torch.float32
    M: object = None
    # joins signature() only when true, so that every other family keeps
    # its signature and its prewarm and bank keys (JAX engine.py:118-121)
    differentiable: bool = False

    def __post_init__(self):
        if self.solver not in ("cg", "cgls"):
            raise ValueError(
                f"solver={self.solver!r}: expected 'cg' or 'cgls'")

    @property
    def nrows(self) -> int:
        return int(self.operator.shape[0])

    @property
    def device(self) -> torch.device:
        return getattr(self.operator, "device", None) or default_device()

    def signature(self) -> Tuple:
        """The family's structure: solver settings and the operator's
        :func:`~..aot.op_signature` (instances built alike share it);
        a preconditioned family adds ``id(M)``, a differentiable one the
        tag ``"differentiable"`` at the end."""
        from ..aot import op_signature
        sig = (self.solver, int(self.niter), float(self.tol),
               float(self.damp), str(as_torch_dtype(self.dtype)),
               op_signature(self.operator),
               None if self.M is None else ("M", id(self.M)))
        if self.differentiable:
            sig = sig + ("differentiable",)
        return sig

    def bank_signature(self) -> Tuple:
        """:meth:`signature` with the operator's ``id`` and the storage
        signatures of the operator and of ``M``: what the graph bank's
        keys hold of them."""
        from ..aot import storage_signature
        return (self.signature(), id(self.operator),
                storage_signature(self.operator),
                None if self.M is None else storage_signature(self.M))


def _still_banked(sig: Tuple, bucket: int) -> bool:
    """Whether ``(sig, bucket)``'s solve went through the graph bank and
    the bank still holds every key it used (not cleared, not evicted)."""
    from ..aot import store
    keys = _WARMED_SIGS.get((sig, bucket))
    return bool(keys) and all(store.mem_get(k) is not None for k in keys)


@dataclass
class BlockOutcome:
    """One packed solve sliced back to its fill: ``x`` is ``(N, k)`` on
    the host, ``statuses`` one word a column (``converged``/``maxiter``/
    ``breakdown``), ``wall_s`` the solve's wall time, ended after the
    device finished (the host copy of x waits for it)."""
    x: np.ndarray
    iiter: int
    statuses: Tuple[str, ...]
    k: int
    bucket: int
    wall_s: float


def _column_statuses(kold, tol: float) -> Tuple[str, ...]:
    """Each column's verdict from its final squared recurrence norm:
    non-finite → breakdown, under ``tol`` → converged, else maxiter."""
    kold = np.atleast_1d(np.asarray(kold))
    out = []
    for v in kold:
        if not np.isfinite(v):
            out.append("breakdown")
        elif v < tol:
            out.append("converged")
        else:
            out.append("maxiter")
    return tuple(out)


class WarmPool:
    """The registered families and the packed-solve entry point, one
    solve at a time (an internal lock). ``warmed`` holds every
    (family, bucket) pair solved at least once; ``prewarm_s`` the
    seconds of each prewarm solve."""

    def __init__(self, buckets: Optional[Sequence[int]] = None):
        self._families: Dict[str, FamilySpec] = {}
        self._buckets = tuple(sorted(set(buckets))) if buckets \
            else k_buckets()
        self._lock = threading.Lock()
        # under a process group, rank 0's running daemon sends each batch
        # to the other ranks before it solves (``SolveDaemon.start`` sets
        # it, its drain clears it); None otherwise
        self._announce = None
        self.warmed: set = set()
        self.prewarm_s: Dict[Tuple[str, int], float] = {}

    @property
    def buckets(self) -> Tuple[int, ...]:
        return self._buckets

    @property
    def k_max(self) -> int:
        return self._buckets[-1]

    def register(self, spec: FamilySpec) -> FamilySpec:
        if spec.name in self._families:
            raise ValueError(f"family {spec.name!r} already registered")
        self._families[spec.name] = spec
        return spec

    def family(self, name: str) -> FamilySpec:
        try:
            return self._families[name]
        except KeyError:
            raise KeyError(
                f"unknown operator family {name!r}; registered: "
                f"{sorted(self._families)}") from None

    def families(self) -> Tuple[str, ...]:
        return tuple(sorted(self._families))

    def _block(self, spec: FamilySpec, Y: np.ndarray) -> DistributedArray:
        """``Y`` as an ``(N, bucket)`` vector in the operator's row
        split, on its device."""
        ls = getattr(spec.operator, "local_shapes_n", None)
        if ls is not None:
            ls = [(s[0], Y.shape[1]) for s in ls]
        return DistributedArray.to_dist(Y, local_shapes=ls,
                                        device=spec.device)

    def solve(self, name: str, Y) -> BlockOutcome:
        """Solve ``Y``'s ``k`` columns (``(N, k)``, or ``(N,)`` for one;
        a host array) as one block of the next bucket's width."""
        from ..solvers.block import block_cg, block_cgls
        spec = self.family(name)
        dt = as_torch_dtype(spec.dtype)
        Y = np.asarray(Y, dtype=torch.empty(0, dtype=dt).numpy().dtype)
        if Y.ndim == 1:
            Y = Y[:, None]
        N, k = Y.shape
        if N != spec.nrows:
            raise ValueError(
                f"family {name!r} expects data length {spec.nrows}, "
                f"got {N}")
        bucket = bucket_for(k, self._buckets)
        if k > bucket:
            raise ValueError(
                f"fill {k} exceeds the largest bucket {bucket}; "
                "dispatch at most k_max columns per batch")
        if bucket > k:
            Y = np.concatenate([Y, np.zeros((N, bucket - k), Y.dtype)],
                               axis=1)
        yb = self._block(spec, Y)
        with self._lock, _trace.span("serve.pool_solve", cat="serving",
                                     family=name, fill=k, bucket=bucket,
                                     solver=spec.solver):
            if self._announce is not None:
                self._announce(name, k, Y)
            t0 = time.perf_counter()
            with graphs.recording_keys() as keys:
                if spec.solver == "cg":
                    xb, iiter, cost = block_cg(spec.operator, yb,
                                               niter=spec.niter,
                                               tol=spec.tol, M=spec.M)
                    kold = cost[-1] ** 2
                else:
                    xb, _istop, iiter, kold, _r2, _cost = block_cgls(
                        spec.operator, yb, niter=spec.niter,
                        damp=spec.damp, tol=spec.tol, M=spec.M)
            x = xb.asarray()[:, :k]  # the host copy waits for the device
            wall = time.perf_counter() - t0
            if keys:
                _WARMED_SIGS[(spec.bank_signature(), bucket)] = tuple(keys)
        kold = kold.detach().cpu().numpy()
        self.warmed.add((name, bucket))
        _metrics.inc("serve.pool.solves")
        _metrics.observe("serve.batch.fill", k / bucket)
        return BlockOutcome(x=x, iiter=int(iiter),
                            statuses=_column_statuses(kold, spec.tol)[:k],
                            k=k, bucket=bucket, wall_s=wall)

    def prewarm(self, names: Optional[Sequence[str]] = None,
                widths: Optional[Sequence[int]] = None) -> Dict:
        """Run a zero-RHS solve of each (family, bucket) before traffic
        (module docstring), on the calling thread. Buckets: ``widths``
        rounded up to buckets; else the plan cache's banked widths of the
        operator's class; else every bucket. Returns ``{family: [buckets
        warmed]}``; the seconds of each land in :attr:`prewarm_s`. With
        the graph bank armed each solve captures its loop, and a bucket
        whose loop the bank holds is skipped (module docstring)."""
        from ..tuning.plan import cached_batch_widths
        armed = aot_enabled()
        report: Dict[str, list] = {}
        for name in (names if names is not None else self.families()):
            spec = self.family(name)
            if widths is not None:
                want = [bucket_for(w, self._buckets) for w in widths]
            else:
                hist = cached_batch_widths(type(spec.operator).__name__)
                want = [bucket_for(w, self._buckets)
                        for w in hist if w <= self.k_max]
                if not want:
                    want = list(self._buckets)
            sig = spec.bank_signature() if armed else None
            done = []
            for b in sorted(set(want)):
                if sig is not None and _still_banked(sig, b):
                    self.warmed.add((name, b))
                    done.append(b)
                    _metrics.inc("serve.pool.prewarm_skipped")
                    _trace.event("serve.prewarm_skip", cat="serving",
                                 family=name, bucket=b)
                    continue
                with _trace.span("serve.prewarm", cat="serving",
                                 family=name, bucket=b), \
                        graphs.capturing() if armed else nullcontext():
                    t0 = time.perf_counter()
                    self.solve(name, np.zeros((spec.nrows, b)))
                    self.prewarm_s[(name, b)] = time.perf_counter() - t0
                done.append(b)
                _metrics.inc("serve.pool.prewarmed")
            report[name] = done
        return report
