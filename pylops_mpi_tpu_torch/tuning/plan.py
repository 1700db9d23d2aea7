"""The plan seam: what the operator constructors consult.

PyTorch counterpart of ``pylops_mpi_tpu/tuning/plan.py``. :func:`get_plan`
is the one entry point the constructors call (``ops/blockdiag.py``,
``ops/stack.py``, ``ops/derivatives.py``, ``ops/halo.py``, ``ops/fft.py``,
SUMMA in ``ops/matrixmult.py``, ``ops/sparse.auto_sparse_matmult``).
Resolution order:

1. ``PYLOPS_MPI_TPU_TORCH_TUNE=off`` (the default): ``None``, and the
   caller keeps its defaults: nothing changes.
2. A cached plan for the key (:mod:`.cache`,
   ``PYLOPS_MPI_TPU_TORCH_TUNE_CACHE``) whose params pass the space's
   validation: provenance ``tuned``, no timing trial. Params that fail
   it (a stale value) are a logged miss.
3. Under ``auto``, a caller that passes a ``factory`` gets its miss
   measured (:func:`~.search.measure_candidates`, inside the tune
   budget) and the winner banked: provenance ``tuned``.
4. The seed's pick (:func:`~.space.rank`), by construction today's
   default: provenance ``costmodel``.

Explicit keyword arguments always win: the constructors consult the
plan only for parameters left at their ``None``/``auto`` sentinels. A
reentrancy guard (a ``threading.local``, so the serving dispatcher's
thread has its own) keeps candidates built during a measurement from
consulting the tuner.

**Keys** have the JAX package's layout, ``op|s<bucket>|<dtype>|
mesh[<axes>]x<n>|<platform>:<chip>`` with optional ``|grid(..)``,
``|b<K>`` and ``|t<topology>`` segments. ``platform:chip`` is the
operator's device: ``cuda:<device name>`` for a tensor on a card,
``cpu:cpu`` on the CPU, whatever else the process holds; a plan measured
on one never replays on the other. Operators that hold no tensors (the
derivatives, the halo, the FFTs) key by the default device. The dtype is the operator's, not its
storage's (as in the JAX package), so two storages of one operator share
a key: bank them in separate cache files.

:func:`chunk_hint` and :func:`record_chunk_plan` bank and read the
transposes' chunk counts; the offline CLI banks them, and nothing in the
port consumes them until its transposes are chunked (ROADMAP.md §A.3b).
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..diagnostics import trace as _trace
from . import cache as _cache
from . import space as _space

__all__ = ["Plan", "tune_mode", "tune_enabled", "plan_key",
           "shape_bucket", "get_plan", "chunk_hint", "record_chunk_plan",
           "applied_provenance", "reset_applied", "cached_batch_widths"]

_MODES = ("off", "on", "auto")
_warned_mode = False

# reentrancy guard: candidates built during a measurement never consult
_tls = threading.local()

# the provenance of the last plan applied per operator family
_APPLIED: Dict[str, str] = {}
_APPLIED_LOCK = threading.Lock()


def tune_mode() -> str:
    """``PYLOPS_MPI_TPU_TORCH_TUNE`` resolved to ``off``/``on``/``auto``;
    an unknown value is ``off`` with a one-time warning."""
    global _warned_mode
    m = os.environ.get("PYLOPS_MPI_TPU_TORCH_TUNE", "off").strip().lower()
    if m in ("", "0", "none", "default"):
        m = "off"
    if m in ("1", "true"):
        m = "on"
    if m not in _MODES:
        if not _warned_mode:
            import warnings
            warnings.warn(
                f"PYLOPS_MPI_TPU_TORCH_TUNE={m!r} is not one of {_MODES}; "
                "tuning stays off", stacklevel=2)
            _warned_mode = True
        m = "off"
    return m


def tune_enabled() -> bool:
    return tune_mode() != "off"


@dataclass
class Plan:
    """A resolved plan: the params to apply, where they came from
    (``tuned``: measured; ``costmodel``: the seed), and the trials when
    measured in this process."""

    op: str
    key: str
    params: Dict
    provenance: str
    trials: List[Dict] = field(default_factory=list)

    def get(self, name: str, default=None):
        return self.params.get(name, default)

    def as_dict(self) -> Dict:
        return {"op": self.op, "key": self.key, "params": self.params,
                "provenance": self.provenance, "trials": self.trials}


def shape_bucket(shape) -> Tuple[int, ...]:
    """The next power of two of each dimension: nearby shapes share a
    plan."""
    out = []
    for s in np.atleast_1d(shape):
        s = max(1, int(s))
        out.append(1 << (s - 1).bit_length())
    return tuple(out)


def _chip_kind(device=None) -> Tuple[str, str]:
    """``(platform, chip)`` of ``device`` (default: the port's default
    device): ``("cuda", <device name>)`` for a card, ``("cpu", "cpu")``
    for the CPU."""
    import torch
    from ..parallel.mesh import default_device
    dev = default_device() if device is None else torch.device(device)
    if dev.type == "cuda" and device is None \
            and not torch.cuda.is_available():
        return "cpu", "cpu"  # a default never used: no card here
    if dev.type == "cuda":
        try:
            return "cuda", torch.cuda.get_device_name(dev)
        except (RuntimeError, AssertionError):
            return "cuda", "unknown"
    if dev.type == "cpu":
        return "cpu", "cpu"
    return dev.type, dev.type


def _dtype_name(dtype) -> str:
    if dtype is None:
        return "f32"
    name = str(dtype)
    if name.startswith("torch."):
        return name[len("torch."):]
    try:
        return np.dtype(dtype).name
    except TypeError:
        return name


def plan_key(op: str, shape, dtype=None, n_dev: Optional[int] = None,
             axes=None, extra: Optional[Dict] = None, device=None) -> str:
    """The cache key of one plan: operator family, shape bucket, dtype,
    mesh axes and size, and the platform and chip of ``device``;
    ``extra`` may add the grid, the block width (``batch``, omitted for
    1) and a topology."""
    platform, chip = _chip_kind(device)
    bucket = "x".join(str(b) for b in shape_bucket(shape))
    ax = ",".join(str(a) for a in (axes or ()))
    nd = int(n_dev or 1)
    key = f"{op}|s{bucket}|{_dtype_name(dtype)}|mesh[{ax}]x{nd}|" \
          f"{platform}:{chip}"
    if extra and extra.get("grid"):
        key += f"|grid{tuple(int(g) for g in extra['grid'])}"
    if extra and extra.get("batch") and int(extra["batch"]) != 1:
        key += f"|b{int(extra['batch'])}"
    if extra and extra.get("topology"):
        key += f"|t{extra['topology']}"
    return key


def cached_batch_widths(op: str, path: Optional[str] = None) -> list:
    """The block widths K with a plan banked for operator family ``op``
    (sorted; 1 for a key without a ``|b<K>`` segment; an unparseable
    segment is skipped): the widths real traffic used, which the
    serving pool prewarms."""
    widths = set()
    prefix = op + "|"
    for key in _cache.cached_keys(path):
        if not key.startswith(prefix):
            continue
        k = 1
        for seg in key.split("|")[1:]:
            if len(seg) > 1 and seg[0] == "b" and seg[1:].isdigit():
                k = int(seg[1:])
        widths.add(k)
    return sorted(widths)


def _context(op: str, shape, dtype, n_dev, axes, extra, device) -> Dict:
    platform, chip = _chip_kind(device)
    return {"op": op, "shape": tuple(int(s) for s in np.atleast_1d(shape)),
            "dtype": dtype, "n_dev": int(n_dev or 1),
            "axes": tuple(axes or ()), "platform": platform,
            "chip": chip, "extra": dict(extra or {})}


def _note_applied(op: str, provenance: str) -> None:
    with _APPLIED_LOCK:
        _APPLIED[op] = provenance


def applied_provenance(op: Optional[str] = None, default: str = "default"):
    """The provenance of the last plan applied for ``op`` in this
    process (``default`` when the tuner never ran); without ``op``, the
    whole table."""
    with _APPLIED_LOCK:
        if op is None:
            return dict(_APPLIED)
        return _APPLIED.get(op, default)


def reset_applied() -> None:
    with _APPLIED_LOCK:
        _APPLIED.clear()


def get_plan(op: str, *, shape, dtype=None, mesh=None,
             n_dev: Optional[int] = None, axes=None,
             extra: Optional[Dict] = None, factory=None,
             device=None) -> Optional[Plan]:
    """Resolve the plan of one operator construction (module docstring).
    ``None`` when tuning is off, no space is declared for ``op``, or the
    call is reentrant. ``mesh`` (the port's :class:`~..parallel.mesh.
    Mesh`) or the process group gives ``n_dev``; ``device`` is the
    operator's device (default: the default device); ``factory(params)
    -> callable`` builds a candidate and returns a zero-argument apply,
    consulted only under ``auto`` on a miss."""
    mode = tune_mode()
    if mode == "off":
        return None
    if getattr(_tls, "active", False):
        return None
    sp = _space.space_for(op)
    if sp is None:
        return None
    if n_dev is None:
        if mesh is not None:
            n_dev = int(np.prod(mesh.shape)) if hasattr(mesh, "coords") \
                else int(mesh.size)
        else:
            from ..parallel.mesh import world_size
            n_dev = world_size()
    if not (extra or {}).get("topology"):
        # a plan measured on one host layout never replays on another
        # (JAX ``plan.py:248-249``); empty on a flat world, so every
        # banked key stays as it was
        from ..parallel import topology as _topo
        tk = (_topo.topology_key(mesh) if hasattr(mesh, "coords")
              else _topo.world_key())
        if tk:
            extra = dict(extra or {}, topology=tk)
    key = plan_key(op, shape, dtype, n_dev, axes, extra, device)
    ctx = _context(op, shape, dtype, n_dev, axes, extra, device)

    entry = _cache.lookup(key)
    if entry is not None:
        params = entry.get("params")
        if isinstance(params, dict) and sp.validate(params):
            _note_applied(op, "tuned")
            _trace.event("tuning.plan", cat="tuning", op=op, key=key,
                         provenance="tuned", params=params, replay=True)
            return Plan(op, key, dict(params), "tuned")
        _trace.event("tuning.cache_error", cat="tuning", key=key,
                     why="cached params fail space validation")

    if mode == "auto" and factory is not None:
        from . import search as _search
        _tls.active = True
        try:
            params, trials = _search.measure_candidates(sp, ctx, factory)
        finally:
            _tls.active = False
        if params is not None:
            _cache.store(key, {"params": params, "provenance": "tuned",
                               "trials": trials})
            _note_applied(op, "tuned")
            _trace.event("tuning.plan", cat="tuning", op=op, key=key,
                         provenance="tuned", params=params,
                         trials=len(trials))
            return Plan(op, key, dict(params), "tuned", trials)

    ranked = _space.rank(sp, ctx)
    params = ranked[0] if ranked else {}
    _note_applied(op, "costmodel")
    _trace.event("tuning.plan", cat="tuning", op=op, key=key,
                 provenance="costmodel", params=params)
    return Plan(op, key, dict(params), "costmodel")


def chunk_hint(where: str, width: int, n_shards: int, *,
               op: str = "pencil_transpose") -> Optional[int]:
    """A banked chunk count for one streamed collective of ``width``
    over ``n_shards``, or ``None``: cache only (no seed moves off the
    default without a measurement). The resharding planner asks it for
    op ``"reshard"`` (``parallel/reshard.py``); the port's transposes are
    not chunked yet (ROADMAP.md §A.3b)."""
    if tune_mode() == "off" or getattr(_tls, "active", False):
        return None
    key = plan_key(op, (int(width),), None, int(n_shards), None)
    entry = _cache.lookup(key)
    if entry is None:
        return None
    sp = _space.space_for(op)
    params = entry.get("params")
    if not (isinstance(params, dict) and sp is not None
            and sp.validate(params)):
        return None
    k = int(params.get("comm_chunks", 0))
    return k if k >= 1 else None


def record_chunk_plan(width: int, n_shards: int, chunks: int,
                      trials: Optional[List[Dict]] = None,
                      path: Optional[str] = None, *,
                      op: str = "pencil_transpose") -> str:
    """Bank a measured chunk count for one transpose width (the offline
    CLI after an FFT sweep); returns the key."""
    key = plan_key(op, (int(width),), None, int(n_shards), None)
    _cache.store(key, {"params": {"comm_chunks": int(chunks)},
                       "provenance": "tuned",
                       "trials": list(trials or [])}, path=path)
    return key
