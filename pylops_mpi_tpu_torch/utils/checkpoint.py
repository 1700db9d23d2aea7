"""Solver-state checkpoints: save, resume, and restore on another world.

PyTorch counterpart of ``pylops_mpi_tpu/utils/checkpoint.py:57-610``.
Two backends:

- **native** (the default): the JAX package's layout, a pickle of plain
  numpy and Python values, with every array of 1 MiB or more in a raw
  sidecar file of blobs (``<name>.blobs.<hex>``) that the pickle names.
  A :class:`~..distributedarray.DistributedArray` is stored as its
  global value (gathered from every rank, a collective) with its
  partition, axis, local shapes and mask; rank 0 writes. A file the JAX
  package wrote this way holds the same structure, which
  :func:`~..convert.fused_carry_from_jax` reads.
- **shards** (``backend="shards"`` or
  ``PYLOPS_MPI_TPU_TORCH_CKPT_BACKEND=shards``): a directory with one
  file a rank (``shard<r>.pkl``, the rank's own pieces, never gathered)
  and ``meta.json`` (layouts and Python scalars): the counterpart of the
  JAX package's orbax backend, which the card's machine does not have.
  ``backend="orbax"`` raises and names it.

**Crash-atomic writes.** A file is built beside its target, flushed and
fsynced, then renamed over it (a directory: built beside, then swapped
in), so a writer killed at any point leaves the previous checkpoint
whole. A killed writer's temporary file (``<path>.tmp<pid>``) is
removed by the next save once its pid is gone.

**Restore on another world.** A checkpoint written by N ranks loads on
M: the saved global value (or the N shard files, read on the host) is
split afresh over the M ranks (``local_shapes=None``, the balanced
split), as the JAX package's ``_check_elastic``/``_decode`` do
(``:122-180``). Two regrids refuse with their reason: a masked array
(its colors describe the old world) and a split axis shorter than the
new world. The same world keeps the saved local shapes bit for bit.
When ``PYLOPS_MPI_TPU_TORCH_RESHARD_BUDGET`` is set, a restore on
another world streams each vector onto its ranks through
``parallel/reshard.place_replica`` (host-staged when the budget demands
it, JAX ``:101-113``, ``:164``, ``:362``); unset, the one-shot placement
stays as it was, bit for bit.

Saves and loads wait on every rank, so they run under the collective
watchdog (stage ``checkpoint_io``): under a supervisor, a save blocked
on a dead peer becomes a :class:`~..resilience.elastic.WatchdogTimeout`.
"""

from __future__ import annotations

import glob
import json
import os
import pickle
import re
import secrets
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..diagnostics import trace as _trace
from ..distributedarray import DistributedArray
from ..ops._precision import as_torch_dtype
from ..parallel.mesh import DeviceLike, rank, resolve_device, world_size
from ..parallel.partition import Partition
from ..stacked import StackedDistributedArray

__all__ = ["save_solver", "load_solver", "save_pytree", "load_pytree",
           "save_fused_carry", "load_fused_carry", "FUSED_SCHEMA_VERSION",
           "ckpt_backend"]

_SOLVER_FIELDS = ("y", "s", "r", "c", "q", "kold", "iiter", "cost", "cost1",
                  "damp", "tol", "niter", "t", "z", "alpha", "thresh",
                  "normresold", "eps")

# arrays of at least this many bytes go to the sidecar of blobs
_BLOB_THRESHOLD = 1 << 20
_SHARDS_SCHEMA = 1


def ckpt_backend(backend: Optional[str] = None) -> str:
    """The backend of a save or load: ``backend``, else
    ``PYLOPS_MPI_TPU_TORCH_CKPT_BACKEND`` (default ``native``)."""
    b = backend or os.environ.get("PYLOPS_MPI_TPU_TORCH_CKPT_BACKEND",
                                  "native")
    if b == "orbax":
        raise NotImplementedError(
            "backend='orbax' is the JAX package's; its counterpart here is "
            "backend='shards' (a directory with one file a rank and a JSON "
            "meta file, written with no gather)")
    if b not in ("native", "shards"):
        raise ValueError(f"unknown checkpoint backend {b!r}; expected "
                         "'native' or 'shards'")
    return b


def _barrier() -> None:
    if world_size() > 1:
        import torch.distributed as dist
        dist.barrier()


# ------------------------------------------------------ host values
def _np_dtype_name(t: torch.Tensor) -> Optional[str]:
    """The dtype name a numpy copy cannot carry (bf16, widened to f32
    on the host), else ``None``."""
    if t.dtype in (torch.bfloat16,):
        return "bfloat16"
    return None


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _encode(v):
    """``v`` as plain numpy and Python values (the JAX package's
    ``_encode``)."""
    if isinstance(v, DistributedArray):
        out = {"__dist__": True, "value": v.asarray(),
               "partition": v.partition.name, "axis": v.axis,
               "local_shapes": v.local_shapes, "mask": v.mask}
        if v.dtype == torch.bfloat16:
            out["dtype"] = "bfloat16"
        return out
    if isinstance(v, StackedDistributedArray):
        return {"__stacked__": True,
                "arrays": [_encode(d) for d in v.distarrays]}
    if isinstance(v, torch.Tensor):
        name = _np_dtype_name(v)
        if name:
            return {"__tensor__": True, "value": _host(v), "dtype": name}
        return _host(v)
    if isinstance(v, (list, tuple)):
        return type(v)(_encode(e) for e in v)
    return v


def _check_elastic(partition: Partition, axis: int,
                   global_shape: Tuple[int, ...], mask, n_old: int,
                   n_new: int) -> None:
    """Refuse the regrids that have no meaning, naming the reason (JAX
    ``_check_elastic``)."""
    if mask is not None:
        raise ValueError(
            f"cannot restore a masked DistributedArray onto a world of "
            f"{n_new} ranks: its mask (sub-communicator colors "
            f"{tuple(mask)!r}) describes the original world of {n_old} and "
            "has no canonical regrid — rebuild the array and its mask for "
            "the new world, or restore onto a world of the original size")
    if partition == Partition.SCATTER and global_shape[axis] < n_new:
        raise ValueError(
            f"cannot reshard a SCATTER axis of length {global_shape[axis]} "
            f"onto {n_new} ranks: some ranks would own zero rows. Restore "
            f"onto a world of at most {global_shape[axis]} ranks, or shard "
            "a longer axis")


def _budgeted_restore() -> bool:
    """``PYLOPS_MPI_TPU_TORCH_RESHARD_BUDGET`` is set: a restore on
    another world then streams through the planner. A malformed value
    raises, as every reader of the budget does (a typo must not become
    an unbounded restore)."""
    from ..parallel.reshard import reshard_budget
    return reshard_budget() is not None


def _place(value: np.ndarray, partition: Partition, axis: int,
           local_shapes, mask, dtype: Optional[str],
           device: DeviceLike) -> DistributedArray:
    if local_shapes is None and _budgeted_restore():
        # another world under a budget: each rank streams its own rows
        from ..parallel import reshard as _reshard
        return _reshard.place_replica(
            value, None, partition, axis, mask=mask,
            dtype=as_torch_dtype(dtype) if dtype else None,
            device=resolve_device(device))
    out = DistributedArray.to_dist(value, partition=partition, axis=axis,
                                   local_shapes=local_shapes, mask=mask,
                                   device=device)
    if dtype:
        out._arr = out._arr.to(as_torch_dtype(dtype))
    return out


def _layout(v: dict, n_new: int):
    """``(partition, axis, local_shapes, mask)`` of a stored vector on a
    world of ``n_new`` ranks: the saved split on the same world, the
    balanced split (after :func:`_check_elastic`) on another."""
    partition = Partition[v["partition"]]
    axis = int(v["axis"])
    local_shapes = tuple(tuple(s) for s in v["local_shapes"])
    mask = None if v["mask"] is None else tuple(v["mask"])
    n_old = len(local_shapes)
    if n_old != n_new:
        _check_elastic(partition, axis, tuple(v["global_shape"]), mask,
                       n_old, n_new)
        _trace.event("checkpoint.elastic_reshard", cat="checkpoint",
                     partition=partition.name, axis=axis, n_old=n_old,
                     n_new=n_new, global_shape=list(v["global_shape"]))
        local_shapes = None
    return partition, axis, local_shapes, mask


def _decode(v, device: DeviceLike):
    """The JAX package's ``_decode``: stored vectors become
    :class:`DistributedArray` s on ``device``, everything else stays
    numpy and Python."""
    if isinstance(v, dict) and v.get("__dist__"):
        layout = _layout(dict(v, global_shape=np.shape(v["value"])),
                         world_size())
        return _place(np.asarray(v["value"]), *layout, v.get("dtype"),
                      device)
    if isinstance(v, dict) and v.get("__stacked__"):
        return StackedDistributedArray([_decode(d, device)
                                        for d in v["arrays"]])
    if isinstance(v, dict) and v.get("__tensor__"):
        return torch.as_tensor(np.asarray(v["value"])).to(
            as_torch_dtype(v["dtype"]))
    if isinstance(v, (list, tuple)):
        return type(v)(_decode(e, device) for e in v)
    return v


def _extract_blobs(v, blobs):
    if isinstance(v, np.ndarray) and v.nbytes >= _BLOB_THRESHOLD:
        a = np.ascontiguousarray(v)
        off = sum(b.nbytes for b in blobs)
        blobs.append(a)
        return {"__blob__": True, "offset": off, "dtype": a.dtype.str,
                "shape": a.shape}
    if isinstance(v, dict):
        return {k: _extract_blobs(e, blobs) for k, e in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_extract_blobs(e, blobs) for e in v)
    return v


def _restore_blobs(v, buf):
    if isinstance(v, dict) and v.get("__blob__"):
        dt = np.dtype(v["dtype"])
        n = int(np.prod(v["shape"], dtype=np.int64))
        return np.frombuffer(buf, dtype=dt, count=n,
                             offset=v["offset"]).reshape(v["shape"]).copy()
    if isinstance(v, dict):
        return {k: _restore_blobs(e, buf) for k, e in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_restore_blobs(e, buf) for e in v)
    return v


def _fsync_write(path: str, data_writer) -> None:
    with open(path, "wb") as f:
        data_writer(f)
        f.flush()
        os.fsync(f.fileno())


def _gc_stale_tmps(path: str) -> None:
    """Remove the temporary files (and directories) that writers killed
    mid-save left beside ``path`` (``<path>.tmp<pid>`` of a pid that no
    longer runs)."""
    for tmp in glob.glob(path + ".tmp*"):
        m = re.match(re.escape(path) + r"\.tmp(\d+)$", tmp)
        if not m or int(m.group(1)) == os.getpid():
            continue
        try:
            os.kill(int(m.group(1)), 0)  # raises when the pid is gone
        except ProcessLookupError:
            if os.path.isdir(tmp):
                shutil.rmtree(tmp, ignore_errors=True)
            else:
                try:
                    os.remove(tmp)
                except OSError:
                    pass
        except OSError:
            pass  # the pid exists but is not ours to probe


# ------------------------------------------------------ native backend
def _save_native(path: str, tree: Dict[str, Any]) -> None:
    enc = {k: _encode(v) for k, v in tree.items()}  # collective gathers
    if rank() == 0:
        blobs: list = []
        enc = _extract_blobs(enc, blobs)
        folder = os.path.dirname(os.path.abspath(path))
        os.makedirs(folder, exist_ok=True)
        _gc_stale_tmps(path)
        old_sidecars = glob.glob(os.path.abspath(path) + ".blobs.*")
        blob_name = None
        if blobs:
            blob_name = (os.path.basename(path) + ".blobs."
                         + secrets.token_hex(4))

            def write_blobs(f):
                for b in blobs:
                    f.write(b.view(np.uint8).reshape(-1).data)

            _fsync_write(os.path.join(folder, blob_name), write_blobs)
        enc["__blobfile__"] = blob_name
        tmp = path + f".tmp{os.getpid()}"
        # durability before visibility: fsync the temporary, then rename
        _fsync_write(tmp, lambda f: pickle.dump(enc, f))
        os.replace(tmp, path)
        for old in old_sidecars:
            if os.path.basename(old) != blob_name and os.path.exists(old):
                os.remove(old)
    _barrier()


def _read_native(path: str, unpickler=pickle.Unpickler) -> Dict[str, Any]:
    """The stored structure of a native checkpoint (numpy and Python),
    its blobs read back from the sidecar with plain file reads."""
    with open(path, "rb") as f:
        enc = unpickler(f).load()
    if not isinstance(enc, dict):
        raise ValueError(f"{path!r} is not a checkpoint: it holds a "
                         f"{type(enc).__name__}, not a dict")
    blob_name = enc.pop("__blobfile__", None)
    if blob_name is not None:
        blob_path = os.path.join(os.path.dirname(os.path.abspath(path)),
                                 blob_name)
        if not os.path.exists(blob_path):
            raise FileNotFoundError(
                f"checkpoint sidecar {blob_path!r} is missing — the "
                "checkpoint directory must be moved or copied as a whole")
        with open(blob_path, "rb") as f:
            buf = f.read()
        enc = _restore_blobs(enc, buf)
    return enc


# ------------------------------------------------------ shards backend
def _flatten_shards(tree: Dict[str, Any], meta: Dict, mine: Dict,
                    replicated: Dict) -> None:
    for k, v in tree.items():
        if isinstance(v, StackedDistributedArray):
            meta[k] = {"kind": "stacked", "n": len(v.distarrays)}
            _flatten_shards({f"{k}.{i}": d
                             for i, d in enumerate(v.distarrays)},
                            meta, mine, replicated)
        elif isinstance(v, DistributedArray):
            meta[k] = {"kind": "dist", "partition": v.partition.name,
                       "axis": int(v.axis),
                       "global_shape": list(v.global_shape),
                       "local_shapes": [list(s) for s in v.local_shapes],
                       "mask": list(v.mask) if v.mask is not None else None,
                       "dtype": _np_dtype_name(v.array)}
            mine[k] = _host(v.array)
        elif isinstance(v, (torch.Tensor, np.ndarray, np.generic)):
            t = v if isinstance(v, torch.Tensor) else None
            meta[k] = {"kind": "array",
                       "dtype": _np_dtype_name(t) if t is not None
                       else None}
            replicated[k] = _host(t) if t is not None else np.asarray(v)
        elif isinstance(v, (int, float, complex, str, bool, type(None))):
            meta[k] = {"kind": "py", "complex": isinstance(v, complex),
                       "value": [v.real, v.imag]
                       if isinstance(v, complex) else v}
        elif isinstance(v, (list, tuple)):
            meta[k] = {"kind": "seq", "n": len(v),
                       "tuple": isinstance(v, tuple)}
            _flatten_shards({f"{k}.{i}": e for i, e in enumerate(v)},
                            meta, mine, replicated)
        else:
            raise TypeError(f"the shards backend cannot store {k!r} of "
                            f"type {type(v).__name__}")


def _save_shards(path: str, tree: Dict[str, Any]) -> None:
    if any("." in k for k in tree):
        raise ValueError("the shards backend reserves '.' in keys for the "
                         "parts of containers")
    meta: Dict[str, Any] = {}
    mine: Dict[str, np.ndarray] = {}
    replicated: Dict[str, np.ndarray] = {}
    _flatten_shards(tree, meta, mine, replicated)
    path = os.path.abspath(path)
    P, r = world_size(), rank()
    # every rank writes into one temporary directory named by the
    # writers' rank 0 (its pid), which rank 0 then swaps in
    tmp = path + f".tmp{_rank0_pid() if P > 1 else os.getpid()}"
    if r == 0:
        _gc_stale_tmps(path)
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
    _barrier()
    payload = {"shards": mine}
    if r == 0:
        payload["replicated"] = replicated
    _fsync_write(os.path.join(tmp, f"shard{r}.pkl"),
                 lambda f: pickle.dump(payload, f))
    _barrier()
    if r == 0:
        doc = {"schema": _SHARDS_SCHEMA, "world": P, "entries": meta}
        _fsync_write(os.path.join(tmp, "meta.json"),
                     lambda f: f.write(json.dumps(doc).encode()))
        old = None
        if os.path.exists(path):
            old = path + ".old" + secrets.token_hex(4)
            os.rename(path, old)
        os.rename(tmp, path)
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)
    _barrier()


def _rank0_pid() -> int:
    """Rank 0's pid on every rank (NCCL broadcasts on the rank's card,
    gloo on the host)."""
    import torch.distributed as dist
    from ..parallel.mesh import default_mesh
    mesh = default_mesh()
    dev = mesh.device if mesh.backend == "nccl" else torch.device("cpu")
    t = torch.tensor([os.getpid()], dtype=torch.int64, device=dev)
    dist.broadcast(t, 0)
    return int(t.cpu()[0])


def _load_shards(path: str, device: DeviceLike) -> Dict[str, Any]:
    path = os.path.abspath(path)
    with open(os.path.join(path, "meta.json")) as f:
        doc = json.load(f)
    if doc.get("schema") != _SHARDS_SCHEMA:
        raise ValueError(f"shards checkpoint {path!r} has schema "
                         f"{doc.get('schema')!r}, not {_SHARDS_SCHEMA}")
    meta, n_old = doc["entries"], int(doc["world"])
    n_new, r = world_size(), rank()
    files: Dict[int, Dict] = {}

    def shard_file(i: int) -> Dict:
        if i not in files:
            with open(os.path.join(path, f"shard{i}.pkl"), "rb") as f:
                files[i] = pickle.load(f)
        return files[i]

    def dist_value(k, m):
        partition, axis, local_shapes, mask = _layout(m, n_new)
        dt = as_torch_dtype(m["dtype"]) if m.get("dtype") else None
        if local_shapes is not None:
            # the same world: this rank's own piece, nothing gathered
            piece = shard_file(r)["shards"][k]
            out = DistributedArray(global_shape=tuple(m["global_shape"]),
                                   partition=partition, axis=axis,
                                   local_shapes=local_shapes, mask=mask,
                                   dtype=as_torch_dtype(piece.dtype),
                                   device=device)
            out._arr = torch.as_tensor(piece).to(out.device)
        else:
            # another world: the pieces of every old rank, on the host
            pieces = [shard_file(i)["shards"][k] for i in range(n_old)]
            if partition == Partition.SCATTER:
                value = np.concatenate(pieces, axis=axis)
            else:
                value = pieces[0]
            if _budgeted_restore():
                return _place(value, partition, axis, None, None,
                              m.get("dtype"), device)
            out = DistributedArray.to_dist(value, partition=partition,
                                           axis=axis, device=device)
        if dt is not None:
            out._arr = out._arr.to(dt)
        return out

    def build(k, m):
        kind = m["kind"]
        if kind == "stacked":
            return StackedDistributedArray(
                [build(f"{k}.{i}", meta[f"{k}.{i}"]) for i in range(m["n"])])
        if kind == "seq":
            seq = [build(f"{k}.{i}", meta[f"{k}.{i}"]) for i in range(m["n"])]
            return tuple(seq) if m["tuple"] else seq
        if kind == "dist":
            return dist_value(k, m)
        if kind == "array":
            a = shard_file(0)["replicated"][k]
            if m.get("dtype"):
                return torch.as_tensor(a).to(as_torch_dtype(m["dtype"]))
            return np.asarray(a)
        v = m["value"]
        return complex(v[0], v[1]) if m.get("complex") else v

    roots = [k for k in meta
             if "." not in k or meta.get(k.rsplit(".", 1)[0]) is None]
    return {k: build(k, meta[k]) for k in sorted(roots)}


# ------------------------------------------------------ public API
def _save_impl(path: str, tree: Dict[str, Any],
               backend: Optional[str]) -> None:
    if ckpt_backend(backend) == "shards":
        _save_shards(path, tree)
    else:
        _save_native(path, tree)


def save_pytree(path: str, tree: Dict[str, Any],
                backend: Optional[str] = None) -> None:
    """Save a dict of distributed vectors, tensors, numpy arrays and
    Python values, crash-atomically (module docstring). Every rank calls
    it. Runs under the watchdog (stage ``checkpoint_io``)."""
    from ..resilience.elastic import watched_call
    return watched_call(_save_impl, path, tree, backend,
                        stage="checkpoint_io")


def _load_impl(path: str, device: DeviceLike,
               backend: Optional[str]) -> Dict[str, Any]:
    backend = ckpt_backend(backend)
    _trace.event("checkpoint.load", cat="checkpoint", path=path,
                 backend=backend)
    if backend == "shards" or os.path.isdir(path):
        # a directory is a shards checkpoint whatever the knob says
        return _load_shards(path, device)
    return {k: _decode(v, device) for k, v in _read_native(path).items()}


def load_pytree(path: str, device: DeviceLike = None,
                backend: Optional[str] = None) -> Dict[str, Any]:
    """Load a :func:`save_pytree` checkpoint, its vectors on ``device``
    (default ``"cuda"``) and split over this world, which may differ
    from the saver's (module docstring). Tensors of a numpy dtype come
    back as numpy arrays, as in the JAX package. Watched like
    :func:`save_pytree`."""
    from ..resilience.elastic import watched_call
    return watched_call(_load_impl, path, device, backend,
                        stage="checkpoint_io")


def save_solver(path: str, solver, x=None,
                backend: Optional[str] = None) -> None:
    """Snapshot a class-API solver (``CG``, ``CGLS``, ``ISTA``,
    ``FISTA``) between ``step`` calls, and its ``x``."""
    state: Dict[str, Any] = {"__class__": type(solver).__name__}
    for field in _SOLVER_FIELDS:
        if hasattr(solver, field):
            state[field] = getattr(solver, field)
    if x is not None:
        state["x"] = x
    save_pytree(path, state, backend=backend)


def _as_device(v, device: torch.device):
    """numpy values of a restored solver as tensors on its device."""
    if isinstance(v, np.ndarray):
        return torch.as_tensor(v, device=device)
    if isinstance(v, list):
        return [_as_device(e, device) for e in v]
    return v


def load_solver(path: str, solver, device: DeviceLike = None,
                backend: Optional[str] = None):
    """Restore a :func:`save_solver` snapshot into a new solver of the
    same class and operator; its scalars and histories come back as
    tensors on ``device``. Returns the saved ``x`` (or ``None``)."""
    dev = resolve_device(device)
    state = load_pytree(path, device=dev, backend=backend)
    cls = state.pop("__class__", None)
    if cls is not None and cls != type(solver).__name__:
        raise ValueError(f"checkpoint is for {cls}, not "
                         f"{type(solver).__name__}")
    x = state.pop("x", None)
    for k, v in state.items():
        setattr(solver, k, _as_device(v, dev))
    return x


# ------------------------------------------------ fused-carry schema
# A segmented solve's carry between epochs (solvers/segmented.py): the
# recurrence vectors and scalars, the iteration counters, the histories,
# the floors and the guard words, under a versioned header.
FUSED_SCHEMA_VERSION = 1


def save_fused_carry(path: str, solver: str, carry: Dict[str, Any],
                     backend: Optional[str] = None) -> None:
    """Save a segmented solve's ``carry`` (its fields and its plan:
    ``niter``, ``tol``, ``damp``, ``epoch``, ``guards``, ``precond``)
    under the loop family ``solver``."""
    state = dict(carry)
    state["__fused__"] = solver
    state["__fused_schema__"] = FUSED_SCHEMA_VERSION
    save_pytree(path, state, backend=backend)


def check_fused(state: Dict[str, Any], path: str, solver: str
                ) -> Dict[str, Any]:
    """Validate and strip a fused carry's header: the loop family and
    the schema version (a mismatch names itself)."""
    kind = state.pop("__fused__", None)
    if kind is None:
        raise ValueError(
            f"{path!r} is not a fused-carry checkpoint (it may be a "
            "class-API save_solver snapshot — load it with load_solver)")
    if kind != solver:
        raise ValueError(f"fused-carry checkpoint is for {kind!r}, "
                         f"not {solver!r}")
    schema = state.pop("__fused_schema__", None)
    if schema != FUSED_SCHEMA_VERSION:
        raise ValueError(
            f"fused-carry schema {schema!r} != {FUSED_SCHEMA_VERSION} "
            "(checkpoint written by an incompatible version)")
    return state


def load_fused_carry(path: str, solver: str, device: DeviceLike = None,
                     backend: Optional[str] = None) -> Dict[str, Any]:
    """Load a :func:`save_fused_carry` checkpoint, validated; its
    vectors split over this world, which may differ from the saver's."""
    return check_fused(load_pytree(path, device=device, backend=backend),
                       path, solver)
