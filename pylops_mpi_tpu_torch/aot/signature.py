"""Structural signatures of operators and of the build environment.

PyTorch counterpart of ``pylops_mpi_tpu/aot/signature.py``.
:func:`op_signature` fingerprints an operator by class, shape, dtype and
the shapes and dtypes of the tensors it holds, so two instances built
alike (a restarted daemon's fresh operator) share one signature;
:func:`compile_signature` fingerprints what a stored build would depend
on (the torch and CUDA versions, the device, the world size and the
knobs that change the solvers' arithmetic); :func:`storage_signature`
adds the addresses of the operator's tensors, which a captured CUDA
graph bakes in. The bank of captured loops (:mod:`.graphs`) keys on all
three; the serving pool folds :func:`op_signature` into its family
signature.
"""

import os
from typing import Any, Dict, List, Tuple

__all__ = ["compile_signature", "op_signature", "storage_signature"]

# knobs that change what a solve computes
_COMPILE_KNOBS = (
    "PYLOPS_MPI_TPU_TORCH_PRECISION",
    "PYLOPS_MPI_TPU_TORCH_CA",
    "PYLOPS_MPI_TPU_TORCH_CA_S",
    "PYLOPS_MPI_TPU_TORCH_GUARDS",
    "PYLOPS_MPI_TPU_TORCH_GUARD_STALL",
)


def compile_signature() -> Dict[str, Any]:
    """The environment's fingerprint, JSON scalars only."""
    import torch
    from ..parallel.mesh import world_size
    from ..parallel.topology import world_key
    cuda = torch.cuda.is_available()
    return {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "platform": "cuda" if cuda else "cpu",
        "device_name": torch.cuda.get_device_name(0) if cuda else "cpu",
        "world_size": world_size(),
        # the host layout (parallel/topology.py; JAX ``signature.py:
        # 50-62``): empty on a flat world
        "topology": world_key(),
        "knobs": {k: os.environ.get(k, "") for k in _COMPILE_KNOBS},
    }


def _tensors(obj, out: List, seen: set, leaf=None) -> None:
    """``leaf(t)`` (default ``(shape, dtype)``) of every tensor reachable
    from ``obj`` through attributes, lists, tuples and dicts, in
    attribute-name order."""
    import torch
    if id(obj) in seen:
        return
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        out.append((tuple(obj.shape), str(obj.dtype)) if leaf is None
                   else leaf(obj))
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _tensors(v, out, seen, leaf)
    elif isinstance(obj, dict):
        for k in sorted(obj, key=str):
            _tensors(obj[k], out, seen, leaf)
    elif hasattr(obj, "shape") and hasattr(obj, "__dict__"):
        for k in sorted(vars(obj)):
            _tensors(vars(obj)[k], out, seen, leaf)


def _storage(t) -> Tuple:
    out = (t.data_ptr(), tuple(t.shape), tuple(t.stride()), str(t.dtype),
           str(t.device))
    if t.device.type == "cpu" and t.numel() == 1:
        # a one-element host tensor reaches a CUDA kernel by value, which
        # a graph bakes in: its value keys the graph (a scaled operator's
        # host factor updated in place captures anew, never replays stale)
        out += (t.item(),)
    return out


def storage_signature(obj) -> Tuple:
    """``(data_ptr, shape, stride, dtype, device)`` of every tensor
    reachable from ``obj`` by :func:`op_signature`'s walk. A captured
    graph bakes these addresses in, so two operators of one
    :func:`op_signature` but other tensors never share a graph. A write
    in place keeps an address: the next replay reads the new values, as
    the eager loop would, and the key does not change. A one-element
    host tensor adds its value: a kernel takes it by value, so a graph
    bakes the value, not the address."""
    out: List = []
    _tensors(obj, out, set(), _storage)
    return tuple(out)


def op_signature(Op) -> Tuple:
    """``(class name, shape, dtype, tensors)`` of an operator, or
    ``("custom", class name, ...)`` from its ``aot_signature()`` where it
    defines one."""
    hook = getattr(Op, "aot_signature", None)
    if callable(hook):
        return ("custom", type(Op).__name__, tuple(hook()))
    leaves: List = []
    _tensors(Op, leaves, set())
    return (type(Op).__name__, tuple(Op.shape), str(Op.dtype),
            tuple(leaves))
