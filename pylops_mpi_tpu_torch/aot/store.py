"""The knob of the captured-program tier and its in-memory bank.

PyTorch counterpart of the in-process half of
``pylops_mpi_tpu/aot/store.py``: :func:`aot_mode` reads
``PYLOPS_MPI_TPU_TORCH_AOT`` with the JAX package's values and warning,
and ``_MEM`` holds the banked entries (:mod:`.graphs` writes them): at
most ``_MEM_MAX`` of them, the least recently used evicted first, as the
JAX package bounds ``_FUSED_CACHE`` (``solvers/basic.py:744-822``). An
entry pins its operator, its preconditioner and its graph's memory, and
every fresh operator instance makes new keys, so without the bound a
process that builds operators over and over would fill the card.

The JAX package's disk bank (serialized executables, ``bank_dir``,
the index file and its locks) and ``compile_cache.py`` (XLA's
persistent cache) have no counterpart. A CUDA graph lives in the process
that captured it and holds raw device addresses, so nothing of it can be
written to disk and loaded by another process. A fresh process's first
request stays prewarm's job (``serving/engine.py``).
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Any, Optional, Tuple

__all__ = ["aot_mode", "aot_enabled", "mem_get", "mem_put", "mem_entries",
           "clear_memory"]

_AOT_MODES = ("auto", "on", "off")
_LOCK = threading.Lock()
_MEM: "OrderedDict[Tuple, Any]" = OrderedDict()
_MEM_MAX = 32
_warned_mode = False


def aot_mode() -> str:
    """``PYLOPS_MPI_TPU_TORCH_AOT`` resolved to ``auto``/``on``/``off``
    (default ``off``: the solvers' loops run eagerly, as before the
    tier existed); an unknown value warns once and falls back to
    ``off``."""
    global _warned_mode
    m = os.environ.get("PYLOPS_MPI_TPU_TORCH_AOT", "off").strip().lower()
    if m in ("", "none", "default", "0"):
        m = "off"
    if m == "1":
        m = "on"
    if m not in _AOT_MODES:
        if not _warned_mode:
            import warnings
            warnings.warn(f"PYLOPS_MPI_TPU_TORCH_AOT={m!r} is not one of "
                          f"{_AOT_MODES}; using 'off'", stacklevel=2)
            _warned_mode = True
        m = "off"
    return m


def aot_enabled() -> bool:
    """``on`` arms the tier, ``off`` disarms it. The JAX package's
    ``auto`` arms only when a disk bank is named; the port has no disk
    bank (module docstring), so ``auto`` resolves to off."""
    return aot_mode() == "on"


def mem_get(key: Tuple) -> Optional[Any]:
    """The entry banked under ``key`` (now the most recently used), or
    ``None``."""
    with _LOCK:
        entry = _MEM.get(key)
        if entry is not None:
            _MEM.move_to_end(key)
        return entry


def mem_put(key: Tuple, entry: Any) -> None:
    """Bank ``entry``; past ``_MEM_MAX`` entries, drop the least recently
    used ones whose ``lock`` no solve holds."""
    with _LOCK:
        _MEM[key] = entry
        _MEM.move_to_end(key)
        for k in [k for k, e in _MEM.items() if not e.lock.locked()]:
            if len(_MEM) <= _MEM_MAX:
                break
            del _MEM[k]


def mem_entries() -> Tuple[Any, ...]:
    with _LOCK:
        return tuple(_MEM.values())


def clear_memory() -> None:
    """Drop every banked entry (their graphs, buffers and the operators
    they keep alive) and re-arm the one-time warning."""
    global _warned_mode
    with _LOCK:
        _MEM.clear()
    _warned_mode = False
