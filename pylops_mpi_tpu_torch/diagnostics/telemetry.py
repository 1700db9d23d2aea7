"""In-loop solver telemetry: the scalars of every iteration.

PyTorch counterpart of ``pylops_mpi_tpu/diagnostics/telemetry.py``. The
JAX package stages a ``jax.debug.callback`` in its fused loop bodies; a
host callback each iteration would make every iteration wait for the
device, and no loop could be captured as a CUDA graph. Here the scalars
stay on the device:

- a fused loop that records (:class:`Spec`) carries one more tensor,
  a ``(niter + 2, 1 + width)`` float64 buffer: row ``j`` holds iteration
  ``j``'s index and scalars, written by :func:`iteration` from inside
  the loop's step through the device slot the cost histories use (the
  spare last row once the loop has stopped), so the buffer rides in the
  carry of a captured segment like the cost rows;
- at each host check (every 8 iterations, where the loop reads the
  device anyway) and at the end, :meth:`~..aot.graphs.Loop.fold` copies
  the new rows to the host, appends one sample an iteration to
  :func:`history` and emits a ``solver.<name>`` counter event into the
  trace (``trace.counter``), as the JAX callback does.

The recorded names are the JAX package's: ``resid``, ``k`` and
``alpha`` for cg, cgls, the block solvers and the pipelined engine,
``cost`` and ``xupdate`` for ista and fista; a block solver's scalars
are ``(K,)`` vectors, stored as lists, as are the JAX package's.
``resid`` is the value the solve writes into its cost history, bit for
bit (the same device op on the same inputs, widened exactly to f64).

Gating: ``PYLOPS_MPI_TPU_TORCH_TELEMETRY`` = ``auto`` (default; on
exactly when ``PYLOPS_MPI_TPU_TORCH_TRACE=full``) | ``on`` | ``off``.
Off, no loop carries a buffer and :func:`iteration` returns at once.
:func:`telemetry_signature` is part of a captured loop's key, so a
graph captured with telemetry on is never replayed with it off.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Sequence

from . import trace

__all__ = ["telemetry_enabled", "telemetry_signature", "iteration",
           "history", "clear_history", "Spec"]

_LOCK = threading.Lock()
_HISTORY: Dict[str, List[Dict]] = {}
_warned_mode = False
_tls = threading.local()


def _mode() -> str:
    global _warned_mode
    m = os.environ.get("PYLOPS_MPI_TPU_TORCH_TELEMETRY",
                       "auto").strip().lower()
    if m in ("", "none", "default"):
        m = "auto"
    if m in ("1", "true"):
        m = "on"
    if m in ("0", "false"):
        m = "off"
    if m not in ("auto", "on", "off"):
        if not _warned_mode:
            import warnings
            warnings.warn(
                f"PYLOPS_MPI_TPU_TORCH_TELEMETRY={m!r} is not one of "
                "['auto', 'on', 'off']; using 'auto'", stacklevel=2)
            _warned_mode = True
        m = "auto"
    return m


def telemetry_enabled() -> bool:
    """Per-iteration capture is on: ``on``, or ``auto`` with the tracer
    in ``full`` mode."""
    m = _mode()
    if m == "on":
        return True
    if m == "off":
        return False
    return trace.trace_mode() == "full"


def telemetry_signature() -> tuple:
    """The telemetry state's part of a captured loop's key."""
    return ("telemetry", telemetry_enabled())


class Spec:
    """What one fused loop records: the ``solver`` name its samples go
    under, the scalar ``names`` in order, the ``widths`` of their values
    (1, or ``K`` for a block solver's per-column scalars), and the
    buffer's ``rows`` (``niter + 2``: the iterations, row 0 unused, and a
    spare)."""

    __slots__ = ("solver", "names", "widths", "rows")

    def __init__(self, solver: str, names: Sequence[str], rows: int,
                 widths: Optional[Sequence[int]] = None):
        self.solver = solver
        self.names = tuple(names)
        self.widths = tuple(widths) if widths is not None \
            else (1,) * len(self.names)
        self.rows = int(rows)

    def buffer(self, device):
        """A fresh buffer on ``device``: every row's index ``-1``
        (nothing recorded)."""
        import torch
        buf = torch.zeros((self.rows, 1 + sum(self.widths)),
                          dtype=torch.float64, device=device)
        buf[:, 0] = -1.0
        return buf

    def samples(self, rows) -> List[Dict]:
        """Host samples from a numpy block of recorded rows."""
        out = []
        for row in rows:
            if row[0] < 0:
                continue
            sample = {"iiter": int(row[0])}
            col = 1
            for n, w in zip(self.names, self.widths):
                vals = row[col:col + w]
                sample[n] = float(vals[0]) if w == 1 else \
                    [float(v) for v in vals]
                col += w
            out.append(sample)
        return out


class recording:
    """Within this block, :func:`iteration` writes into ``buf``
    (``None``: nowhere); the graph bank's loops open it around each
    step."""

    __slots__ = ("buf", "_prev")

    def __init__(self, buf):
        self.buf = buf
        self._prev = None

    def __enter__(self):
        self._prev = getattr(_tls, "buf", None)
        _tls.buf = self.buf
        return self

    def __exit__(self, *exc):
        _tls.buf = self._prev
        return False


def iteration(slot, *values) -> None:
    """Record one iteration's scalars from inside a fused loop's step:
    ``slot`` is the ``(1,)`` device row index (the iteration while the
    loop is live, the spare row after), ``values`` the scalars in the
    loop's :class:`Spec` order (0-d, or ``(K,)`` for block solvers).
    Device ops only; returns at once when the loop records nothing."""
    buf = getattr(_tls, "buf", None)
    if buf is None:
        return
    import torch
    row = torch.cat([slot.to(torch.float64).reshape(1)]
                    + [v.detach().to(torch.float64).reshape(-1)
                       for v in values])
    buf.index_copy_(0, slot.reshape(1), row.unsqueeze(0))


def fold(spec: Spec, block) -> int:
    """Append the samples of ``block`` (a numpy array of buffer rows) to
    the history and the trace's counter events; returns how many."""
    samples = spec.samples(block)
    if not samples:
        return 0
    with _LOCK:
        _HISTORY.setdefault(spec.solver, []).extend(samples)
    if trace.trace_mode() != "off":
        for s in samples:
            trace.counter(f"solver.{spec.solver}",
                          {k: v for k, v in s.items()
                           if not isinstance(v, list)})
    return len(samples)


def history(solver: Optional[str] = None):
    """Recorded samples of ``solver`` sorted by ``iiter``, or the whole
    ``{solver: samples}`` table."""
    with _LOCK:
        if solver is not None:
            return sorted(_HISTORY.get(solver, ()),
                          key=lambda s: s["iiter"])
        return {k: sorted(v, key=lambda s: s["iiter"])
                for k, v in _HISTORY.items()}


def clear_history(solver: Optional[str] = None) -> None:
    with _LOCK:
        if solver is None:
            _HISTORY.clear()
        else:
            _HISTORY.pop(solver, None)
