"""Benchmark decorator, region marks, the timer of the tuner, and
``torch.profiler`` capture.

PyTorch counterpart of ``pylops_mpi_tpu/utils/benchmark.py`` (itself a
rebuild of the reference's ``pylops_mpi/utils/benchmark.py:25-173``): a
``@benchmark`` decorator with in-function :func:`mark` region markers
printed as a span tree with per-segment shares, :func:`time_callable`
(the timing primitive of :mod:`..tuning.search`), and
:func:`profile_trace`.

The sync before each clock read is the reference's
(``benchmark.py:70-73``): under a process group a ``dist.barrier()``
first, then ``torch.cuda.synchronize`` on the device of every CUDA
tensor among the values seen (distributed vectors and tuples of them
included). PyTorch launches CUDA work asynchronously, so a clock read
without it would time the host's enqueue only.

``BENCH_PYLOPS_MPI=0`` (the reference's kill switch) or
``BENCH_PYLOPS_MPI_TPU=0`` turn the decorator and the marks into no-ops;
:func:`time_callable` always times.
"""

from __future__ import annotations

import functools
import logging
import os
import time
from contextlib import contextmanager
from typing import Callable, List, Optional

__all__ = ["benchmark", "mark", "profile_trace", "time_callable"]


def _enabled() -> bool:
    flag = os.getenv("BENCH_PYLOPS_MPI_TPU",
                     os.getenv("BENCH_PYLOPS_MPI", "1"))
    return int(flag) == 1


# open spans of nested @benchmark calls, innermost last
_span_stack: List["_Span"] = []


class _Span:
    """One timed region: its extent, its marks and its nested spans."""

    __slots__ = ("label", "t0", "t1", "marks", "children")

    def __init__(self, label: str):
        self.label = label
        self.t0 = 0.0
        self.t1 = 0.0
        self.marks: List = []      # (label, timestamp)
        self.children: List["_Span"] = []

    @property
    def total(self) -> float:
        return self.t1 - self.t0

    def segments(self):
        """Durations between consecutive marks, from the span's start to
        its end."""
        edges = [("start", self.t0)] + self.marks + [("end", self.t1)]
        for (a, ta), (b, tb) in zip(edges, edges[1:]):
            yield a, b, tb - ta

    def render(self, lines: List[str], depth: int = 0) -> List[str]:
        pad = "  " * depth
        lines.append(f"{pad}[{self.label}] total {self.total:.6f} s\n")
        if self.marks:
            for a, b, dt in self.segments():
                pct = 100.0 * dt / self.total if self.total > 0 else 0.0
                lines.append(f"{pad}  {a} => {b}: {dt:.6f} s ({pct:.1f}%)\n")
        for child in self.children:
            child.render(lines, depth + 1)
        return lines


def _devices(v, out: set) -> set:
    """The CUDA devices of the tensors in ``v``."""
    import torch
    from ..distributedarray import DistributedArray
    from ..stacked import StackedDistributedArray
    if isinstance(v, torch.Tensor):
        if v.is_cuda:
            out.add(v.device)
    elif isinstance(v, DistributedArray):
        _devices(v.array, out)
    elif isinstance(v, StackedDistributedArray):
        for d in v.distarrays:
            _devices(d, out)
    elif isinstance(v, (tuple, list)):
        for x in v:
            _devices(x, out)
    elif isinstance(v, dict):
        for x in v.values():
            _devices(x, out)
    return out


def _sync(values=()) -> None:
    """Wait for the group (a barrier) and for the devices of ``values``
    (the reference's ``Barrier`` and CUDA device sync)."""
    import torch
    from ..parallel.mesh import initialized
    if initialized():
        import torch.distributed as dist
        dist.barrier()
    for dev in _devices(values, set()):
        torch.cuda.synchronize(dev)


def mark(label: str, *values) -> None:
    """A segment boundary inside a ``@benchmark``-ed function (ref
    ``benchmark.py:76-90``): ``values`` are waited for first, so device
    work is charged to the segment that launched it."""
    if not _enabled():
        return
    if not _span_stack:
        raise RuntimeError("mark() called outside of a benchmarked region")
    _sync(values)
    _span_stack[-1].marks.append((label, time.perf_counter()))


def benchmark(func: Optional[Callable] = None, description: str = "",
              logger: Optional[logging.Logger] = None):
    """Decorator timing a call from start to end, with nested
    :func:`mark` support (ref ``benchmark.py:92-173``); the outermost
    call prints (or logs) its span tree."""

    def noop_decorator(f):
        @functools.wraps(f)
        def wrapped(*args, **kwargs):
            return f(*args, **kwargs)
        return wrapped

    def actual_decorator(f):
        @functools.wraps(f)
        def wrapped(*args, **kwargs):
            span = _Span(description or f.__name__)
            _sync((args, kwargs))
            if _span_stack:
                _span_stack[-1].children.append(span)
            _span_stack.append(span)
            span.t0 = time.perf_counter()
            try:
                out = f(*args, **kwargs)
                _sync((out,))
            finally:
                span.t1 = time.perf_counter()
                _span_stack.pop()
            if not _span_stack:
                text = "".join(span.render([]))
                if logger is not None:
                    logger.info("\n" + text)
                else:
                    print(text, end="")
            return out
        return wrapped

    if not _enabled():
        return noop_decorator if func is None else noop_decorator(func)
    if func is not None:
        return actual_decorator(func)
    return actual_decorator


def time_callable(fn: Callable, repeats: int = 3, warmup: int = 1):
    """Time a zero-argument callable with the module's sync on what it
    returns: ``warmup`` unrecorded calls, then ``repeats`` timed ones.
    Returns ``{"best_s", "mean_s", "times_s", "compile_s"}``;
    ``compile_s`` is the first warm-up call's wall (``None`` without
    one): the call that builds a kernel or captures a graph."""
    compile_s = None
    for i in range(max(0, int(warmup))):
        t0 = time.perf_counter()
        _sync((fn(),))
        if i == 0:
            compile_s = time.perf_counter() - t0
    times = []
    for _ in range(max(1, int(repeats))):
        t0 = time.perf_counter()
        out = fn()
        _sync((out,))
        times.append(time.perf_counter() - t0)
    return {"best_s": min(times),
            "mean_s": sum(times) / len(times),
            "times_s": times,
            "compile_s": compile_s}


@contextmanager
def profile_trace(logdir: str):
    """A ``torch.profiler`` capture of the region (CPU and, where a card
    is present, CUDA activity), written into ``logdir`` as a Chrome
    trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace.{os.getpid()}.{int(time.time() * 1e3)}.json"))
