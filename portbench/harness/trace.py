"""Read a ``torch.profiler`` trace into the numbers the per-layer metrics
take: the device's busy time over the profiled span, its kernels by name,
the device time of the kernels launched inside each of the benchmark's
``record_function`` ranges, and the idle gaps with what the host was doing
meanwhile.

The profiler writes a Chrome trace; each device operation there carries
the correlation id of the runtime call that launched it, and a kernel
belongs to a range when that launch lies inside the range on the host.
"""

from __future__ import annotations

import json
import os
from bisect import bisect_right
from collections import defaultdict
from typing import Dict, List, Tuple

SOLVE_RANGE = "portbench.solve"
RANGE_PREFIX = "portbench."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
# the longest gaps are named by the host operation over them; the rest are
# summed under one name
NAMED_GAPS = 400
# how many host operations that started before a gap are searched for the
# innermost one still running over it
HOST_LOOKBACK = 4000


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _clip(intervals, lo: float, hi: float):
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if b > lo and a < hi]


def summarize(events: List[dict], top: int = 10) -> dict:
    """The profiled span's numbers from Chrome-trace ``events`` (times in
    seconds): ``span_s``, ``busy_s``, ``kernels`` (kernel events whose
    start lies in the span), ``device_ops`` (seconds by name, longest
    first), ``idle_gaps`` (idle seconds by the innermost host operation
    that covered each gap's middle) and ``ranges`` (calls and
    device seconds of each benchmark range). Empty where no solve range was
    traced."""
    launches: Dict[int, float] = {}
    device, host, ranges = [], [], defaultdict(list)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, ts = e.get("cat", ""), float(e.get("ts", 0.0)) * 1e-6
        end = ts + float(e.get("dur", 0.0)) * 1e-6
        if cat in DEVICE_CATS:
            corr = (e.get("args") or {}).get("correlation")
            device.append((ts, end, e.get("name", ""), cat, corr))
        elif cat in HOST_CATS:
            host.append((ts, end, f"{cat}:{e.get('name', '')}"))
            corr = (e.get("args") or {}).get("correlation")
            if cat in ("cuda_runtime", "cuda_driver") and corr is not None:
                launches[corr] = ts
            if cat == "user_annotation" and \
                    e.get("name", "").startswith(RANGE_PREFIX):
                ranges[e["name"]].append((ts, end))
    solves = ranges.pop(SOLVE_RANGE, [])
    if not solves:
        return {}
    lo, hi = min(a for a, _ in solves), max(b for _, b in solves)
    inside = [d for d in device if lo <= d[0] < hi]
    busy = _merge(_clip([(d[0], d[1]) for d in inside], lo, hi))
    by_name: Dict[str, float] = defaultdict(float)
    for d in inside:
        by_name[d[2]] += d[1] - d[0]
    range_stats = {}
    for name, spans in ranges.items():
        spans.sort()
        starts = [a for a, _ in spans]
        t = 0.0
        for d in device:
            at = launches.get(d[4])
            if at is None:
                continue
            i = bisect_right(starts, at) - 1
            if i >= 0 and at <= spans[i][1]:
                t += d[1] - d[0]
        range_stats[name] = {"calls": len(spans), "device_s": t}
    gaps = []
    prev = lo
    for a, b in busy + [(hi, hi)]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    idle: Dict[str, float] = defaultdict(float)
    host.sort()
    host_starts = [h[0] for h in host]
    gaps.sort(key=lambda g: g[0] - g[1])
    for a, b in gaps[NAMED_GAPS:]:
        idle["gaps shorter than the longest named ones"] += b - a
    for a, b in gaps[:NAMED_GAPS]:
        mid = 0.5 * (a + b)
        best = None
        i = bisect_right(host_starts, mid)
        for h in host[max(0, i - HOST_LOOKBACK):i]:
            if h[1] >= mid and (best is None
                                or h[1] - h[0] < best[1] - best[0]):
                best = h
        idle[best[2] if best else "host:outside any operation"] += b - a
    return {
        "span_s": hi - lo,
        "busy_s": sum(b - a for a, b in busy),
        "kernels": sum(1 for d in inside if d[3] == "kernel"),
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:top],
        "idle_gaps": sorted(idle.items(), key=lambda kv: -kv[1])[:top],
        "ranges": range_stats,
    }


def read_chrome_trace(path: str, top: int = 10) -> dict:
    """:func:`summarize` of the trace at ``path``, which is then removed."""
    try:
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        if os.path.exists(path):
            os.remove(path)
    return summarize(events, top)
