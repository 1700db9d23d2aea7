"""Cross-rank trace aggregation: one clock-aligned fleet trace.

PyTorch counterpart of ``pylops_mpi_tpu/diagnostics/aggregate.py``. Each
rank dumps its own Chrome-trace JSONL (``PYLOPS_MPI_TPU_TORCH_TRACE_FILE``
or :func:`~.trace.dump`) with timestamps on its host's wall clock (the
profiler's; :mod:`.trace`), which hosts keep only roughly in step, and
the alignment below assumes no more of them than a clock per rank.
This module merges them:

1. **Clock alignment.** Every rank enters the same collectives in the
   same program order, and with tracing on each collective's transfer is
   a ``collective.<name>`` span tagged with its per-name ``seq``
   (:mod:`..parallel.collectives`). Matching span entry times across
   ranks gives per-rank clock deltas; a rank's offset is their median
   over every matched collective, robust to the minority of genuinely
   late entries, which are the signal. (A stall before every collective
   a rank emits reads as a later process start.)
2. **Stragglers.** Each collective matched on two ranks or more gets
   ``skew_us`` (the spread of aligned entries) and ``straggler_rank``
   (the last to arrive).
3. **A merged Chrome trace**, ``pid=rank``, shifted onto one clock.
4. **The critical path** of each ``solver.*`` root span: its chain of
   longest children.

Loaders are tolerant: a killed rank's artifact ends in open ``ph="B"``
spans and perhaps a cut last line; garbage is skipped, never raised.

CLI: ``python -m pylops_mpi_tpu_torch.diagnostics aggregate <paths>``.
"""

from __future__ import annotations

import json
import os
import re
import statistics
from typing import Dict, List, Optional, Sequence, Tuple

from . import trace as _trace

__all__ = ["load_events", "guess_rank", "collective_entries",
           "align_offsets", "merge_traces", "aggregate_files",
           "critical_path", "discover_trace_files"]


def load_events(path: str) -> List[Dict]:
    """Parse one trace artifact (JSONL, a Chrome JSON array, or a
    ``{"traceEvents": [...]}`` object — the CLI's merged-trace output)
    into a list of event dicts. Tolerant: unreadable files yield
    ``[]``; truncated/garbage lines and non-dict entries are skipped;
    events without a ``name`` or a numeric ``ts`` are dropped. Never
    raises on artifact content."""
    try:
        with open(path) as f:
            text = f.read()
    except OSError:
        return []
    events: List[Dict] = []
    candidates = None
    stripped = text.lstrip()
    if stripped.startswith("["):  # chrome-array dump
        try:
            doc = json.loads(stripped)
        except ValueError:
            doc = []
        candidates = doc if isinstance(doc, list) else []
    elif stripped.startswith("{"):
        # one whole-file {"traceEvents": [...]} object — but a JSONL's
        # first line starts with "{" too, so only claim it when the
        # WHOLE text parses to that shape; else fall through to JSONL
        try:
            doc = json.loads(stripped)
            if isinstance(doc, dict) \
                    and isinstance(doc.get("traceEvents"), list):
                candidates = doc["traceEvents"]
        except ValueError:
            pass
    if candidates is None:
        candidates = []
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                candidates.append(json.loads(line))
            except ValueError:
                continue  # truncated final line of a killed worker
    for ev in candidates:
        if not isinstance(ev, dict):
            continue
        if not isinstance(ev.get("name"), str):
            continue
        if not isinstance(ev.get("ts"), (int, float)):
            continue
        events.append(ev)
    return events


_RANK_RE = re.compile(r"(?:rank|worker|proc)[._-]?(\d+)", re.IGNORECASE)


def guess_rank(path: str) -> Optional[int]:
    """Rank inferred from a trace filename (``trace.rank1.jsonl``,
    ``worker0.attempt2.trace.jsonl``, ...), or ``None``."""
    m = None
    for m in _RANK_RE.finditer(os.path.basename(path)):
        pass  # keep the LAST match: "worker0.attempt1" → the worker id
    if m is None:
        return None
    # prefer an explicit "rank"/"worker" over "attempt": re-scan for
    # the first rank/worker-flavored match
    for mm in _RANK_RE.finditer(os.path.basename(path)):
        if mm.group(0).lower().startswith(("rank", "worker", "proc")):
            return int(mm.group(1))
    return int(m.group(1))


def collective_entries(events: Sequence[Dict]) -> Dict[Tuple, float]:
    """``{(name, seq): entry_ts_us}`` for every collective span in one
    rank's events (``cat="collective"``, ``ph`` ``X`` or ``B`` — open
    spans from a post-mortem flush still have a valid entry time).
    Spans without a stamped ``seq`` fall back to their per-name
    occurrence index in buffer order (pre-seq artifacts)."""
    out: Dict[Tuple, float] = {}
    fallback_idx: Dict[str, int] = {}
    for ev in events:
        if not isinstance(ev, dict) \
                or ev.get("cat") != "collective" \
                or ev.get("ph") not in ("X", "B") \
                or not isinstance(ev.get("ts"), (int, float)):
            continue
        name = ev["name"]
        args = ev.get("args")
        seq = args.get("seq") if isinstance(args, dict) else None
        if not isinstance(seq, int):
            seq = fallback_idx.get(name, 0)
            fallback_idx[name] = seq + 1
        key = (name, seq)
        if key not in out:  # first entry wins on duplicates
            out[key] = float(ev["ts"])
    return out


def align_offsets(entries: Dict[int, Dict[Tuple, float]]
                  ) -> Dict[int, float]:
    """Per-rank clock offsets (µs to ADD to a rank's timestamps) that
    put every rank on the reference rank's clock. Reference = lowest
    rank; for each other rank the offset is the median of
    ``ref_entry - rank_entry`` over the collectives both recorded.
    Ranks sharing no collective with the reference get offset 0."""
    if not entries:
        return {}
    ref = min(entries)
    offsets = {ref: 0.0}
    for rank, ents in entries.items():
        if rank == ref:
            continue
        deltas = [entries[ref][k] - ents[k]
                  for k in ents.keys() & entries[ref].keys()]
        offsets[rank] = statistics.median(deltas) if deltas else 0.0
    return offsets


def merge_traces(traces: Dict[int, Sequence[Dict]]) -> Dict:
    """Merge per-rank event lists into one fleet trace. Returns::

        {"events":      clock-aligned merged events, pid=rank,
         "offsets_us":  {rank: applied offset},
         "collectives": [{"name", "seq", "skew_us", "straggler_rank",
                          "entries_us": {rank: aligned entry},
                          "fabric"?: "ici"|"dcn"|"split"}, ...],
         "ranks":       sorted rank list}

    Every collective matched across ≥2 ranks carries ``skew_us`` and
    ``straggler_rank`` — stamped both in the summary list and into the
    merged events' ``args`` so Perfetto shows them on the span."""
    entries = {r: collective_entries(evs) for r, evs in traces.items()}
    offsets = align_offsets(entries)

    # fabric attribution (round 11): the collectives stamp a ``fabric``
    # span tag ("ici"/"dcn" for single-fabric dispatches, "split" for
    # two-level schedules) on classified meshes; lift it onto the
    # matched-collective summary so the fleet view shows which
    # interconnect each straggler analysis rode. First rank's tag wins
    # (the dispatch is SPMD — tags cannot differ across ranks).
    fabrics: Dict[Tuple, str] = {}
    for rank, evs in traces.items():
        fallback_idx: Dict[str, int] = {}
        for ev in evs:
            if not isinstance(ev, dict) or ev.get("cat") != "collective" \
                    or ev.get("ph") not in ("X", "B"):
                continue
            args = ev.get("args") if isinstance(ev.get("args"), dict) \
                else {}
            seq = args.get("seq")
            if not isinstance(seq, int):
                seq = fallback_idx.get(ev["name"], 0)
                fallback_idx[ev["name"]] = seq + 1
            fab = args.get("fabric")
            if isinstance(fab, str):
                fabrics.setdefault((ev["name"], seq), fab)

    # per-collective skew/straggler from ALIGNED entry times
    per_key: Dict[Tuple, Dict[int, float]] = {}
    for rank, ents in entries.items():
        off = offsets.get(rank, 0.0)
        for key, ts in ents.items():
            per_key.setdefault(key, {})[rank] = ts + off
    collectives = []
    stamp: Dict[Tuple, Dict] = {}
    for key in sorted(per_key, key=lambda k: (k[0], k[1])):
        aligned = per_key[key]
        if len(aligned) < 2:
            continue
        lo, hi = min(aligned.values()), max(aligned.values())
        straggler = max(aligned, key=lambda r: aligned[r])
        rec = {"name": key[0], "seq": key[1],
               "skew_us": round(hi - lo, 3),
               "straggler_rank": straggler,
               "entries_us": {str(r): round(t, 3)
                              for r, t in sorted(aligned.items())}}
        if key in fabrics:
            rec["fabric"] = fabrics[key]
        collectives.append(rec)
        stamp[key] = rec

    merged: List[Dict] = []
    for rank in sorted(traces):
        off = offsets.get(rank, 0.0)
        merged.append({"name": "process_name", "ph": "M", "pid": rank,
                       "args": {"name": f"rank{rank}"}})
        fallback_idx: Dict[str, int] = {}
        for ev in traces[rank]:
            if not isinstance(ev, dict) or not isinstance(
                    ev.get("ts"), (int, float)):
                continue  # tolerate raw (unloaded) event lists too
            ev = dict(ev)
            args = dict(ev["args"]) if isinstance(ev.get("args"),
                                                  dict) else {}
            args["worker_pid"] = ev.get("pid")
            ev["ts"] = round(float(ev["ts"]) + off, 3)
            ev["pid"] = rank
            if ev.get("cat") == "collective" and ev.get("ph") in ("X",
                                                                  "B"):
                seq = args.get("seq")
                if not isinstance(seq, int):
                    seq = fallback_idx.get(ev["name"], 0)
                    fallback_idx[ev["name"]] = seq + 1
                rec = stamp.get((ev["name"], seq))
                if rec is not None:
                    args["skew_us"] = rec["skew_us"]
                    args["straggler_rank"] = rec["straggler_rank"]
            ev["args"] = args
            merged.append(ev)
    merged.sort(key=lambda e: e.get("ts", 0.0))
    return {"events": merged, "offsets_us": {r: round(o, 3)
                                             for r, o in offsets.items()},
            "collectives": collectives, "ranks": sorted(traces)}


def critical_path(events: Sequence[Dict]) -> List[Dict]:
    """Per solver root span (``solver.*``), the max-duration child
    chain: ``[{"solver", "pid", "dur_us", "path": [{"name",
    "dur_us"}, ...]}, ...]`` — the critical-path summary per solve.
    Uses the hardened :func:`~.trace.span_tree`, so post-mortem artifacts are fine."""
    # span_tree scans per-thread; group per pid first so two ranks'
    # same-tid events don't interleave into one bogus tree
    by_pid: Dict = {}
    for ev in events:
        if isinstance(ev, dict):
            by_pid.setdefault(ev.get("pid"), []).append(ev)
    out = []
    for pid in sorted(by_pid, key=lambda p: (p is None, p)):
        for root in _trace.span_tree(by_pid[pid]):
            if not str(root.get("name", "")).startswith("solver."):
                continue
            path = []
            node = root
            while node.get("children"):
                node = max(node["children"],
                           key=lambda n: n.get("dur") or 0.0)
                path.append({"name": node["name"],
                             "dur_us": node.get("dur")})
            out.append({"solver": root["name"], "pid": pid,
                        "dur_us": root.get("dur"), "path": path})
    return out


def discover_trace_files(paths: Sequence[str]) -> List[str]:
    """Expand directories into their ``*.jsonl``/``*.trace`` files
    (sorted); plain files pass through. Missing paths are skipped —
    the tolerant-loader rule applies to discovery too."""
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for name in sorted(os.listdir(p)):
                if name.endswith((".jsonl", ".trace")) \
                        and "trace" in name.lower():
                    out.append(os.path.join(p, name))
        elif os.path.exists(p):
            out.append(p)
    return out


def aggregate_files(paths: Sequence[str],
                    ranks: Optional[Sequence[int]] = None) -> Dict:
    """Load + merge trace artifacts (see :func:`merge_traces`).
    ``ranks`` overrides rank assignment; else filenames are parsed
    (:func:`guess_rank`) with positional fallback. Adds a
    ``critical_path`` summary and per-file provenance."""
    files = discover_trace_files(paths)
    traces: Dict[int, List[Dict]] = {}
    sources: Dict[int, str] = {}
    for i, path in enumerate(files):
        if ranks is not None and i < len(ranks):
            rank = int(ranks[i])
        else:
            g = guess_rank(path)
            rank = g if g is not None and g not in traces else i
        while rank in traces:  # collision → next free positional slot
            rank += 1
        traces[rank] = load_events(path)
        sources[rank] = path
    result = merge_traces(traces)
    result["sources"] = {str(r): sources[r] for r in sorted(sources)}
    result["critical_path"] = critical_path(result["events"])
    return result
