"""Runtime observability: spans, metrics, stage budgets.

PyTorch counterpart of ``pylops_mpi_tpu/diagnostics``, three of its
modules: :mod:`.trace` (the span tracer), :mod:`.metrics` (the
process-wide registry with its periodic snapshot) and :mod:`.profiler`
(the stage-budget table, the deadline runner and ``torch.profiler``
capture). The cost model, the in-loop telemetry and the trace
aggregator are ROADMAP.md §A.7.
"""

from . import metrics, profiler, trace
from .metrics import (metrics_mode, metrics_enabled, inc, set_gauge,
                      observe, timer, snapshot, clear_metrics,
                      write_snapshot, read_snapshot, hist_quantiles)
from .profiler import (STAGE_BUDGETS, stage_budget, DeadlineRunner,
                       StageRecord, profile_capture)
from .trace import (trace_mode, trace_enabled, span, op_span, event, counter,
                    get_events, clear_events, dump, span_tree)

__all__ = [
    "trace", "metrics", "profiler",
    "metrics_mode", "metrics_enabled", "inc", "set_gauge", "observe",
    "timer", "snapshot", "clear_metrics", "write_snapshot",
    "read_snapshot", "hist_quantiles",
    "trace_mode", "trace_enabled", "span", "op_span", "event", "counter",
    "get_events", "clear_events", "dump", "span_tree",
    "STAGE_BUDGETS", "stage_budget", "DeadlineRunner", "StageRecord",
    "profile_capture",
]
