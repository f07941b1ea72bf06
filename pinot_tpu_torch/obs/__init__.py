"""pinot_tpu_torch/obs — end-to-end observability.

Copies of pinot_tpu/obs/{tracing, profiler, prometheus, slowlog}.py
(the profiler's device pull a torch twin) and residency.py (its upload
choke points torch twins); health.py and slo.py wait for the port's
controller.

The instrumentation layer every perf PR reads:

- `tracing`: hierarchical distributed tracing (trace-id/span-id spans
  with parent links, Dapper-style), propagated broker→server inside
  `InstanceRequest` and merged into one trace tree at broker reduce.
- `profiler`: per-query operator profiling (docs scanned, cube-vs-scan
  path, device transfer bytes, kernel dispatch counts) aggregated into
  rolling per-table stats at the broker.
- `prometheus`: text exposition of a `MetricsRegistry` (the
  Monarch/Prometheus pull model; bounded log-scale histograms for
  timers) served from broker, server and controller `/metrics`.
- `slowlog`: sampling JSONL slow-query log with a threshold config.

See docs/OBSERVABILITY.md for the span model, metric naming rules,
exposition endpoints and the slow-log record format.
"""
from pinot_tpu_torch.obs.tracing import (  # noqa: F401
    NoopTraceContext, TraceContext, build_trace_tree, make_trace_context)
from pinot_tpu_torch.obs.profiler import (  # noqa: F401
    QueryProfile, TableStatsAggregator)
from pinot_tpu_torch.obs.prometheus import render_prometheus  # noqa: F401
from pinot_tpu_torch.obs.slowlog import SlowQueryLog  # noqa: F401
