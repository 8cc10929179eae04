"""Query-scoped telemetry (counterpart of cylon_tpu/obs/, without its SLO
rules): span trees, device timing from CUDA events, a metrics registry
with plan-fingerprint latency histograms, and exporters.

- :mod:`.metrics`: the process-global rollup (``utils/tracing``'s
  counters, gauges and spans) and the latency histograms keyed by plan
  fingerprint.
- :mod:`.trace`: the contextvar query trace, one span TREE per query
  (``LazyFrame.collect()``, an eager op chain, or :func:`query_trace`),
  per-query counters, ``attach_result`` and ``analyze_mode`` (the
  ``explain(analyze=True)`` run). On a card spans carry CUDA events,
  read only once completed or at export; no host sync is added.
- :mod:`.export`: the flight-recorder ring of the last N traces, the
  Chrome trace-event export (one track per query, per-shard stage tracks
  for profiled queries), Prometheus text and the ops endpoint
  (``OpsServer``, ``CYLON_TPU_TORCH_METRICS_PORT``).
- :mod:`.resource`: the resource ledger (per-Table weakref finalizers
  over the shards' tensor bytes, host and disk arena watermarks, the
  leak detector).
- :mod:`.prof`: the critical-path profiler (``CYLON_TPU_TORCH_PROF``):
  per-stage, per-shard stage clocks of the shuffle (per axis under two
  hops), the straggler ledger and the critical path.
- :mod:`.store`: the observation journal under
  ``CYLON_TPU_TORCH_OBS_DIR``.

``utils/tracing.py`` is the thin shim over this package.
"""
from . import export, metrics, prof, resource, store, trace  # noqa: F401
from .export import (  # noqa: F401
    OpsServer,
    ensure_ops_server,
    prometheus_text,
    traces,
    validate_prometheus,
    write_chrome,
)
from .metrics import (  # noqa: F401
    fingerprint_key,
    latency_quantiles,
    latency_report,
    observe_latency,
)
from .resource import ResourceLedger, ledger  # noqa: F401
from .trace import QueryTrace, Span, annotate_add, query_trace, tracing_active  # noqa: F401

__all__ = [
    "OpsServer", "QueryTrace", "ResourceLedger", "Span", "annotate_add",
    "ensure_ops_server", "export", "fingerprint_key", "latency_quantiles",
    "latency_report", "ledger", "metrics", "observe_latency", "prof",
    "prometheus_text", "query_trace", "resource", "store", "trace", "traces",
    "tracing_active", "validate_prometheus", "write_chrome",
]
