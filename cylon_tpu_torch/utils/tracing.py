"""The thin shim over :mod:`cylon_tpu_torch.obs` (counterpart of
cylon_tpu/utils/tracing.py).

``bump`` counts an event (``rows=`` adds to its ``rows`` total),
``gauge`` records a measured value (``total_s``/``max_s``/``last`` hold
its sum, peak and latest), ``span`` times a block, ``report(prefix)``,
``get_count`` and ``get_trace_report`` read the process-global rollup,
``reset_trace`` clears it. Each of them also feeds the active query
trace (``obs/trace.py``) when one is open. The flight ring and the
latency histograms are separate stores (``obs.export.reset_ring()``,
``obs.metrics.reset_latency()``).
"""
from __future__ import annotations

from typing import Dict

from ..obs.metrics import get_count, report, reset_rollup, snapshot
from ..obs.trace import (  # noqa: F401  (the instrumentation surface)
    annotate_add,
    bump,
    gauge,
    profile,
    span,
    trace_enabled,
    tracing_active,
)

__all__ = [
    "annotate_add", "bump", "gauge", "get_count", "get_trace_report",
    "profile", "report", "reset_trace", "span", "trace_enabled",
    "tracing_active",
]


def get_trace_report() -> Dict[str, Dict[str, float]]:
    """Aggregated span stats: {name: {count, total_s, max_s, rows, last}}."""
    return snapshot()


def reset_trace() -> None:
    """Clear the process-global rollup."""
    reset_rollup()
