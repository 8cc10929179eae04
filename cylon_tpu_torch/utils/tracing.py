"""Process-global counters and spans (counterpart of cylon_tpu/utils/tracing.py).

The JAX package's tracer is the rollup dict of its ``obs/`` layer; the port
keeps only that rollup: ``bump`` counts an event (``rows=`` adds to its
``rows`` total), ``gauge`` records a measured value (``total_s``/``max_s``/
``last`` hold its sum, peak and latest), ``span`` times a block,
``report(prefix)`` and ``get_count`` read them, ``reset_trace`` clears
them. The planner counts its rule firings here (``plan.rule.<rule>``) and
its plan cache (``plan.cache.hit`` / ``plan.cache.miss``), and the
order-descriptor consumers their fast paths (``ordering.*``), the shuffle
its semi-join filter (``shuffle.semi_filter.*``) and lane packing its
fusions and wire narrowing (``lane_pack.*``). The one span is the
semi-join sketch build (``shuffle.semi_filter.sketch``). The structured
layer (per-query span trees, exporters, latency histograms) is ROADMAP.md
A9.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, Iterator, Optional

_LOCK = threading.Lock()
_ROLLUP: Dict[str, Dict[str, float]] = {}


def _entry(name: str) -> Dict[str, float]:
    e = _ROLLUP.get(name)
    if e is None:
        e = _ROLLUP[name] = {"count": 0, "total_s": 0.0, "max_s": 0.0, "rows": 0}
    return e


def bump(name: str, rows: Optional[int] = None) -> None:
    """Count one ``name`` event; ``rows`` adds to the event's row total."""
    with _LOCK:
        e = _entry(name)
        e["count"] += 1
        if rows is not None:
            e["rows"] += int(rows)


def gauge(name: str, value: float) -> None:
    """Record a measured value (a ratio, not a duration)."""
    with _LOCK:
        e = _entry(name)
        e["count"] += 1
        e["total_s"] += float(value)
        e["max_s"] = max(e["max_s"], float(value))
        e["last"] = float(value)


@contextmanager
def span(name: str, rows: Optional[int] = None) -> Iterator[None]:
    """Time the block on the host clock under ``name`` (``rows`` as in
    :func:`bump`)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _LOCK:
            e = _entry(name)
            e["count"] += 1
            if rows is not None:
                e["rows"] += int(rows)
            e["total_s"] += dt
            e["max_s"] = max(e["max_s"], dt)


def get_count(name: str) -> int:
    with _LOCK:
        e = _ROLLUP.get(name)
        return int(e["count"]) if e else 0


def report(prefix: str = "") -> Dict[str, Dict[str, float]]:
    """{name: {count, total_s, max_s}} of every name under ``prefix``."""
    with _LOCK:
        return {k: dict(v) for k, v in _ROLLUP.items() if k.startswith(prefix)}


def reset_trace() -> None:
    with _LOCK:
        _ROLLUP.clear()
