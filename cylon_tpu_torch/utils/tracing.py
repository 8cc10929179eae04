"""Process-global counters and spans (counterpart of cylon_tpu/utils/tracing.py).

The JAX package's tracer is the rollup dict of its ``obs/`` layer; the port
keeps only that rollup: ``bump`` counts an event, ``span`` times a block,
``report(prefix)`` and ``get_count`` read them, ``reset_trace`` clears
them. The planner counts its rule firings here (``plan.rule.<rule>``) and
its plan cache (``plan.cache.hit`` / ``plan.cache.miss``), and the
order-descriptor consumers their fast paths (``ordering.*``); nothing in
the package times a span yet. The structured layer (per-query span trees,
exporters, latency histograms) is ROADMAP.md A9.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, Iterator

_LOCK = threading.Lock()
_ROLLUP: Dict[str, Dict[str, float]] = {}


def _entry(name: str) -> Dict[str, float]:
    e = _ROLLUP.get(name)
    if e is None:
        e = _ROLLUP[name] = {"count": 0, "total_s": 0.0, "max_s": 0.0}
    return e


def bump(name: str) -> None:
    """Count one ``name`` event."""
    with _LOCK:
        _entry(name)["count"] += 1


@contextmanager
def span(name: str) -> Iterator[None]:
    """Time the block on the host clock under ``name``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _LOCK:
            e = _entry(name)
            e["count"] += 1
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
