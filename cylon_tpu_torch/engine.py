"""Capacity helpers and the plan cache of the PyTorch port (counterpart of
the capacity and plan-cache parts of cylon_tpu/engine.py).

The port's tables hold exact-length shards, so these capacities size only
the shuffle's exchange buffers (``parallel/shuffle.py``) and the row split
of a table loaded from the host, exactly as the JAX package computes them.
The port compiles no kernels per shape, so the JAX package's jit cache has
no counterpart; its per-context cache of optimized and lowered query plans
does (:func:`plan_executable`).
"""
from __future__ import annotations

import threading
from typing import Any, Callable, NamedTuple, Tuple

import numpy as np

from .utils.tracing import bump


def round_cap(n: int, minimum: int = 8) -> int:
    """Round a capacity up to a power of two (>= minimum)."""
    n = max(int(n), minimum)
    return 1 << (n - 1).bit_length()


def shard_caps(total_rows: int, world: int) -> Tuple[np.ndarray, int]:
    """Even row split of a global table: (per-shard counts [P], shard cap)."""
    base, rem = divmod(int(total_rows), world)
    counts = np.array([base + (1 if i < rem else 0) for i in range(world)], np.int64)
    return counts, round_cap(counts.max() if world else 0)


# ----------------------------------------------------------------------
# plan-fingerprint executable cache (plan/lazy.py)
# ----------------------------------------------------------------------
_PLAN_CACHE_MAX = 256
_CACHE_LOCK = threading.Lock()


class PlanEntry(NamedTuple):
    """One cached optimize + lower product. ``hist_key`` is the plan's
    latency-histogram key (``obs.metrics.fingerprint_key``), hashed once,
    when the entry is made, not on every collect; ``obs_key`` is the
    observation store's profile key (the same fingerprint's key: the port
    has no feedback component to leave out)."""

    opt: Any                  # the optimized (detached) plan
    fired: Tuple[str, ...]    # the optimizer's rule firings, in order
    fn: Callable              # the executor: fn(tables) -> Table
    hist_key: str = ""        # fingerprint_key(fingerprint)
    obs_key: str = ""


def plan_executable(ctx, fingerprint, compile_fn: Callable[[], PlanEntry]):
    """Per-context cache of optimized and lowered plans, keyed by the plan's
    gated fingerprint (node shapes, schemas, world size, scan order
    descriptors, the ordering, semi-filter and lane-packing gates; not row
    counts). A hit skips optimize
    and lower. Returns ``(entry, hit)`` and counts ``plan.cache.hit`` /
    ``plan.cache.miss``. A miss compiles under a lock, so racing threads
    compile one plan once; the oldest entry goes past 256 (literal values
    are part of fingerprints, so a sweep of literals must not grow the
    cache without bound)."""
    cache = ctx.__dict__.setdefault("_plan_cache", {})
    entry = cache.get(fingerprint)
    if entry is not None:
        bump("plan.cache.hit")
        return entry, True
    with _CACHE_LOCK:
        entry = cache.get(fingerprint)
        if entry is not None:
            bump("plan.cache.hit")
            return entry, True
        bump("plan.cache.miss")
        entry = compile_fn()
        if len(cache) >= _PLAN_CACHE_MAX:
            cache.pop(next(iter(cache)))
        cache[fingerprint] = entry
        return entry, False
