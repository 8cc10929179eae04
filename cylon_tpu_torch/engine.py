"""Capacity helpers and the plan cache of the PyTorch port (counterpart of
the capacity and plan-cache parts of cylon_tpu/engine.py).

The port's tables hold exact-length shards, so these capacities size only
the shuffle's exchange buffers (``parallel/shuffle.py``) and the row split
of a table loaded from the host, exactly as the JAX package computes them.
The port compiles no kernels per shape, so the JAX package's jit cache has
no counterpart; its per-context caches of optimized and lowered query
plans (:func:`plan_executable`) and of the serving scheduler's batched
executors (:func:`serve_batch_executable`) do.
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
_BATCH_CACHE_MAX = 64
_CACHE_LOCK = threading.RLock()


def cache_lock(ctx) -> "threading.RLock":
    """The lock guarding the executor caches and the serving scheduler
    held in ``ctx.__dict__`` (one lock for every context: compiles are
    host work of a few milliseconds)."""
    return _CACHE_LOCK


class PlanEntry(NamedTuple):
    """One cached optimize + lower product. ``hist_key`` is the plan's
    latency-histogram key (``obs.metrics.fingerprint_key``), hashed once,
    when the entry is made, not on every collect; ``obs_key`` is the
    observation store's profile key (``feedback.base_key`` of the
    fingerprint without its feedback component, so a tuned decision's
    flip keeps feeding one profile)."""

    opt: Any                  # the optimized (detached) plan
    fired: Tuple[str, ...]    # the optimizer's rule firings, in order
    fn: Callable              # the executor: fn(tables) -> Table
    hist_key: str = ""        # fingerprint_key(fingerprint)
    obs_key: str = ""


def plan_executable(ctx, fingerprint, compile_fn: Callable[[], PlanEntry]):
    """Per-context cache of optimized and lowered plans, keyed by the plan's
    gated fingerprint (node shapes, schemas, world size, scan order
    descriptors, the gates and the tuned decisions; not row counts). A hit
    skips optimize and lower. Returns ``(entry, hit)`` and counts
    ``plan.cache.hit`` / ``plan.cache.miss``."""
    return _cached_compile(ctx, "_plan_cache", fingerprint, compile_fn, "plan.cache",
                           _PLAN_CACHE_MAX)


def serve_batch_executable(ctx, key, compile_fn: Callable):
    """Per-context cache of the serving scheduler's batched executors,
    keyed by ``(fingerprint..., "serve_batch", bucket)``: ``bucket`` is the
    group size rounded up to a power of two, so a fingerprint holds at
    most log2(``CYLON_TPU_TORCH_SERVE_BATCH_MAX``) entries however the
    arrivals mix group sizes. An executor stacks exactly the bindings it
    is given; the bucket only names its cache entry. Counts
    ``serve.batch_cache.hit`` / ``serve.batch_cache.miss``."""
    return _cached_compile(ctx, "_serve_batch_cache", key, compile_fn, "serve.batch_cache",
                           _BATCH_CACHE_MAX)


def _cached_compile(ctx, attr: str, key, compile_fn, counter: str, cap: int):
    """The one copy of the executor-cache discipline of the plan and the
    serving batch tiers: lock-free hits of fully published entries, a
    miss compiled under the lock (so racing threads of a stampede build
    one executor, the others wait and hit), and the oldest entry dropped
    past ``cap`` (literal values are part of fingerprints, so a sweep of
    literals must not grow the cache without bound)."""
    cache = ctx.__dict__.get(attr)
    if cache is None:
        with _CACHE_LOCK:
            cache = ctx.__dict__.setdefault(attr, {})
    entry = cache.get(key)
    if entry is not None:
        bump(counter + ".hit")
        return entry, True
    with _CACHE_LOCK:
        entry = cache.get(key)
        if entry is not None:
            bump(counter + ".hit")
            return entry, True
        bump(counter + ".miss")
        entry = compile_fn()
        if len(cache) >= cap:
            cache.pop(next(iter(cache)))
        cache[key] = entry
        return entry, False
