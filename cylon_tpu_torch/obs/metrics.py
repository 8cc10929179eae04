"""The metrics registry: the process-global rollup and the latency
histograms (counterpart of cylon_tpu/obs/metrics.py).

Two stores, both lock-serialized and host-only (nothing here touches a
device):

ROLLUP
    The aggregate ``{name: {count, total_s, max_s, rows, last}}`` that
    ``utils/tracing.report()`` / ``get_count()`` / ``reset_trace()`` read.
    Always on: tests and ``chip_smoke.py`` read these counters.

HISTOGRAMS
    Latency distributions keyed by a string, in the engine the plan
    fingerprint's key (:func:`fingerprint_key`, hoisted onto the cached
    plan entry), so every collect of one plan shape lands in one
    distribution and p50/p95/p99 per query shape read straight from here.
    Buckets are geometric (24 a decade, about 10% relative resolution), so
    the registry is O(buckets), never O(samples). ``LazyFrame.collect()``
    observes into it whether tracing is on or not.

Stable metric names: every counter, gauge and span family the engine
emits is declared in :data:`STABLE_METRICS` with its kind; an undeclared
name is a finding (``tests/test_torch_obs.py`` checks what a q3 run
emits).
"""
from __future__ import annotations

import hashlib
import math
import threading
from collections import OrderedDict, defaultdict
from typing import Dict, Optional, Tuple

from ..utils import envgate as _eg

_lock = threading.Lock()

_ROLLUP: Dict[str, Dict[str, float]] = defaultdict(
    lambda: {"count": 0, "total_s": 0.0, "max_s": 0.0, "rows": 0,
             "last": None}
)


# ----------------------------------------------------------------------
# the process-global rollup (compat surface of utils/tracing.py)
# ----------------------------------------------------------------------
def rollup_span(name: str, dt: float, rows: Optional[int] = None) -> None:
    with _lock:
        s = _ROLLUP[name]
        s["count"] += 1
        s["total_s"] += dt
        s["max_s"] = max(s["max_s"], dt)
        if rows is not None:
            s["rows"] += int(rows)


def rollup_count(name: str, rows: Optional[int] = None) -> None:
    with _lock:
        s = _ROLLUP[name]
        s["count"] += 1
        if rows is not None:
            s["rows"] += int(rows)


def rollup_value(name: str, value: float) -> None:
    with _lock:
        s = _ROLLUP[name]
        s["count"] += 1
        s["total_s"] += float(value)
        s["max_s"] = max(s["max_s"], float(value))
        # the CURRENT gauge value (max_s is the process peak): the
        # Prometheus exposition needs both, and "last is not None" is
        # how the exporter tells a gauge family from a counter
        s["last"] = float(value)


def get_count(name: str) -> int:
    with _lock:
        return int(_ROLLUP[name]["count"]) if name in _ROLLUP else 0


def snapshot() -> Dict[str, Dict[str, float]]:
    """Deep-copied rollup: {name: {count, total_s, max_s, rows}}."""
    with _lock:
        return {k: dict(v) for k, v in _ROLLUP.items()}


def report(prefix: Optional[str] = None) -> Dict[str, Dict[str, float]]:
    stats = snapshot()
    if prefix is None:
        return stats
    return {k: v for k, v in stats.items() if k.startswith(prefix)}


def reset_rollup() -> None:
    with _lock:
        _ROLLUP.clear()


# ----------------------------------------------------------------------
# latency histograms keyed by plan fingerprint
# ----------------------------------------------------------------------
#: geometric bucket resolution: 24 buckets per decade ~= 10% per step:
#: coarse enough to stay O(1) memory per key, fine enough that a p99
#: read-off is within one resolution step of the true sample quantile
BUCKETS_PER_DECADE = 24


class Histogram:
    """Geometric-bucket latency histogram (seconds). NOT thread-safe on
    its own — every registry access serializes under the module lock."""

    __slots__ = ("buckets", "n", "total_s", "min_s", "max_s")

    def __init__(self) -> None:
        self.buckets: Dict[int, int] = {}
        self.n = 0
        self.total_s = 0.0
        self.min_s = math.inf
        self.max_s = 0.0

    def record(self, seconds: float) -> None:
        s = max(float(seconds), 1e-9)
        b = int(math.floor(math.log10(s) * BUCKETS_PER_DECADE))
        self.buckets[b] = self.buckets.get(b, 0) + 1
        self.n += 1
        self.total_s += s
        self.min_s = min(self.min_s, s)
        self.max_s = max(self.max_s, s)

    def quantile(self, q: float) -> float:
        """Upper edge of the bucket holding the q-quantile sample,
        clamped to the observed [min, max] (exact at the extremes)."""
        if not self.n:
            return 0.0
        edge = bucket_quantile(self.buckets, q)
        return min(max(edge, self.min_s), self.max_s)


#: the in-process histogram registry is BOUNDED: a serving process
#: answering a million distinct fingerprints must not grow host memory
#: without limit. LRU order = last observation; capacity scales with the
#: flight-ring knob (the one "how much observability state" dial) at
#: HIST_CAP_PER_RING entries per ring slot, floored at HIST_CAP_MIN.
#: Evicted histograms flush to the persistent observation store when one
#: is configured (obs/store.py) — bounding memory never loses a sample.
_HISTS: "OrderedDict[str, Histogram]" = OrderedDict()
_HIST_LABELS: Dict[str, str] = {}
HIST_CAP_PER_RING = 16
HIST_CAP_MIN = 256


def hist_capacity() -> int:
    """Max in-process latency-histogram keys, derived from
    CYLON_TPU_TORCH_TRACE_RING (read per miss — resizable without restart)."""
    try:
        ring = int(_eg.TRACE_RING.get())
    except ValueError:
        ring = 64
    return max(HIST_CAP_PER_RING * max(ring, 1), HIST_CAP_MIN)


def fingerprint_key(fingerprint) -> str:
    """Stable short key for a plan fingerprint (any reprable value):
    12 hex chars of blake2s over the repr — the histogram / trace-track
    identity of one plan shape within a process.

    The repr walk over a deep plan tuple is NOT free, so the cached
    executor entry hoists its key (``engine.PlanEntry.hist_key``) and a
    cached collect never re-hashes; ``plan.fingerprint.hash`` counts
    every hash performed."""
    rollup_count("plan.fingerprint.hash")
    return hashlib.blake2s(
        repr(fingerprint).encode(), digest_size=6
    ).hexdigest()


def observe_latency(key: str, seconds: float, label: str = "") -> None:
    """Record one query latency under ``key`` (a fingerprint_key, or any
    caller-chosen stable name, e.g. a benchmark row). A NEW key past
    :func:`hist_capacity` LRU-evicts the coldest entries; evicted
    histograms flush to the observation store (outside the lock) so no
    observation is lost when one is configured."""
    evicted = []
    with _lock:
        h = _HISTS.get(key)
        if h is None:
            cap = hist_capacity()
            while len(_HISTS) >= cap:
                k2, h2 = _HISTS.popitem(last=False)
                evicted.append((k2, h2, _HIST_LABELS.pop(k2, "")))
            h = _HISTS[key] = Histogram()
        else:
            _HISTS.move_to_end(key)
        if label and key not in _HIST_LABELS:
            _HIST_LABELS[key] = label
        h.record(seconds)
    if evicted:
        rollup_count("obs.hist.evicted", rows=len(evicted))
        from . import store as _obstore

        if _obstore.store() is not None:
            for k2, h2, lb in evicted:
                _obstore.absorb_histogram(k2, h2, lb)


def latency_quantiles(key: str) -> Optional[Dict[str, float]]:
    """{count, mean_s, p50_s, p95_s, p99_s, max_s} or None (no samples)."""
    with _lock:
        h = _HISTS.get(key)
        if h is None or not h.n:
            return None
        return {
            "count": h.n,
            "mean_s": h.total_s / h.n,
            "p50_s": h.quantile(0.50),
            "p95_s": h.quantile(0.95),
            "p99_s": h.quantile(0.99),
            "max_s": h.max_s,
        }


def latency_report() -> Dict[str, Dict[str, float]]:
    """All keys: {key: {label, count, p50_s, p95_s, p99_s, ...}}."""
    with _lock:
        keys = list(_HISTS)
        labels = dict(_HIST_LABELS)
    out = {}
    for k in keys:
        q = latency_quantiles(k)
        if q is not None:
            q["label"] = labels.get(k, "")
            out[k] = q
    return out


def bucket_quantile(buckets: Dict[int, int], q: float) -> float:
    """THE geometric-bucket quantile read-off (seconds, upper edge of
    the bucket holding the q-quantile sample), unclamped. The one copy:
    :meth:`Histogram.quantile` wraps it with the observed min/max clamp
    and ``obs.store.lat_quantile`` with the profile's, so a bucket-scheme
    change can never skew one consumer alone."""
    n = sum(buckets.values())
    if not n:
        return 0.0
    target = q * n
    acc = 0
    for b in sorted(buckets):
        acc += buckets[b]
        if acc >= target:
            return 10.0 ** ((b + 1) / BUCKETS_PER_DECADE)
    return 0.0


def bucket_snapshot() -> Dict[str, Dict]:
    """Raw per-key histogram buckets: ``{key: {label, n, b: {bucket:
    count}}}``. Bucket counts only grow, so two snapshots DIFF into the
    window's distribution: the SLO monitor's rolling p99 (obs/slo.py)."""
    with _lock:
        return {k: {"label": _HIST_LABELS.get(k, ""), "n": h.n, "b": dict(h.buckets)}
                for k, h in _HISTS.items()}


def reset_latency() -> None:
    with _lock:
        _HISTS.clear()
        _HIST_LABELS.clear()


# ----------------------------------------------------------------------
# the documented stable names
# ----------------------------------------------------------------------
#: name-or-prefix -> (kind, meaning). Prefixes end with "."; a metric is
#: DECLARED when it matches an exact name or starts with a prefix. The
#: names are a compatibility surface: tests and ``chip_smoke.py`` read
#: them, so a rename is made only with its consumers.
STABLE_METRICS: Dict[str, Tuple[str, str]] = {
    "host_sync": ("counter", "device->host count fetches (the sync census)"),
    "sort": ("span", "local sort dispatch"),
    "unique": ("span", "local unique dispatch"),
    "stats.measure": ("span", "on-demand column range-stats kernel"),
    "join.": ("span", "join phases: speculative/fused/pallas_pk/sum_pushdown"),
    "groupby": ("span", "local groupby dispatch"),
    "setop.": ("span", "union/subtract/intersect dispatch"),
    "groupby.": ("span", "groupby phases (emit)"),
    "shuffle.count": ("span", "shuffle count-phase kernel + fetch"),
    "shuffle.exchange": ("span", "whole K-round exchange wall"),
    "shuffle.round.": ("span", "per-round pack/collective/compact dispatch"),
    "shuffle.rounds": ("counter", "round count K per shuffle (rows=K)"),
    "shuffle.overlap_efficiency": (
        "gauge", "fraction of the measured exchange device window "
        "(the exchange's open to its deferred round-count read) spent "
        "issuing overlapped work — host assembly after the fetch is "
        "excluded"),
    "prof.": (
        "mixed", "critical-path profiler (obs/prof.py, CYLON_TPU_TORCH_PROF): "
        "stage_ms.<stage> gauges (per-stage device stage clocks: the "
        "measured window apportioned over per-shard work units fetched "
        "by the existing count phase — zero added syncs) + "
        "straggler_ratio[.<stage>] gauges (max/mean per-shard stage "
        "time; the skew_trigger re-coster's evidence) + the degraded "
        "counter (a profiler failure flips profiling off, never a "
        "query)"),
    "shuffle.exchanged_bytes": (
        "counter", "global collective payload bytes per shuffle (rows="
        "K x world^2 x cap x effective row bytes)"),
    "shuffle.skew_split": (
        "counter", "skew-adaptive schedules applied (rows=heavy-bucket "
        "tail rows relayed through the host instead of padded rounds)"),
    "shuffle.spill.": (
        "mixed", "spill tiers (parallel/spill.py): tier/peak_device_bytes/"
        "host_bytes/disk_bytes gauges; shuffles/staged_rounds/"
        "staged_bytes/relay_bytes/tier2_promotions/ooc_joins counters; "
        "stage/ooc_* spans; I/O degradation ladder: "
        "io_retries / tier_degraded (disk arenas re-planned onto host "
        "RAM) / io_failures (ladder exhausted -> typed SpillIOError) / "
        "reaped_dirs (dead-pid spill dirs reclaimed at context init)"),
    "shuffle.semi_filter.": (
        "mixed", "semi-join gate: selectivity gauge, applied/gate_skipped/"
        "pruned_rows counters, sketch span"),
    "shuffle.quant.": (
        "mixed", "lossy wire tier (ops/quant.py): applied/gate_skipped/"
        "cols/bytes_saved counters + row_bytes_ratio gauge on the "
        "shuffle wire; spill_bytes_saved/spill_reencoded/"
        "relay_bytes_saved counters on the host crossings"),
    "semi_filter.sketch_bytes": ("counter", "sketch collective wire bytes"),
    "lane_pack.": (
        "mixed", "bit-width packing: stats_kernel/sort_fused/join_fused/"
        "groupby_fused counters, wire.* gate counters + ratio gauge"),
    "radix.": (
        "counter", "width-adaptive sort engine: trace_passes (rows = "
        "histogram passes traced per compile, the pass census beside "
        "the bitonic sweep model) + declined (digit planner fell back "
        "to bitonic: float key lane or no width evidence)"),
    "ordering.": (
        "counter", "order-property consumers: sort_elided/dist_sort_elided/"
        "sort_suffix/join_presorted_probe/join_key_order_emit/"
        "setop_sorted_probe/unique_run_detect/groupby_run_detect"),
    "plan.optimize": ("span", "rule rewriting"),
    "plan.lower": ("span", "detach + executor build"),
    "plan.execute": ("span", "lowered plan execution"),
    "plan.node.": ("span", "per-plan-node execution (node_id attr)"),
    "plan.rule.": ("counter", "one bump per optimizer rule firing"),
    "plan.cache.": ("counter", "plan-fingerprint executable cache hit/miss"),
    "plan.fingerprint.hash": (
        "counter", "fingerprint_key hashes performed (hoisted onto the "
        "cached executor entry: flat across cached collects)"),
    "ledger.": (
        "gauge", "resource ledger (obs/resource.py): device_bytes / "
        "live_tables gauges (max_s = process peak watermark); the full "
        "watermark set — host/disk/lease/leaks — is exposed by the "
        "/metrics ledger section, which reads snapshot() directly"),
    "obs.": (
        "counter", "obs-layer internals: hist.evicted (bounded histogram "
        "registry LRU evictions, rows=entries flushed); "
        "journal_degraded (a journal write failed — the store flipped "
        "to in-memory-only telemetry; queries unaffected)"),
    "serve.": (
        "mixed", "query serving (serve/): queue_depth / inflight_bytes / "
        "leases / batch_occupancy gauges; submitted / completed / "
        "backpressure.wait / budget_overflow / batches / singles counters; "
        "batch_cache.hit/miss; the serve.stack and serve.split spans; "
        "batch_fallback, batch_quarantined, worker_died, worker_respawn, "
        "close_orphans"),
    "serve.errors": (
        "counter", "typed query failures (one a future failed with a "
        "CylonError; by scope under serve.errors.<scope>): the error-rate "
        "SLO rule's evidence"),
    "serve.errors.": ("counter", "serve.errors split by failure scope"),
    "serve.shed.": (
        "counter", "admission sheds by reason: admission_budget (one "
        "estimate above the budget), queue_depth (full queue or a "
        "worker-less nowait submit), unconsumed_cap (held results past "
        "twice the budget: a consumer leak)"),
    "autotune.": (
        "counter", "feedback re-coster applications (plan/feedback.py): "
        "semi_forced / semi_skipped / tier_promoted / footprint_admit"),
    "slo.": (
        "mixed", "SLO monitor (obs/slo.py): state.<rule> gauges (0=OK "
        "1=WARN 2=BREACH) and the transitions counter (each transition "
        "also lands a kind='slo' record in the flight ring)"),
    "fault.injected.": (
        "counter", "fault injections delivered per seam "
        "(fault/inject.py; armed via CYLON_TPU_TORCH_FAULTS — zero "
        "in production)"),
    "stream.": (
        "mixed", "streaming ingest and incremental views (stream/): append "
        "counter (rows=batch rows) with append.chunks / append.rejected / "
        "append.rollback; state_bytes gauge (the host state arena after "
        "each append); refresh counter with the refresh.{noop,full,"
        "fallback,inc} mode split and refresh.delta_rows (rows=delta size), "
        "the refresh-against-recompute evidence beside the journaled "
        "latencies; subs / subs.stale / subs.refresh.* subscription "
        "counters; the stream.refresh latency histogram via "
        "observe_latency"),
}


def is_declared(name: str) -> bool:
    """Is a metric name covered by the stable-name table?"""
    if name in STABLE_METRICS:
        return True
    return any(
        name.startswith(p) for p in STABLE_METRICS if p.endswith(".")
    )
