"""Query-scoped trace contexts: structured span trees per query
(counterpart of cylon_tpu/obs/trace.py).

A ``contextvars.ContextVar`` carries the ACTIVE :class:`QueryTrace`:
every ``span``/``bump``/``gauge`` lands in (a) the process-global rollup
(:mod:`.metrics`) and (b) the active query's own span tree and counters.
Contextvars are per-thread, so two threads running queries build two
disjoint trees; the rollup stays the cross-query sum.

Trace contexts open at:

- ``LazyFrame.collect()``: one trace per plan execution, labeled with the
  plan-fingerprint key;
- any OUTERMOST eager-op span when tracing is enabled: one trace per
  eager op chain's top-level op;
- explicitly, via :func:`query_trace` (``force=True`` ignores the env
  gate; ``explain(analyze=True)`` uses it).

Device time without a new sync. The JAX package stamps a query's end when
its deferred count fetch returns; the port's row counts are always known
on the host, so a result resolves when it is attached. Where work runs on
a card, a trace and each of its spans record a pair of
``torch.cuda.Event(enable_timing=True)`` on the current stream at open
and close; they are read only once they have completed (``query()``:
after a host read the engine already makes has passed them) or at export
(:mod:`.export` waits on them there). The tracer adds no
``synchronize``, ``.item()`` or ``.cpu()`` to a traced call: the
``host_sync`` counter reads the same with tracing on and off. On the
CPU spans carry host times only.

Disabled cost: with tracing off and no active trace, ``span()`` takes the
fast path: one contextvar read, one perf_counter pair, one locked rollup
update; no Span/QueryTrace allocation and no event.
"""
from __future__ import annotations

import contextlib
import itertools
import sys
import threading
import time
from contextvars import ContextVar
from typing import Any, Dict, Iterator, List, Optional

from ..utils import envgate as _eg
from . import export as _export
from . import metrics as _metrics
from . import store as _obsstore

_ACTIVE: "ContextVar[Optional[QueryTrace]]" = ContextVar(
    "cylon_tpu_torch_query_trace", default=None
)
_ANALYZE: "ContextVar[bool]" = ContextVar("cylon_tpu_torch_analyze", default=False)


def device_event():
    """A timing event recorded on the current CUDA stream, or None where
    no card is in use (the CPU, or a process that never touched CUDA)."""
    import torch

    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def event_ms(ev0, ev1, wait: bool = False) -> Optional[float]:
    """Device milliseconds between two recorded events: None without
    events, or (``wait`` False) while the later one is still queued;
    ``wait`` (export only) waits for it."""
    if ev0 is None or ev1 is None:
        return None
    if not ev1.query():
        if not wait:
            return None
        ev1.synchronize()
    return float(ev0.elapsed_time(ev1))
_QIDS = itertools.count(1)


def trace_enabled() -> bool:
    """Per-span stderr logging gate: ``CYLON_TPU_TORCH_TRACE=1``."""
    return _eg.TRACE.get() == "1"


def tracing_active() -> bool:
    """Structured query-trace gate: any truthy CYLON_TPU_TORCH_TRACE value.
    ``=1`` traces AND logs each span; ``=tree`` (or any other truthy
    value) builds span trees + the flight ring without the stderr
    firehose."""
    return _eg.TRACE.truthy()


class Span:
    """One timed phase inside a query trace. ``attrs`` carries structured
    annotations (rows, collective bytes, node ids, gate decisions);
    ``counters`` holds the bumps that fired while this span was the
    innermost open one — {name: [count, rows]}. ``ev0``/``ev1`` are the
    span's CUDA timing events (None on the CPU)."""

    __slots__ = ("name", "t0", "t1", "rows", "attrs", "counters", "children", "ev0", "ev1")

    def __init__(self, name: str, t0: float, rows: Optional[int],
                 attrs: Optional[Dict[str, Any]]):
        self.name = name
        self.t0 = t0
        self.t1: Optional[float] = None
        self.ev0 = device_event()
        self.ev1 = None
        self.rows = rows
        self.attrs: Dict[str, Any] = dict(attrs) if attrs else {}
        self.counters: Dict[str, List[int]] = {}
        self.children: List["Span"] = []

    def dur_s(self) -> float:
        return max((self.t1 if self.t1 is not None else self.t0) - self.t0, 0.0)

    def device_ms(self, wait: bool = False) -> Optional[float]:
        """The span's device milliseconds from its events (see
        :func:`event_ms`); None on the CPU."""
        return event_ms(self.ev0, self.ev1, wait)

    def walk(self) -> Iterator["Span"]:
        yield self
        for c in self.children:
            yield from c.walk()


class QueryTrace:
    """One query's structured trace: a span tree plus per-query counters
    and gauges. Single-threaded by construction (the contextvar confines
    a trace to the thread that opened it); lifecycle::

        open --(spans/bumps)--> closed --(an attached result
        resolves, when one is pending)--> finished

    ``finished`` traces go to the flight-recorder ring (:mod:`.export`).
    The port's results carry host-known counts, so an attached result
    resolves at once; ``ev0``/``ev1`` bracket the query on the card."""

    __slots__ = (
        "qid", "name", "kind", "hist_key", "obs_key", "label", "thread",
        "t0", "t1", "resolved", "closed", "finished", "pending",
        "spans", "_stack", "counters", "values", "attrs", "ev0", "ev1",
    )

    def __init__(self, name: str, kind: str = "query"):
        self.qid = next(_QIDS)
        self.name = name
        self.kind = kind
        self.hist_key: Optional[str] = None
        self.obs_key: Optional[str] = None
        self.label = name
        self.thread = threading.get_ident()
        self.t0 = time.perf_counter()
        self.t1: Optional[float] = None
        self.resolved: Optional[float] = None
        self.closed = False
        self.finished = False
        self.pending = False
        self.spans: List[Span] = []
        self._stack: List[Span] = []
        self.counters: Dict[str, List[int]] = {}
        self.values: Dict[str, float] = {}
        self.attrs: Dict[str, Any] = {}
        self.ev0 = device_event()
        self.ev1 = None

    # -- span plumbing (called only from this thread's span()) ---------
    def _open(self, name, rows, attrs) -> Span:
        sp = Span(name, time.perf_counter(), rows, attrs)
        (self._stack[-1].children if self._stack else self.spans).append(sp)
        self._stack.append(sp)
        return sp

    def _close(self, sp: Span) -> None:
        sp.ev1 = device_event() if sp.ev0 is not None else None
        sp.t1 = time.perf_counter()
        if self._stack and self._stack[-1] is sp:
            self._stack.pop()
        elif sp in self._stack:  # pragma: no cover - unbalanced exit
            self._stack.remove(sp)

    def _count(self, name: str, rows: Optional[int]) -> None:
        for store in (
            (self.counters, self._stack[-1].counters)
            if self._stack else (self.counters,)
        ):
            c = store.get(name)
            if c is None:
                c = store[name] = [0, 0]
            c[0] += 1
            if rows is not None:
                c[1] += int(rows)

    def _value(self, name: str, value: float) -> None:
        self.values[name] = float(value)
        if self._stack:
            self._stack[-1].attrs[name] = float(value)

    # -- read-side helpers ---------------------------------------------
    def all_spans(self) -> Iterator[Span]:
        for sp in self.spans:
            yield from sp.walk()

    def wall_s(self) -> float:
        end = self.resolved if self.resolved is not None else self.t1
        return max((end if end is not None else self.t0) - self.t0, 0.0)

    def device_resolved_s(self) -> Optional[float]:
        """Open to the host-known resolution of the query's result: its
        latency on the host clock (None until resolved)."""
        if self.resolved is None:
            return None
        return max(self.resolved - self.t0, 0.0)

    def device_ms(self, wait: bool = False) -> Optional[float]:
        """The query's device milliseconds from its events (see
        :func:`event_ms`); None on the CPU."""
        return event_ms(self.ev0, self.ev1, wait)


def current() -> Optional[QueryTrace]:
    return _ACTIVE.get()


_finish_lock = threading.Lock()


def _maybe_finish(q: QueryTrace) -> None:
    # the lock makes finish exactly-once, so the ring never holds a
    # duplicate and query.traces never over-counts
    with _finish_lock:
        if q.finished or not q.closed:
            return
        if q.pending and q.resolved is None:
            return  # an attached result resolves us
        q.finished = True
    if q.ev0 is not None and q.ev1 is None:
        q.ev1 = device_event()
    # resolve any window-pending stage-clock profiles (fused and sort
    # stages) BEFORE the ring/export see the trace: host arithmetic over
    # the stamped end. Lazy import: prof imports this module for the
    # active-trace contextvar.
    from . import prof as _prof

    _prof.finalize(q)
    _metrics.rollup_count("query.traces")
    _export.record(q)
    # persist the trace's per-node wall/rows/coll bytes when the
    # observation store is on (host dict+file work only — never a sync)
    _obsstore.record_trace(q)
    # stamp the finish time for the resource ledger's leak detector
    # (tables attributed to this query age against THIS clock); lazy
    # import — resource imports this module for the contextvar
    from . import resource as _resource

    _resource.query_finished(q)


# ----------------------------------------------------------------------
# the instrumentation surface (span / bump / gauge / annotate)
# ----------------------------------------------------------------------
@contextlib.contextmanager
def span(name: str, rows: Optional[int] = None, **attrs) -> Iterator[Optional[Span]]:
    """Time one phase. Always feeds the process-global rollup; when a
    query trace is active (or tracing is enabled, opening an implicit
    per-op-chain trace at the outermost span) also records a tree node
    and yields it so the caller can attach attrs."""
    q = _ACTIVE.get()
    if q is None and not tracing_active():
        # disabled fast path: rollup only, nothing allocated
        t0 = time.perf_counter()
        try:
            yield None
        finally:
            dt = time.perf_counter() - t0
            _metrics.rollup_span(name, dt, rows)
            if trace_enabled():
                extra = f" rows={rows}" if rows is not None else ""
                print(
                    f"[cylon_tpu_torch] {name}: {dt * 1e3:.2f} ms{extra}",
                    file=sys.stderr,
                )
        return
    token = None
    if q is None:
        # outermost span of an eager op chain: implicit per-chain trace
        q = QueryTrace(name, kind="op")
        token = _ACTIVE.set(q)
    sp = q._open(name, rows, attrs)
    try:
        yield sp
    finally:
        q._close(sp)
        _metrics.rollup_span(name, sp.dur_s(), rows)
        if trace_enabled():
            extra = f" rows={rows}" if rows is not None else ""
            print(
                f"[cylon_tpu_torch] {name}: {sp.dur_s() * 1e3:.2f} ms{extra}",
                file=sys.stderr,
            )
        if token is not None:
            _ACTIVE.reset(token)
            q.t1 = sp.t1
            q.closed = True
            _maybe_finish(q)


def bump(name: str, rows: Optional[int] = None) -> None:
    """Count an event in the rollup AND the active query trace (if any),
    attributed to the innermost open span."""
    _metrics.rollup_count(name, rows)
    q = _ACTIVE.get()
    if q is not None:
        q._count(name, rows)


def gauge(name: str, value: float) -> None:
    """Record a measured value (not a duration); the active trace keeps
    the latest per-query value on the innermost span."""
    _metrics.rollup_value(name, value)
    q = _ACTIVE.get()
    if q is not None:
        q._value(name, value)
    if trace_enabled():
        print(f"[cylon_tpu_torch] {name} = {value:.4f}", file=sys.stderr)


def annotate_add(**attrs) -> None:
    """Accumulate numeric annotations on the innermost open span of the
    active trace (no-op when tracing is off). The shuffle engine uses
    this to attach per-exchange collective bytes/rounds to whichever
    span — typically the owning ``plan.node.*`` — is executing."""
    q = _ACTIVE.get()
    if q is None:
        return
    target = q._stack[-1].attrs if q._stack else q.attrs
    for k, v in attrs.items():
        prev = target.get(k)
        target[k] = (prev + v) if isinstance(prev, (int, float)) else v


# ----------------------------------------------------------------------
# explicit query traces + the deferred (sync-free) resolution hook
# ----------------------------------------------------------------------
@contextlib.contextmanager
def query_trace(
    name: str, kind: str = "query", force: bool = False
) -> Iterator[Optional[QueryTrace]]:
    """Open a query trace for the block. Without ``force``: no-op when
    one is already active (spans then nest into the outer trace — yields
    None) or tracing is disabled. ``force=True`` ALWAYS opens a trace,
    shadowing any active one for the block (``explain(analyze=True)``
    must get its own span tree even inside a user's query_trace)."""
    if not force and (_ACTIVE.get() is not None or not tracing_active()):
        yield None
        return
    q = QueryTrace(name, kind=kind)
    token = _ACTIVE.set(q)
    try:
        yield q
    finally:
        _ACTIVE.reset(token)
        if q.t1 is None:
            q.t1 = time.perf_counter()
        q.closed = True
        _maybe_finish(q)


def attach_result(
    table,
    fingerprint=None,
    label: str = "",
    t0: Optional[float] = None,
    hist_key: Optional[str] = None,
    obs_key: Optional[str] = None,
) -> None:
    """Bind a result Table to the active trace and the latency histogram:
    observe ``now - t0`` under ``hist_key`` (or the key of
    ``fingerprint``), and in the observation store under ``obs_key``.
    The port's result counts are host-known, so the record resolves at
    once; nothing is fetched. ``table`` is the result (kept for the JAX
    package's signature: there a deferred count fetch resolves it)."""
    q = _ACTIVE.get()
    key = hist_key
    if key is None and fingerprint is not None:
        key = _metrics.fingerprint_key(fingerprint)
    if q is not None:
        q.pending = True
        if key is not None:
            q.hist_key = key
        if obs_key is not None:
            q.obs_key = obs_key
        if label:
            q.label = label
        if t0 is None:
            t0 = q.t0
    if q is None and key is None and obs_key is None:
        return
    _resolve_record((q, key, label, t0 if t0 is not None else time.perf_counter(), obs_key),
                    time.perf_counter())


def _resolve_record(rec, now: float) -> None:
    q, key, label, t0, obs_key = rec
    if key is not None:
        _metrics.observe_latency(key, max(now - t0, 0.0), label=label)
    if obs_key is not None:
        # the persistent store's latency journal: host file I/O only
        _obsstore.observe_latency(obs_key, max(now - t0, 0.0))
    if q is not None:
        q.resolved = now
        _maybe_finish(q)


# ----------------------------------------------------------------------
# explain(analyze=True) support
# ----------------------------------------------------------------------
@contextlib.contextmanager
def analyze_mode() -> Iterator[None]:
    """While active, the plan executor materializes EVERY node's result
    and records its rows (a diagnostic run: on a card each node's
    events are waited for). Only ``LazyFrame.explain(analyze=True)`` sets
    this; ``collect()`` never does."""
    token = _ANALYZE.set(True)
    try:
        yield
    finally:
        _ANALYZE.reset(token)


def analyze_active() -> bool:
    return _ANALYZE.get()


# ----------------------------------------------------------------------
# device profiler passthrough (the torch.profiler wrapper)
# ----------------------------------------------------------------------
@contextlib.contextmanager
def profile(log_dir: str) -> Iterator[Any]:
    """Capture a ``torch.profiler`` trace (CPU, and CUDA where a card is
    available) around a block, beside the host-side spans; written as
    Chrome trace JSON under ``log_dir`` at exit. Yields the profiler."""
    import os

    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as _profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with _profile(activities=acts) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, f"trace-{os.getpid()}.json"))
