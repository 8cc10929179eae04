"""The SLO monitor: rolling-window rule evaluation over the metrics the
engine already collects, emitting OK/WARN/BREACH state for operators
(counterpart of cylon_tpu/obs/slo.py).

The serving layer measures per-fingerprint latency and counts its sheds;
the resource ledger (:mod:`.resource`) watches the memory axis. This
module turns those signals into the three-state summary an autoscaler or
a pager acts on:

``p99:<fingerprint>``
    Rolling-window p99 of each plan shape's latency histogram against
    ``CYLON_TPU_TORCH_SERVE_P99_TARGET_MS`` (no target set = rule inactive).
    The cumulative histograms are bucket-monotone, so two snapshots DIFF
    into the window's exact distribution — burn-rate style: only
    latencies INSIDE ``CYLON_TPU_TORCH_SLO_WINDOW_S`` can breach, and a breach
    ages out with its window. Over target = WARN; over
    ``BREACH_RATIO`` x target = BREACH.

``shed``
    Windowed rate of load sheds (``serve.shed.admission_budget`` +
    ``serve.shed.queue_depth``): any shedding is WARN, a sustained storm
    (>= ``SHED_BREACH_PER_S``/s) is BREACH — the overload signal
    ``/healthz`` flips on.

``leak``
    Any ``serve.shed.unconsumed_cap`` shed in the window is BREACH:
    results are being held unconsumed past the 2x hard cap, which no
    autoscaler can fix — the reason-split shed counters exist exactly so
    this rule can tell a leak from load.

``errors``
    Windowed rate of typed query failures (``serve.errors`` — every
    future the scheduler fails with a CylonError: execution failures,
    spill-ladder exhaustion, worker deaths, deadline expiries). Any
    error in the window is WARN; a sustained storm
    (>= ``ERROR_BREACH_PER_S``/s) is BREACH — the signal ``/healthz``
    flips on when the degradation machinery is failing queries faster
    than retries can absorb.

``headroom``
    Live resource usage against the configured budgets: serving lease
    bytes vs ``CYLON_TPU_TORCH_SERVE_INFLIGHT_BYTES``, host arena bytes vs
    ``CYLON_TPU_TORCH_SPILL_HOST_BUDGET`` (when set). >= ``HEADROOM_WARN``
    of a budget = WARN, >= ``HEADROOM_BREACH`` = BREACH.

Every state TRANSITION emits a ``kind="slo"`` record into the
flight-recorder ring (:mod:`.export`) — the "what changed before the
page" breadcrumb — plus a ``slo.transitions`` counter bump and a
``slo.state.<rule>`` gauge. Evaluation is pull-driven: ``/metrics`` and
``/healthz`` call :meth:`SLOMonitor.evaluate` per scrape, so the scrape
interval IS the evaluation cadence (no background thread). Everything
here is host dict math over already-collected counters: it never touches
a device.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from ..utils import envgate as _eg
from . import metrics as _metrics

STATE_OK = 0
STATE_WARN = 1
STATE_BREACH = 2
STATE_NAMES = {STATE_OK: "OK", STATE_WARN: "WARN", STATE_BREACH: "BREACH"}

#: p99 past this multiple of the target escalates WARN -> BREACH
BREACH_RATIO = 2.0
#: sustained shed rate (events/s over the window) that is BREACH
SHED_BREACH_PER_S = 1.0
#: sustained typed-query-failure rate (events/s over the window) that is
#: BREACH (any failure in the window is already WARN)
ERROR_BREACH_PER_S = 1.0
#: budget-usage fractions for the headroom rule
HEADROOM_WARN = 0.80
HEADROOM_BREACH = 0.95
#: a windowed latency diff needs at least this many samples to judge p99
MIN_WINDOW_SAMPLES = 4


def window_s() -> float:
    try:
        return max(float(_eg.SLO_WINDOW_S.get()), 0.1)
    except ValueError:
        return 60.0


def _shed_counts() -> Tuple[int, int]:
    """(load sheds, leak sheds) from the reason-split counters."""
    load = (
        _metrics.get_count("serve.shed.admission_budget")
        + _metrics.get_count("serve.shed.queue_depth")
    )
    leak = _metrics.get_count("serve.shed.unconsumed_cap")
    return load, leak


class SLOMonitor:
    """Rolling-window SLO evaluation. One instance per process
    (:func:`monitor`); tests construct their own with a pinned window."""

    def __init__(self, window: Optional[float] = None):
        self._window = window
        self._lock = threading.Lock()
        # (t, load_sheds, leak_sheds, query_errors, bucket_snapshot)
        self._samples: "deque" = deque()
        self._states: Dict[str, int] = {}

    def _window_s(self) -> float:
        return self._window if self._window is not None else window_s()

    # -- the evaluation pass -------------------------------------------
    def evaluate(self) -> Dict[str, int]:
        """Take a sample, diff it against the oldest sample still
        covering the window, re-evaluate every rule, and emit any state
        transitions. Returns ``{rule: state}``."""
        now = time.monotonic()
        win = self._window_s()
        load, leak = _shed_counts()
        errs = _metrics.get_count("serve.errors")
        buckets = _metrics.bucket_snapshot()
        with self._lock:
            self._samples.append((now, load, leak, errs, buckets))
            # retain exactly ONE sample at-or-older than the window edge:
            # it is the diff baseline; everything older is history
            while (
                len(self._samples) >= 2
                and self._samples[1][0] <= now - win
            ):
                self._samples.popleft()
            (base_t, base_load, base_leak, base_errs,
             base_buckets) = self._samples[0]
            # rate denominators clamp to the FULL window: a young
            # baseline (fresh process, two scrapes seconds apart) must
            # not turn one shed into a "sustained storm" BREACH — the
            # rule's semantics are events per window, not per gap
            dt = max(now - base_t, win)
            new_states = self._evaluate_rules(
                load - base_load, leak - base_leak, errs - base_errs, dt,
                buckets, base_buckets,
            )
            transitions = []
            for rule, st in new_states.items():
                old = self._states.get(rule, STATE_OK)
                if st != old:
                    transitions.append((rule, old, st))
            # a rule that vanished while WARN/BREACH (evicted histogram
            # key, target unset) must RECOVER on its way out: without
            # the closing transition its slo.state gauge would read
            # breach forever and the ring would hold an incident with no
            # end. The state table itself stays bounded (vanished rules
            # are dropped).
            for rule, old in self._states.items():
                if rule not in new_states and old != STATE_OK:
                    transitions.append((rule, old, STATE_OK))
            self._states = new_states
        for rule, old, st in transitions:
            self._emit_transition(rule, old, st)
        return dict(new_states)

    def _evaluate_rules(
        self, d_load: int, d_leak: int, d_errs: int, dt: float,
        buckets: Dict, base_buckets: Dict,
    ) -> Dict[str, int]:
        states: Dict[str, int] = {}
        # -- shed storm (load) + leak ----------------------------------
        if d_leak > 0:
            states["leak"] = STATE_BREACH
        else:
            states["leak"] = STATE_OK
        if d_load <= 0:
            states["shed"] = STATE_OK
        elif d_load / dt < SHED_BREACH_PER_S:
            states["shed"] = STATE_WARN
        else:
            states["shed"] = STATE_BREACH
        # -- typed-failure rate ----------------------------------------
        if d_errs <= 0:
            states["errors"] = STATE_OK
        elif d_errs / dt < ERROR_BREACH_PER_S:
            states["errors"] = STATE_WARN
        else:
            states["errors"] = STATE_BREACH
        # -- per-fingerprint p99 burn ----------------------------------
        from ..plan.feedback import p99_target_s

        target = p99_target_s()
        if target is not None:
            for key, cur in buckets.items():
                base = base_buckets.get(key, {"b": {}, "n": 0})
                diff = {
                    int(b): c - base["b"].get(b, 0)
                    for b, c in cur["b"].items()
                    if c - base["b"].get(b, 0) > 0
                }
                n = sum(diff.values())
                if n < MIN_WINDOW_SAMPLES:
                    continue
                p99 = _metrics.bucket_quantile(diff, 0.99)
                if p99 <= target:
                    st = STATE_OK
                elif p99 <= BREACH_RATIO * target:
                    st = STATE_WARN
                else:
                    st = STATE_BREACH
                states[f"p99:{key}"] = st
        # -- resource headroom -----------------------------------------
        states["headroom"] = self._headroom_state()
        return states

    def _headroom_state(self) -> int:
        from ..parallel import spill as _spill
        from . import resource as _resource

        # resolve the cap exactly like admission does: an unset knob is
        # the scheduler's 1 GiB default, not an inactive rule
        from ..serve.scheduler import _DEFAULT_INFLIGHT_BYTES

        try:
            inflight_cap = int(
                _eg.SERVE_INFLIGHT_BYTES.get() or _DEFAULT_INFLIGHT_BYTES
            )
        except ValueError:
            inflight_cap = _DEFAULT_INFLIGHT_BYTES
        worst = 0.0
        if inflight_cap > 0:
            lease = sum(
                led.snapshot()["serve_lease_bytes"]
                for led in _resource.ledgers()
            )
            worst = max(worst, lease / inflight_cap)
        host_cap = _spill.host_spill_budget()
        if host_cap:
            host, _pk, _d, _dp = _spill.arena_bytes()
            worst = max(worst, host / host_cap)
        if worst >= HEADROOM_BREACH:
            return STATE_BREACH
        if worst >= HEADROOM_WARN:
            return STATE_WARN
        return STATE_OK

    def _emit_transition(self, rule: str, old: int, new: int) -> None:
        from ..utils.tracing import bump, gauge
        from . import export as _export
        from . import trace as _trace

        bump("slo.transitions")
        gauge(f"slo.state.{rule}", float(new))
        # a structured breadcrumb in the flight ring: the "what flipped
        # right before the page" record /queries and traceview surface
        q = _trace.QueryTrace(
            f"{rule} {STATE_NAMES[old]}->{STATE_NAMES[new]}", kind="slo"
        )
        q.attrs["slo.rule"] = rule
        q.attrs["slo.from"] = STATE_NAMES[old]
        q.attrs["slo.to"] = STATE_NAMES[new]
        q.t1 = q.t0
        q.closed = True
        q.finished = True
        _export.record(q)

    # -- read side ------------------------------------------------------
    def states(self) -> Dict[str, int]:
        """The last evaluation's ``{rule: state}`` (no re-evaluation)."""
        with self._lock:
            return dict(self._states)

    def healthy(self) -> Tuple[bool, List[str]]:
        """Re-evaluate and report: ``(ok, breach descriptions)`` — the
        ``/healthz`` substrate. Healthy = no rule in BREACH."""
        states = self.evaluate()
        reasons = [
            f"{rule}={STATE_NAMES[st]}"
            for rule, st in sorted(states.items())
            if st == STATE_BREACH
        ]
        return (not reasons, reasons)


# ----------------------------------------------------------------------
# the process singleton (the ops endpoint's monitor)
# ----------------------------------------------------------------------
_monitor_lock = threading.Lock()
_MONITOR: List[Optional[SLOMonitor]] = [None]


def monitor() -> SLOMonitor:
    m = _MONITOR[0]
    if m is None:
        with _monitor_lock:
            if _MONITOR[0] is None:
                _MONITOR[0] = SLOMonitor()
            m = _MONITOR[0]
    return m


def reset_monitor() -> None:
    """Drop the singleton (tests: a fresh window + state table)."""
    with _monitor_lock:
        _MONITOR[0] = None


def state_gauges() -> Dict[str, int]:
    """{rule: state} for the Prometheus exposition (last evaluation)."""
    return monitor().states()
