"""The multi-query serving scheduler: admission, batching, execution
(counterpart of cylon_tpu/serve/scheduler.py).

One scheduler a context (``scheduler(ctx)``; ``LazyFrame.collect_async``
routes here). Three stages:

ADMISSION (caller thread, ``submit``)
    Every query carries a bytes estimate: its bound input tables' tensor
    bytes, or, once the feedback re-coster has settled a ``footprint``
    decision for the shape, the OBSERVED per-query p95 device footprint
    (``CYLON_TPU_TORCH_NO_AUTOTUNE=1`` restores the static estimate). The
    estimate is held against the budget from admission until the query is
    CONSUMED (``QueryFuture.result()``), fails, or its unconsumed future
    is garbage-collected, so the bound covers queued work, executing
    batches and fulfilled-but-unread results. A query whose estimate alone
    exceeds ``CYLON_TPU_TORCH_SERVE_INFLIGHT_BYTES`` is shed with
    :class:`~.future.ServeOverloadError` (sheds count by reason:
    ``serve.shed.admission_budget`` / ``queue_depth`` /
    ``unconsumed_cap``); otherwise the submitter waits (backpressure)
    while held bytes would overflow the budget or the queue is at
    ``CYLON_TPU_TORCH_SERVE_QUEUE_DEPTH`` (``block=False``, or any submit
    to a worker-less scheduler, sheds instead). When nothing is queued or
    executing, every held byte belongs to results only the caller can
    release, so blocking could deadlock a submit-everything-then-consume
    caller: admission then overshoots (``serve.budget_overflow``) up to a
    hard cap of twice the budget, beyond which it sheds.

BATCH FORMATION (worker thread)
    The queue head's gated fingerprint (``plan.lazy.gated_fingerprint``,
    the plan cache's identity) pulls every queued query with the SAME
    fingerprint, up to ``CYLON_TPU_TORCH_SERVE_BATCH_MAX`` (or the tuned
    ``Decisions.serve_bucket``), into one group: one plan shape,
    different parameter bindings. Groups of one, and unbatchable shapes,
    run the ordinary cached single-plan executor.

EXECUTION (worker thread)
    A batch stacks its bindings per Scan ordinal (``batch.stack_tables``),
    runs ONE batched executor (``engine.serve_batch_executable``, keyed by
    the fingerprint and the power-of-two bucket of the group size), splits
    the result per binding and fulfills the futures. The worker enters the
    context's device and launches on that thread's current stream. It
    first waits on the events ``submit`` recorded on the submitting
    thread's current stream, so it reads no input before the caller's
    work on it is done, and it records an event after each result;
    ``QueryFuture.result()`` waits on that in the caller's thread.

FAILURE DOMAINS (fault/). Every failure ends in a typed
:class:`~cylon_tpu_torch.fault.CylonError` on exactly the affected
futures, their leases released:

- a failed batch falls back to per-binding single executions
  (``serve.batch_fallback``), so only the binding whose own execution
  fails gets a :class:`QueryExecError`, and the fingerprint's groups form
  as singles for ``BATCH_QUARANTINE_S`` (``serve.batch_quarantined``);
- a dying worker fails its in-flight group with :class:`WorkerDiedError`;
  ``submit``/``drain`` respawn it (``serve.worker_respawn``);
- ``CYLON_TPU_TORCH_SERVE_DEADLINE_MS`` bounds submit-to-fulfillment:
  an expired query fails with :class:`QueryTimeoutError` at batch
  formation and in the caller's wait;
- ``close()`` drains the worker, then fails what is still pending with
  :class:`SchedulerClosedError`.

Every typed failure bumps ``serve.errors`` (by scope under
``serve.errors.<scope>``), which the SLO monitor's error rule reads into
``/healthz``; ``stats()["leases"]`` is the live lease count.

The scheduler is held on one process (its shards in that process); under
``torch.distributed`` every rank would need the same groups in the same
order, which nothing here coordinates.
"""
from __future__ import annotations

import threading
import time
import weakref
from typing import Callable, List, Optional

import contextlib

import torch

from .. import engine as _engine
from ..fault import errors as _flt
from ..fault import inject as _fault
from ..obs import metrics as _obsmetrics
from ..obs import store as _obsstore
from ..obs import trace as _obstrace
from ..plan import feedback as _feedback
from ..plan import lazy as _lazy
from ..plan import lower as _plan_lower
from ..plan import rules as _plan_rules
from ..utils import envgate as _eg
from ..utils.tracing import bump, gauge, span
from . import batch as _batch
from .future import QueryFuture, ServeOverloadError, deadline_s

_DEFAULT_INFLIGHT_BYTES = 1 << 30  # 1 GiB
_EST_FLOOR = 1024  # bytes; keeps zero-size queries countable in the budget
#: a fingerprint whose stacked batch failed forms single-query groups for
#: this long (module attr so tests pin the cooldown without a knob)
BATCH_QUARANTINE_S = 30.0
#: how long close() waits for the worker to drain before failing whatever
#: is still pending (module attr so the wedged-worker regression test
#: does not wait 10 wall seconds)
CLOSE_JOIN_TIMEOUT_S = 10.0

#: consecutive worker deaths WITHOUT taking a group (so no queue
#: progress, typed or otherwise) before supervision stops respawning
#: and fails the queue instead — a deterministic pre-take failure
#: (e.g. MemoryError building the group) must not respawn-loop forever
RESPAWN_NOPROGRESS_MAX = 8


def _knob_int(knob, default: int) -> int:
    raw = knob.get()
    try:
        return int(raw)
    except ValueError:
        return default


def estimate_query_bytes(tables) -> int:
    """Admission estimate of one query: the bytes of its bound input
    tables' tensors (data and validity, this process's shards).
    Intermediates scale with the inputs, so the estimate tracks the peak
    footprint within a small constant factor."""
    total = 0
    for t in tables:
        for s in t.ctx.local_shards:
            for col in t._shards[s].values():
                total += col.data.numel() * col.data.element_size()
                if col.valid is not None:
                    total += col.valid.numel() * col.valid.element_size()
    return max(int(total), _EST_FLOOR)


def _device_scope(ctx):
    """The worker thread's entry into the context's device: a thread's
    current CUDA device (and with it the stream the kernel wrappers
    launch on) is its own."""
    dev = ctx.device
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def _ready_events(table) -> tuple:
    """Events recorded on each card's current stream after the work that
    made ``table``; ``QueryFuture.result()`` waits on them (none on the
    CPU)."""
    evs = []
    for dev in {table.ctx.devices[s] for s in table.ctx.local_shards}:
        if dev.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            evs.append(ev)
    return tuple(evs)


def _input_events(tables) -> tuple:
    """``(device, event)`` pairs recorded on the submitting thread's
    current stream of each card the bound tables live on; the worker's
    stream waits on them before it reads the inputs (none on the CPU)."""
    evs = []
    for dev in {t.ctx.devices[s] for t in tables for s in t.ctx.local_shards}:
        if dev.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            evs.append((dev, ev))
    return tuple(evs)


def _wait_inputs(recs) -> None:
    """Order the worker's streams after the submitters' work on the
    inputs of ``recs``."""
    for rec in recs:
        for dev, ev in rec.inputs_ready:
            torch.cuda.current_stream(dev).wait_event(ev)


class _Lease:
    """One admitted query's hold on the in-flight byte budget. Released
    exactly once — by consumption (``QueryFuture.result``), failure, or
    the dropped-future GC finalizer — whichever comes first. Deliberately
    holds NO reference to the future, so the finalizer can fire."""

    __slots__ = ("est", "released")

    def __init__(self, est: int):
        self.est = est
        self.released = False


class _Record:
    """One admitted query waiting for (or in) execution."""

    __slots__ = (
        "fut", "lf", "tables", "fingerprint", "lease", "label", "batchable",
        "seq", "inputs_ready",
    )

    def __init__(self, fut, lf, tables, fingerprint, lease, label, batchable):
        self.fut = fut
        self.lf = lf
        self.tables = tables
        self.inputs_ready = _input_events(tables)
        self.fingerprint = fingerprint
        self.lease = lease
        self.label = label
        self.batchable = batchable
        #: admission sequence number (assigned under the scheduler lock
        #: at enqueue, in admission order) — what makes seam keys
        #: PER-BINDING: every binding of a group shares ``label`` (the
        #: plan root class name), so a ``match=`` fault spec keying on
        #: the label alone would fire on all B bindings or none
        self.seq = -1

    @property
    def seam_key(self) -> str:
        """The fault-seam / error-attribution key for this binding:
        ``<PlanRoot>#q<admission-seq>``. ``match=#q3`` selects exactly
        the fourth query this scheduler admitted — the 'poison ONE
        binding of a batch' campaign the fault grammar documents."""
        return f"{self.label}#q{self.seq}"


class _BatchEntry:
    """One compiled batched executor (cached in engine's batch tier)."""

    __slots__ = ("template", "fn", "hist_key", "obs_key", "label")

    def __init__(self, template, fn, hist_key, obs_key, label):
        self.template = template
        self.fn = fn
        self.hist_key = hist_key
        self.obs_key = obs_key
        self.label = label


class ServeScheduler:
    """Per-context serving front-end. All knobs are read per call, so
    env flips take effect on the next submit / drain cycle."""

    def __init__(self, ctx, auto_start: bool = True):
        self._ctx = ctx
        # RLock, NOT Lock: the dropped-future GC finalizer
        # (weakref.finalize(fut, self._release, lease)) can fire at any
        # allocation point in any thread — including a thread currently
        # INSIDE one of this scheduler's critical sections (observed:
        # Thread.__init__ inside _spawn_worker_locked triggering GC) —
        # and a non-reentrant lock self-deadlocks there, hanging every
        # submitter forever. Re-entrant _release_locked is safe: the
        # release flag is idempotent, the mutations are self-contained
        # counter decrements, and an in-flight record's lease can never
        # be the one collected (its _Record strongly holds the future).
        self._lock = threading.RLock()
        self._work = threading.Condition(self._lock)
        self._space = threading.Condition(self._lock)
        self._queue: List[_Record] = []
        self._inflight_bytes = 0
        self._leases_live = 0  # admitted, not-yet-released leases
        self._executing = 0  # groups currently being dispatched
        #: close() returned a wedged worker's _executing slot early (the
        #: owner may never come back); if it DOES unwedge, its own
        #: decrement consumes a token instead of going negative
        self._orphan_rebalance = 0
        #: consecutive worker deaths with no group taken (reset on any
        #: successful take — see RESPAWN_NOPROGRESS_MAX)
        self._respawn_noprogress = 0
        #: admission counter feeding _Record.seq (per-binding seam keys)
        self._subseq = 0
        self._batchable: dict = {}  # structural fingerprint -> bool
        #: structural fingerprint -> monotonic expiry of its batching
        #: quarantine (set by a stacked-batch failure; groups form as
        #: singles until the cooldown lapses)
        self._quarantine: dict = {}
        self._paused = False
        self._closed = False
        self._had_worker = bool(auto_start)
        #: the group the worker thread currently holds (popped from the
        #: queue, not yet finished) — what close() must fail typed when
        #: the join times out on a WEDGED worker; None when idle
        self._worker_group: Optional[List[_Record]] = None
        self._thread: Optional[threading.Thread] = None
        if auto_start:
            self._spawn_worker_locked()

    def _spawn_worker_locked(self) -> None:
        self._thread = threading.Thread(
            target=self._worker, daemon=True, name="cylon-tpu-torch-serve"
        )
        self._thread.start()

    def _ensure_worker_locked(self) -> None:
        """Worker supervision: a scheduler that HAD a worker and finds it
        dead (a fault or bug killed the thread) respawns it, so queued
        and future work keeps draining. Worker-less schedulers
        (``auto_start=False``) stay worker-less — run_pending() is their
        drain. Caller holds the lock."""
        if (
            self._had_worker
            and not self._closed
            and (self._thread is None or not self._thread.is_alive())
        ):
            bump("serve.worker_respawn")
            self._spawn_worker_locked()

    # ------------------------------------------------------------------
    # submit path (enqueue only)
    # ------------------------------------------------------------------
    def submit(
        self, lf, block: bool = True, wrap: Optional[Callable] = None
    ) -> QueryFuture:
        """Admit one LazyFrame query; returns its future at once (or sheds
        with :class:`ServeOverloadError`). Runs nothing."""
        plan = lf.plan
        tables = _plan_lower.scan_tables(plan)
        fingerprint = _lazy.gated_fingerprint(plan)
        # admission estimate: the tuned OBSERVED footprint when the
        # feedback re-coster has settled one for this shape (the ledger's
        # per-query p95, riding the fingerprint under the same hysteresis
        # + CYLON_TPU_TORCH_NO_AUTOTUNE-oracle discipline as every other tuned
        # decision), else the static input-bytes estimate
        tuned_fp = _feedback.decisions_of(fingerprint).footprint
        if tuned_fp:
            est = max(int(tuned_fp), _EST_FLOOR)
        else:
            est = estimate_query_bytes(tables)
        fut = QueryFuture(time.perf_counter(), est, wrap=wrap)
        # batchability is structure-determined, i.e. a function of the
        # fingerprint: memoize so the hot submit path skips the
        # template-construction walk after a shape's first submission
        batchable = self._batchable.get(fingerprint[0])
        if batchable is None:
            batchable = _batch.is_batchable(plan)
        lease = _Lease(est)
        rec = _Record(
            fut, lf, tables, fingerprint, lease, type(plan).__name__,
            batchable,
        )
        cap = _knob_int(_eg.SERVE_INFLIGHT_BYTES, _DEFAULT_INFLIGHT_BYTES)
        depth = max(_knob_int(_eg.SERVE_QUEUE_DEPTH, 256), 1)
        with self._lock:
            self._ensure_worker_locked()
            if len(self._batchable) >= 256:
                self._batchable.pop(next(iter(self._batchable)))
            self._batchable[fingerprint[0]] = batchable
            if est > cap:
                bump("serve.shed.admission_budget")
                raise ServeOverloadError(
                    f"query estimate {est} B exceeds the in-flight budget "
                    f"CYLON_TPU_TORCH_SERVE_INFLIGHT_BYTES={cap}"
                )
            while not self._closed:
                over = self._inflight_bytes + est > cap
                if len(self._queue) < depth and not over:
                    break
                if not over and len(self._queue) >= depth:
                    pass  # queue full: backpressure below
                elif over and not (self._queue or self._executing > 0):
                    # only unconsumed results hold bytes: blocking could
                    # deadlock a submit-then-consume caller (nothing in
                    # the pipeline will ever release). Soft overshoot is
                    # allowed up to the HARD cap (2x the budget), beyond
                    # which admission sheds — the graceful-degradation
                    # bound: memory tops out at ~2x budget, never OOM.
                    if self._inflight_bytes + est > 2 * cap:
                        bump("serve.shed.unconsumed_cap")
                        raise ServeOverloadError(
                            f"unconsumed results hold "
                            f"{self._inflight_bytes} B (> 2x the "
                            f"CYLON_TPU_TORCH_SERVE_INFLIGHT_BYTES={cap} "
                            "budget) and nothing queued can release "
                            "them — consume or drop QueryFutures"
                        )
                    bump("serve.budget_overflow")
                    break
                if not block or not self._had_worker:
                    # a worker-less scheduler (auto_start=False) must
                    # never block: only run_pending() in THIS thread
                    # could make progress. (NOT `self._thread is None`:
                    # a dying auto-start worker publishes None for the
                    # liveness handshake above, and a blocking submit
                    # must park-and-respawn through the wait loop, not
                    # shed.)
                    bump("serve.shed.queue_depth")
                    raise ServeOverloadError(
                        f"serving at capacity (queue {len(self._queue)}, "
                        f"in-flight {self._inflight_bytes} B) and "
                        + ("block=False" if not block
                           else "no worker thread (auto_start=False: "
                           "drain with run_pending instead of blocking)")
                    )
                bump("serve.backpressure.wait")
                # bounded wait, not bare: a missed notify (whatever its
                # cause) must degrade to one second of extra latency,
                # never an unbounded park — the loop re-checks capacity
                # and worker liveness every wake either way
                self._space.wait(1.0)
                # a worker death notifies this wait: the blocked
                # submitter must resurrect the drain itself or it would
                # re-park forever over a queue nobody pops
                self._ensure_worker_locked()
            if self._closed:
                raise _flt.SchedulerClosedError("ServeScheduler is closed")
            rec.seq = self._subseq
            self._subseq += 1
            self._queue.append(rec)
            self._inflight_bytes += est
            self._leases_live += 1
            bump("serve.submitted")
            if tuned_fp:
                # counted only once the lease actually holds the tuned
                # bytes — a shed/backpressured submit is not an admission
                bump("autotune.footprint_admit")
            gauge("serve.queue_depth", len(self._queue))
            gauge("serve.inflight_bytes", self._inflight_bytes)
            gauge("serve.leases", self._leases_live)
            self._work.notify()
        # the lease outlives dispatch: consumption (result()) releases
        # it; a future dropped unconsumed releases via GC (the finalizer
        # holds the lease, never the future, so collection can happen)
        fut._release_cb = lambda: self._release(lease)
        weakref.finalize(fut, self._release, lease)
        return fut

    # -- budget release (consumption / failure / GC) --------------------
    def _release(self, lease: _Lease) -> None:
        with self._lock:
            self._release_locked(lease)

    def _release_locked(self, lease: _Lease) -> None:
        if lease.released:
            return
        lease.released = True
        self._inflight_bytes -= lease.est
        self._leases_live -= 1
        gauge("serve.inflight_bytes", self._inflight_bytes)
        gauge("serve.leases", self._leases_live)
        self._space.notify_all()

    def _fail_rec_locked(self, rec: _Record, error: BaseException) -> None:
        """Fail one admitted query TYPED: the future resolves to a
        CylonError (non-Cylon causes wrap into QueryExecError carrying
        the fingerprint + binding key), its lease is released, and the
        error-rate SLO substrate counts it by scope. Caller holds the
        lock. The ONE implementation of the fail contract — close()'s
        orphan sweep, the respawn-exhausted strand, and every worker-path
        failure route here so counting/attribution cannot drift."""
        if not isinstance(error, _flt.CylonError):
            typed = _flt.QueryExecError(
                f"query execution failed: {type(error).__name__}: {error}",
                fingerprint=rec.fingerprint[0], binding=rec.seam_key,
            )
            typed.__cause__ = error
            error = typed
        if rec.fut._fail(error):
            # count only a transition this call actually made: a lost
            # race (caller-side deadline fail, or a fulfilled future)
            # already counted/consumed its own outcome
            bump("serve.errors")
            bump(f"serve.errors.{getattr(error, 'scope', 'query')}")
        self._release_locked(rec.lease)

    def _fail_rec(self, rec: _Record, error: BaseException) -> None:
        with self._lock:
            self._fail_rec_locked(rec, error)

    # ------------------------------------------------------------------
    # drain / lifecycle
    # ------------------------------------------------------------------
    def run_pending(self) -> int:
        """Synchronously execute everything currently queued, in the
        CALLER's thread (deterministic batch formation: the whole queue
        is visible before the first group forms). Returns the number of
        queries executed. Tests and single-threaded batch loops use this;
        online serving uses the worker thread."""
        done = 0
        while True:
            with self._lock:
                if not self._queue:
                    return done
                group = self._take_group_locked()
                self._executing += 1
            self._run_group(group)
            done += len(group)
            del group  # a lingering frame ref would pin futures past GC

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every admitted query has been dispatched (their
        futures fulfilled — results may still await consumption). True on
        success, False on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            self._ensure_worker_locked()
            while self._queue or self._executing > 0:
                left = None
                if deadline is not None:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        return False
                if not self._space.wait(left):
                    return False
                # same liveness rule as the submit wait: a dead worker
                # wakes this loop, and the drainer respawns it
                self._ensure_worker_locked()
        return True

    def close(self) -> None:
        """Stop the worker after it finishes the queued work; subsequent
        submits raise :class:`SchedulerClosedError`.

        The close()/drain() leak fix: ``t.join(timeout=10)`` can return
        with the worker still alive (wedged on a device) or already dead
        (a fault killed it) and queued futures never fulfilled — so
        AFTER the join (or immediately, on a worker-less scheduler)
        anything still pending is failed with a typed
        :class:`SchedulerClosedError` and its lease released. A closed
        scheduler strands nothing and leaks nothing."""
        with self._lock:
            self._closed = True
            self._work.notify_all()
            self._space.notify_all()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=CLOSE_JOIN_TIMEOUT_S)
        with self._lock:
            orphans, self._queue = self._queue, []
            if t is not None and t.is_alive() and self._worker_group:
                # the join TIMED OUT with the worker wedged mid-group
                # (records live in its frame, not the queue): those
                # futures are orphans too. If the worker ever unwedges,
                # its fulfill/fail loses the transition race (first
                # writer wins) and the releases stay idempotent.
                orphans = list(self._worker_group) + orphans
                # the wedged worker still owns an _executing slot it may
                # never return: rebalance NOW so drain()/stats() converge
                # on a closed scheduler instead of parking forever
                self._worker_group = None
                self._executing -= 1
                self._orphan_rebalance += 1
            for rec in orphans:
                self._fail_rec_locked(rec, _flt.SchedulerClosedError(
                    "ServeScheduler closed with the query still pending"
                ))
            if orphans:
                bump("serve.close_orphans", rows=len(orphans))
            gauge("serve.queue_depth", 0)
            self._space.notify_all()  # wake drainers: nothing is coming

    def _dec_executing_locked(self) -> None:
        """Return an ``_executing`` slot; a slot close() already
        rebalanced away (wedged-worker orphan) consumes its token
        instead, so the late decrement cannot go negative."""
        if self._orphan_rebalance > 0:
            self._orphan_rebalance -= 1
        else:
            self._executing -= 1

    def stats(self) -> dict:
        """Point-in-time admission state (host counters only).
        ``inflight_bytes`` counts admitted-but-unconsumed queries —
        queued, executing, or fulfilled with the result not yet read."""
        with self._lock:
            return {
                "queue_depth": len(self._queue),
                "inflight_bytes": self._inflight_bytes,
                "leases": self._leases_live,
                "executing": self._executing,
                "quarantined": sum(
                    1 for exp in self._quarantine.values()
                    if exp > time.monotonic()
                ),
                "closed": self._closed,
            }

    def pause(self) -> None:
        """Freeze batch formation (submits still admit and queue). With
        an offered backlog, ``pause() -> submit all -> resume()`` makes
        the worker see the WHOLE queue before the first group forms, so
        every batch fills to CYLON_TPU_TORCH_SERVE_BATCH_MAX — the
        deterministic-batching mode the benchmark and tests use; online
        serving leaves the drain free-running and accepts whatever group
        sizes the arrival process yields."""
        with self._lock:
            self._paused = True

    def resume(self) -> None:
        """Unfreeze batch formation after :meth:`pause`."""
        with self._lock:
            self._paused = False
            self._work.notify_all()

    # ------------------------------------------------------------------
    # worker side
    # ------------------------------------------------------------------
    def _worker(self) -> None:
        """The supervised worker shell: the loop body must not die
        silently. An escaping exception (the ``serve.worker`` seam, or a
        real bug outside ``_run_group``'s own handler) fails whatever
        group was in flight with :class:`WorkerDiedError` — leases
        released, ``_executing`` rebalanced — and lets the thread die;
        the next ``submit``/``drain`` respawns it
        (:meth:`_ensure_worker_locked`)."""
        died = False
        try:
            self._worker_loop()
        except BaseException:  # noqa: BLE001 - supervised death
            bump("serve.worker_died")
            died = True
        finally:
            # THE LIVENESS HANDSHAKE, as the thread's last act and in
            # ONE locked region: publish the death (clear self._thread —
            # a dying thread is still is_alive(), so a waiter woken
            # while we unwind would otherwise see a "live" worker, skip
            # its respawn, and park forever on a condition nobody will
            # ever notify again), handle queued work, and notify LAST.
            # The lock serializes this against every submit's admission
            # section: a submitter either runs first and enqueues (we
            # see the queue and respawn below) or runs after (its
            # _ensure_worker_locked sees _thread=None and respawns).
            with self._lock:
                if self._thread is threading.current_thread():
                    self._thread = None
                # respawn IMMEDIATELY when work is still queued: a
                # caller parked in fut.result() (no submit, no drain)
                # has no other path to a drain, and a stranded queued
                # future is exactly what the failure model forbids.
                # Termination: a post-take death fails its in-flight
                # group (queue progress, typed), and pre-take deaths —
                # which make NO progress — are bounded by
                # RESPAWN_NOPROGRESS_MAX before supervision gives up
                # and fails the queue itself, so a deterministically-
                # dying worker can never respawn-loop forever.
                if died and self._queue and not self._closed:
                    if self._respawn_noprogress < RESPAWN_NOPROGRESS_MAX:
                        self._respawn_noprogress += 1
                        bump("serve.worker_respawn")
                        self._spawn_worker_locked()
                    else:
                        bump("serve.worker_respawn_exhausted")
                        stranded, self._queue = self._queue, []
                        for rec in stranded:
                            self._fail_rec_locked(rec, _flt.WorkerDiedError(
                                "serve worker died repeatedly before "
                                "taking a group; queue failed typed"
                            ))
                        gauge("serve.queue_depth", 0)
                        self._respawn_noprogress = 0
                self._work.notify_all()
                self._space.notify_all()

    def _worker_loop(self) -> None:
        while True:
            group: List[_Record] = []
            try:
                with self._lock:
                    while not self._closed and (
                        not self._queue or self._paused
                    ):
                        self._work.wait()
                    if not self._queue:
                        if self._closed:
                            return
                        continue
                    group = self._take_group_locked()
                    self._executing += 1
                    self._worker_group = group
                    # a take IS progress (the queue shrank): even a
                    # death right after this drains typed, so the
                    # no-progress respawn budget starts over
                    self._respawn_noprogress = 0
                # the worker-death seam: simulates the thread dying while
                # it HOLDS a group (the stranded-future scenario the
                # supervision exists for)
                _fault.check("serve.worker")
            except BaseException as e:  # noqa: BLE001
                if group:
                    err = (
                        e if isinstance(e, _flt.CylonError)
                        else _flt.WorkerDiedError(
                            f"serve worker died: {type(e).__name__}: {e}"
                        )
                    )
                    for rec in group:
                        if not rec.fut.done():
                            self._fail_rec(rec, err)
                    with self._lock:
                        self._worker_group = None
                        self._dec_executing_locked()
                        self._space.notify_all()
                raise
            # _run_group's finally clears _worker_group atomically with
            # its _executing return (a separate clear here would re-open
            # the close() double-decrement window)
            with _device_scope(self._ctx):
                self._run_group(group)
            # drop the frame's reference BEFORE parking in _work.wait():
            # an idle worker must not pin the last group's futures, or
            # their dropped-unconsumed GC lease release never fires
            del group

    def _take_group_locked(self) -> List[_Record]:
        """Pop the head query plus every same-fingerprint sibling (up to
        CYLON_TPU_TORCH_SERVE_BATCH_MAX), preserving arrival order for the
        rest. Caller holds the lock."""
        head = self._queue[0]
        limit = max(_knob_int(_eg.SERVE_BATCH_MAX, 16), 1)
        # batching quarantine: a fingerprint whose stacked program failed
        # recently forms single-query groups until the cooldown lapses —
        # the fallback path is correct but pays B dispatches, so a
        # persistently poisonous shape must not re-enter the batch path
        # every group
        exp = self._quarantine.get(head.fingerprint[0])
        if exp is not None:
            if exp > time.monotonic():
                bump("serve.batch_quarantined")
                limit = 1
            else:
                del self._quarantine[head.fingerprint[0]]
        # the feedback re-coster's p99-target batch bucket rides the
        # fingerprint the group is keyed by: a tuned shape caps its own
        # group size (smaller stacked programs -> lower tail latency)
        # without touching other shapes' batching
        tuned_b = _feedback.decisions_of(head.fingerprint).serve_bucket
        if tuned_b:
            limit = min(limit, max(int(tuned_b), 1))
        group: List[_Record] = []
        rest: List[_Record] = []
        for rec in self._queue:
            if (
                len(group) < limit
                and rec.fingerprint == head.fingerprint
                and rec.batchable == head.batchable
            ):
                group.append(rec)
            else:
                rest.append(rec)
        self._queue = rest
        gauge("serve.queue_depth", len(self._queue))
        return group

    def _expire_deadlines(self, group: List[_Record]) -> List[_Record]:
        """Fail (typed, lease released) every record already past the
        serving deadline BEFORE spending a dispatch on it; returns the
        still-live remainder. A record whose caller-side wait already
        failed it (fut.done()) is dropped the same way — its lease was
        released by the deadline path."""
        d = deadline_s()
        if d is None:
            return [rec for rec in group if not rec.fut.done()]
        now = time.perf_counter()
        live: List[_Record] = []
        for rec in group:
            if rec.fut.done():
                continue
            if now - rec.fut.t_submit > d:
                self._fail_rec(rec, _flt.QueryTimeoutError(
                    "query exceeded CYLON_TPU_TORCH_SERVE_DEADLINE_MS "
                    f"({_eg.SERVE_DEADLINE_MS.get()} ms) before dispatch"
                ))
            else:
                live.append(rec)
        return live

    def _run_group(self, group: List[_Record]) -> None:
        try:
            live = self._expire_deadlines(group)
            if len(live) > 1 and live[0].batchable:
                try:
                    self._run_batch(live)
                except BaseException as e:  # noqa: BLE001 - isolate below
                    # POISONED-BINDING ISOLATION: the stacked program
                    # failed — quarantine the shape's batching and fall
                    # back to per-binding singles, so only the binding
                    # whose OWN execution fails loses its future
                    bump("serve.batch_fallback", rows=len(live))
                    with self._lock:
                        self._quarantine[live[0].fingerprint[0]] = (
                            time.monotonic() + BATCH_QUARANTINE_S
                        )
                        while len(self._quarantine) > 256:
                            self._quarantine.pop(
                                next(iter(self._quarantine))
                            )
                    self._run_singles(live)
            else:
                self._run_singles(live)
        except BaseException as e:  # noqa: BLE001
            for rec in group:
                if not rec.fut.done():
                    self._fail_rec(rec, e)
        finally:
            with self._lock:
                # same locked region as the _executing return: clearing
                # the worker-group marker in a SEPARATE acquisition let
                # close() observe (slot returned, marker still set) and
                # double-decrement via the wedge branch. Identity-guarded
                # so a run_pending() caller racing the worker never
                # clears the worker's own in-flight marker.
                if self._worker_group is group:
                    self._worker_group = None
                self._dec_executing_locked()
                for _ in group:
                    bump("serve.completed")
                # fulfilled queries keep their byte lease until the
                # caller consumes (or drops) the result; waiters still
                # re-check here because the pipeline emptying is itself
                # an admission condition (the liveness carve-out)
                self._space.notify_all()

    def _run_singles(self, group: List[_Record]) -> None:
        """Per-binding single execution (plain single-query groups AND
        the batch-failure fallback): one binding's failure fails exactly
        its own future, typed."""
        for rec in group:
            if rec.fut.done():
                continue
            try:
                self._run_single(rec)
            except BaseException as e:  # noqa: BLE001 - must not kill the worker
                self._fail_rec(rec, e)

    def _run_single(self, rec: _Record) -> None:
        """One query through the ordinary cached single-plan executor."""
        # the single-execution seam: key = the binding's PER-BINDING
        # seam key (label#q<seq>), so a match= spec can poison ONE
        # binding of a fallback group
        _fault.check("serve.single_exec", key=rec.seam_key)
        _wait_inputs((rec,))
        with _obstrace.query_trace(rec.label, kind="serve"):
            tables, fingerprint, entry, hit = rec.lf._executable()
            with _feedback.applying(fingerprint[-1]), \
                    _obsstore.exec_obs(entry.obs_key):
                with span("plan.execute"):
                    out = entry.fn(rec.tables)
            # batch_b=1: an honest B=1 serving sample — it keeps the
            # serve-bucket proposer's latency window fed even when a
            # tuned bucket of 1 routes every query through this path,
            # so a halved bucket can walk back up when latency recovers
            _obstrace.attach_result(
                out, hist_key=entry.hist_key, obs_key=entry.obs_key,
                batch_b=1, label=rec.label, t0=rec.fut.t_submit,
            )
            rec.fut.hist_key = entry.hist_key
            bump("serve.singles")
            rec.fut._fulfill(out, _ready_events(out))

    def _run_batch(self, group: List[_Record]) -> None:
        """B same-fingerprint bindings as ONE stacked execution: stack per
        Scan ordinal, run the cached batched executor, split per
        binding."""
        ctx = self._ctx
        b = len(group)
        bucket = 1 << (b - 1).bit_length()
        head = group[0]
        # the stacked-batch seam: a failure here takes the fallback of
        # _run_group. Its key joins every binding's, so `match=#q3` arms
        # exactly the batches that hold binding 3
        _fault.check("serve.batch_exec", key=" ".join(rec.seam_key for rec in group))
        _wait_inputs(group)
        # re-assign Scan ordinals BEFORE keying: live Scans are shared with
        # the user's LazyFrame, and a concurrent collect of another plan
        # sharing one could have renumbered them since submit
        _plan_lower.scan_tables(head.lf.plan)
        # the drain-time fingerprint: the executor is built under the gate
        # state in force NOW (submit-time fingerprints only group)
        orig_fp = _lazy.gated_fingerprint(head.lf.plan, ctx)
        key = orig_fp + ("serve_batch", bucket)

        def compile_batch():
            template = _batch.build_batched_template(head.lf.plan, len(head.tables))
            with span("plan.optimize"):
                opt, fired = _plan_rules.optimize(template.root, ctx.world_size)
            with span("plan.lower"):
                fn = _plan_lower.build_executor(opt)
            # per-query latencies land in the ORIGINAL plan shape's
            # histogram and store profile: batched and serial runs of one
            # fingerprint share a distribution
            return _BatchEntry(template, fn, _obsmetrics.fingerprint_key(orig_fp),
                               _feedback.base_key(orig_fp[:-1]), opt.label())

        entry, hit = _engine.serve_batch_executable(ctx, key, compile_batch)
        with _obstrace.query_trace(entry.label, kind="serve") as q:
            with _feedback.applying(orig_fp[-1]), _obsstore.exec_obs(entry.obs_key):
                # the ledger attributes the stacked execution's device
                # bytes to ONE exec record: stamp the query count so the
                # footprint distribution stays per query
                _obsstore.note_batch_queries(b)
                stacked = [_batch.stack_tables(ctx, [rec.tables[s] for rec in group])
                           for s in range(len(head.tables))]
                with span("plan.execute"):
                    out = entry.fn(stacked)
            if q is not None:
                q.hist_key = entry.hist_key
                q.attrs["serve.batch_b"] = b
                q.attrs["serve.batch_bucket"] = bucket
            # charge the split's copy of the result to the queries' leases,
            # so admission sees the batch's real footprint
            surcharge = _batch.split_bytes_estimate(out, entry.template)
            with self._lock:
                for rec in group:
                    if not rec.lease.released:
                        rec.lease.est += surcharge
                        self._inflight_bytes += surcharge
                gauge("serve.inflight_bytes", self._inflight_bytes)
            slices = _batch.split_batch(out, entry.template, b)
            ready = _ready_events(out)
            for rec, sliced in zip(group, slices):
                _obstrace.attach_result(sliced, hist_key=entry.hist_key, obs_key=entry.obs_key,
                                        batch_b=b, label=rec.label, t0=rec.fut.t_submit)
                rec.fut.hist_key = entry.hist_key
                rec.fut._fulfill(sliced, ready)
        gauge("serve.batch_occupancy", b / bucket)
        bump("serve.batches", rows=b)


# ----------------------------------------------------------------------
# the per-context scheduler + module-level submit funnel
# ----------------------------------------------------------------------
def scheduler(ctx) -> ServeScheduler:
    """The context's shared scheduler, created (with its worker thread)
    on first use. A closed scheduler is replaced on the next call — one
    workload's ``close()`` must not poison the context's serving surface
    forever."""
    s = ctx.__dict__.get("_serve_sched")
    if s is not None and not s._closed:
        return s
    with _engine.cache_lock(ctx):
        s = ctx.__dict__.get("_serve_sched")
        if s is None or s._closed:
            s = ServeScheduler(ctx)
            ctx.__dict__["_serve_sched"] = s
    return s


def submit(
    lf, block: bool = True, wrap: Optional[Callable] = None
) -> QueryFuture:
    """Submit a LazyFrame to its context's shared scheduler (the
    ``collect_async`` funnel)."""
    return scheduler(lf._ctx).submit(lf, block=block, wrap=wrap)
