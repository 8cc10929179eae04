"""QueryFuture: the handle of one in-flight served query (counterpart of
cylon_tpu/serve/future.py).

Lifecycle::

    submit (collect_async / ServeScheduler.submit)
        -> queued (admission-gated)
        -> run by the scheduler's worker (batched or single)
        -> fulfilled (this future holds the result table)
    result()
        -> waits for fulfillment, then for the card's work on the result
           (the event the worker recorded after it), in the CALLER's thread

The worker never waits for the card: it records an event after each
result and goes on with the next group; the one wait of each query is
paid by whoever asks for the answer.

FAILURE DOMAIN (fault/): a future resolves exactly once, to a result or a
typed :class:`~cylon_tpu_torch.fault.CylonError`, and its admission lease
is released exactly once, at consumption, scheduler-side failure, the
``CYLON_TPU_TORCH_SERVE_DEADLINE_MS`` deadline, or the dropped-future GC
finalizer, whichever comes first. ``result()``/``exception()`` cap their
wait at the query's remaining deadline and fail the future with
:class:`QueryTimeoutError` instead of hanging (the transition races the
worker's fulfillment under a per-future lock; the first writer wins).
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from ..fault.errors import CylonError, QueryTimeoutError
from ..utils import envgate as _eg
from ..utils.tracing import bump


class ServeOverloadError(CylonError, RuntimeError):
    """Admission control shed this query instead of queueing it.

    Raised AT SUBMIT, never from ``result()``: the query's estimate alone
    exceeds the in-flight budget, or the queue is at
    ``CYLON_TPU_TORCH_SERVE_QUEUE_DEPTH`` and the caller asked not to wait
    (``block=False``). Counted by reason under ``serve.shed.*``; nothing
    admitted is shed. ``retryable`` (the overload is load, not the query),
    scope ``"query"``."""

    retryable = True


def deadline_s() -> Optional[float]:
    """The per-query serving deadline (seconds), or None when
    ``CYLON_TPU_TORCH_SERVE_DEADLINE_MS`` is unset or invalid. Read per
    call."""
    raw = _eg.SERVE_DEADLINE_MS.get()
    if not raw:
        return None
    try:
        ms = float(raw)
    except ValueError:
        return None
    return ms / 1e3 if ms > 0 else None


class QueryFuture:
    """Future of a query submitted through the serving scheduler."""

    __slots__ = (
        "_event", "_table", "_ready", "_error", "_wrap", "_release_cb", "_flock",
        "t_submit", "est_bytes", "hist_key", "__weakref__",
    )

    def __init__(self, t_submit: float, est_bytes: int, wrap: Optional[Callable] = None):
        self._event = threading.Event()
        self._table = None
        # the card events recorded after the result's work (None on the CPU)
        self._ready: tuple = ()
        self._error: Optional[BaseException] = None
        self._wrap = wrap
        # serializes the resolve transition: the worker's fulfill or fail
        # races the caller-side deadline fail; the first writer wins
        self._flock = threading.Lock()
        # set by the scheduler: returns this query's bytes to the
        # admission budget (idempotent; also fired by a GC finalizer when
        # the caller drops the future unconsumed)
        self._release_cb: Optional[Callable] = None
        self.t_submit = t_submit
        self.est_bytes = int(est_bytes)
        self.hist_key: Optional[str] = None

    # -- scheduler side ------------------------------------------------
    def _fulfill(self, table, ready: tuple = ()) -> None:
        with self._flock:
            if self._event.is_set():
                return  # lost to a deadline or worker-death fail
            self._table = table
            self._ready = ready
            self._event.set()

    def _fail(self, error: BaseException) -> bool:
        """Resolve to ``error`` if nothing resolved first; returns whether
        this call WON the transition (a loser must not count or release)."""
        with self._flock:
            if self._event.is_set():
                return False
            self._error = error
            self._event.set()
            return True

    # -- caller-side deadline enforcement ------------------------------
    def _deadline_left(self) -> Optional[float]:
        d = deadline_s()
        if d is None:
            return None
        return d - (time.perf_counter() - self.t_submit)

    def _wait(self, timeout: Optional[float]) -> None:
        """Wait for fulfillment, bounded by the caller's timeout and the
        query deadline. A deadline expiry FAILS the future (typed, lease
        released); a plain timeout raises without failing it."""
        left = self._deadline_left()
        if left is None:
            if not self._event.wait(timeout):
                raise TimeoutError("query not fulfilled within timeout")
            return
        eff = left if timeout is None else min(timeout, left)
        if self._event.wait(max(eff, 0.0)):
            return
        if timeout is not None and timeout < left:
            raise TimeoutError("query not fulfilled within timeout")
        err = QueryTimeoutError(
            f"query exceeded CYLON_TPU_TORCH_SERVE_DEADLINE_MS "
            f"({_eg.SERVE_DEADLINE_MS.get()} ms from submit)")
        if not self._fail(err):
            return  # the scheduler resolved it in the wait->fail window
        # caller-side typed failures count like scheduler-side ones (the
        # SLO errors rule must see a deadline storm either way)
        bump("serve.errors")
        bump(f"serve.errors.{err.scope}")
        cb, self._release_cb = self._release_cb, None
        if cb is not None:
            cb()

    # -- caller side ---------------------------------------------------
    def done(self) -> bool:
        """True once the scheduler ran (or failed) this query."""
        return self._event.is_set()

    def exception(self, timeout: Optional[float] = None):
        """The execution error, or None. Waits for fulfillment (bounded by
        the serving deadline, which fails the future typed)."""
        self._wait(timeout)
        return self._error

    def result(self, timeout: Optional[float] = None):
        """Wait for the result and for the card's work on it, then hand it
        over: the query's one wait, in the caller's thread."""
        self._wait(timeout)
        if self._error is not None:
            raise self._error
        for ev in self._ready:
            ev.synchronize()
        t = self._table
        # consumed: return this query's bytes to the admission budget
        cb, self._release_cb = self._release_cb, None
        if cb is not None:
            cb()
        if self._wrap is not None:
            return self._wrap(t)
        return t
