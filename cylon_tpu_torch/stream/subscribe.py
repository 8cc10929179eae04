"""Subscriptions: incremental views refreshed through the serving scheduler
(counterpart of cylon_tpu/stream/subscribe.py).

A :class:`Subscription` is a future-like handle over an
:class:`~cylon_tpu_torch.stream.delta.IncrementalView` that re-resolves
when its input tables grow. An append marks it stale (ingest.py notifies
its listeners outside the ingest lock); ``refresh_async()`` submits the
view's primary refresh plan through the context's shared
:class:`~cylon_tpu_torch.serve.ServeScheduler`, with the admission budget,
the byte leases, the deadlines, the same-fingerprint batching and the
typed failures of every served query. Every delta plan's
``gated_fingerprint`` carries its snapshot generations, so subscriptions of
one view at one generation stack into one execution, and refreshes of
different generations never alias.

``result()`` re-resolves: stale, it submits and waits; fresh, it returns
the retained result with no launch. The refresh's merge (the other delta
terms and the partial merge, stream/delta.py) runs in the caller's thread,
inside the future's ``wrap``: the scheduler's worker never waits on the
card.

Refresh latencies are journaled into the observation store under the
refresh plan's profile identity (delta.py ``_journal``) and into the
``stream.refresh`` latency histogram.
"""
from __future__ import annotations

import time
from typing import Optional

from ..fault.errors import CylonError
from ..utils.tracing import bump
from .delta import IncrementalView


class Subscription:
    """A re-resolving future over an :class:`IncrementalView`:
    ``result()``, ``done()``, ``stale()``, and ``refresh_async()``, which
    returns the :class:`~cylon_tpu_torch.serve.QueryFuture` of one
    refresh."""

    def __init__(self, view: IncrementalView):
        self._view = view
        self._ctx = view.ctx
        self._stale = True          # the first resolution is pending
        self._inflight = None       # the in-flight QueryFuture, if any
        for src in view._sources:
            src.subscribe_listener(self)
        bump("stream.subs")

    # -- ingest side ---------------------------------------------------
    def _on_append(self, _src) -> None:
        """Called by ingest.py after each committed append: the current
        resolution is superseded, the next result() re-resolves."""
        self._stale = True
        bump("stream.subs.stale")

    # -- future surface ------------------------------------------------
    def stale(self) -> bool:
        """Has an input grown past the last resolved result?"""
        return self._stale or self._view.stale()

    def done(self) -> bool:
        """A result is resolved and no later append superseded it."""
        return self._view._result is not None and not self.stale()

    def refresh_async(self):
        """Submit this subscription's refresh through the serving
        scheduler; returns a :class:`~cylon_tpu_torch.serve.QueryFuture`
        whose ``result()`` is the refreshed view result (the merge applied
        in the caller's thread). A no-op refresh returns a fulfilled future
        without touching the scheduler."""
        from ..serve.future import QueryFuture
        from ..serve.scheduler import submit as _serve_submit

        mode, lf, commit = self._view._plan_refresh()
        self._stale = False
        if lf is None:
            fut = QueryFuture(time.perf_counter(), 0)
            fut._fulfill(commit(None))
            return fut
        bump(f"stream.subs.refresh.{mode}")
        fut = _serve_submit(lf, block=True, wrap=commit)
        self._inflight = fut
        return fut

    def result(self, timeout: Optional[float] = None):
        """The current view result, re-resolved first when stale; the wait
        of a refresh happens here (QueryFuture.result), never in the
        scheduler's worker."""
        if not self.stale():
            inflight, self._inflight = self._inflight, None
            if inflight is not None and not inflight.done():
                # an earlier refresh_async is in flight and nothing
                # superseded it: take that resolution
                return inflight.result(timeout)
            with self._view._lock:
                if self._view._result is not None:
                    return self._view._result
        try:
            return self.refresh_async().result(timeout)
        except CylonError:
            # a failed refresh must not leave the subscription fresh: the
            # retained state is untouched and the next result() retries
            self._stale = True
            raise

    def close(self) -> None:
        """Drop this subscription (its listeners are weak references; close
        clears the in-flight handle)."""
        self._inflight = None


def subscribe(view: IncrementalView) -> Subscription:
    """``stream.subscribe(stream.view(build, *tables))``."""
    return Subscription(view)
