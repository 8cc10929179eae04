"""The typed error taxonomy (counterpart of cylon_tpu/fault/errors.py):
every failure the engine surfaces through its degradation paths.

``CylonError``
    Base of every engine-raised failure, on two axes:

    - ``scope``: what the failure poisons. ``"query"``: this one query
      failed, and the context, its caches, tables and every other query
      are untouched. ``"table"``: one table's buffers are suspect.
      ``"context"``: the owning component is done (a closed scheduler).
    - ``retryable``: resubmitting the same work may succeed (the cause was
      load or transient I/O, not the query itself).

The invariant every error path upholds: a failure ends in exactly one of
{the oracle's result, a typed CylonError}, with every host arena and
ledger entry released, and never kills the process.

The port raises ``SpillIOError`` (the spill tiers, parallel/spill.py),
the serving errors (serve/: ``QueryExecError``, ``QueryTimeoutError``,
``WorkerDiedError``, ``SchedulerClosedError``) and the streaming error
(stream/ingest.py: ``StreamIngestError``). Dependency-free, so every layer
can raise through it without import cycles.
"""
from __future__ import annotations

from typing import Optional

#: the scope axis: what a failure poisons
SCOPE_QUERY = "query"
SCOPE_TABLE = "table"
SCOPE_CONTEXT = "context"
SCOPES = (SCOPE_QUERY, SCOPE_TABLE, SCOPE_CONTEXT)


class CylonError(Exception):
    """Base of every typed engine failure (see module docstring for the
    ``scope`` / ``retryable`` axes)."""

    #: resubmitting the same work may succeed
    retryable: bool = False
    #: what this failure poisons: query | table | context
    scope: str = SCOPE_QUERY


class SpillIOError(CylonError, OSError):
    """Spill-tier I/O failed past the whole degradation ladder: the
    bounded-backoff retries (``CYLON_TPU_TORCH_SPILL_RETRIES``) were exhausted
    AND the disk arenas could not re-plan onto the host-RAM tier (host
    budget exceeded, or the degradation copy itself failed). Fails ONLY
    the owning query — its sink arenas are closed, its lease released —
    never the process. ``retryable``: the spill volume may recover."""

    retryable = True
    scope = SCOPE_QUERY

    def __init__(self, what: str = "spill I/O failed",
                 cause: Optional[BaseException] = None):
        super().__init__(what if cause is None else f"{what}: {cause}")
        self.what = what


class QueryExecError(CylonError):
    """One query's execution failed. Carries the plan ``fingerprint``
    (the shape identity — what a quarantine or a dashboard keys on) and
    the ``binding`` label of the failed parameter binding, so a batched
    group's fallback can report WHICH of the B bindings was poisoned."""

    retryable = False
    scope = SCOPE_QUERY

    def __init__(self, message: str, fingerprint=None,
                 binding: Optional[str] = None):
        super().__init__(message)
        self.fingerprint = fingerprint
        self.binding = binding


class QueryTimeoutError(CylonError, TimeoutError):
    """The query exceeded its serving deadline from submit (A9):
    its future is FAILED (not left hanging) and its admission lease
    released. ``retryable``: the same query may well fit the deadline on
    a less loaded scheduler."""

    retryable = True
    scope = SCOPE_QUERY


class WorkerDiedError(CylonError):
    """The serving worker thread died while this query was in flight.
    The supervisor fails the in-flight group with this error, releases
    the leases, and respawns the worker on the next submit — queued work
    and new submits proceed; only the group the dying worker held is
    lost (resubmit it)."""

    retryable = True
    scope = SCOPE_QUERY


class StreamIngestError(CylonError, RuntimeError):
    """A streaming append failed past the state-store's degradation
    paths: the host-arena write raised through its ladder, the
    ``CYLON_TPU_TORCH_STREAM_STATE_BUDGET`` byte budget would be exceeded, or
    the batch failed schema validation. The append is ROLLED BACK — the
    table's prior generation (watermark, arena rows, snapshots) is
    untouched and still queryable; only the offered batch is lost.
    ``scope="table"``: the failure names one appendable table, not the
    context. ``retryable``: transient causes (ENOSPC on the spill
    volume, a momentarily full budget) may clear; a schema mismatch will
    not, but re-offering after fixing the batch is the same call."""

    retryable = True
    scope = SCOPE_TABLE

    def __init__(self, what: str = "stream ingest failed",
                 cause: Optional[BaseException] = None):
        super().__init__(what if cause is None else f"{what}: {cause}")
        self.what = what


class SchedulerClosedError(CylonError, RuntimeError):
    """The serving scheduler was closed with this query still pending
    (or a submit raced ``close()``). ``scope="context"``: this scheduler
    is done — resubmit against a fresh one (``serve.scheduler(ctx)``
    replaces a closed scheduler on next use)."""

    retryable = True
    scope = SCOPE_CONTEXT
