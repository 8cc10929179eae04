"""cylon_tpu_torch.serve: the concurrent query-serving engine (counterpart
of cylon_tpu/serve/).

``collect_async`` submission, a scheduler that runs same-fingerprint plans
over different parameter bindings as one stacked execution, and admission
control that bounds in-flight bytes, so concurrency degrades into queueing
and typed sheds instead of running the card out of memory.
"""
from ..fault.errors import (
    QueryExecError,
    QueryTimeoutError,
    SchedulerClosedError,
    WorkerDiedError,
)
from .batch import QID, BatchTemplate, Unbatchable, is_batchable, stack_tables
from .future import QueryFuture, ServeOverloadError
from .scheduler import ServeScheduler, estimate_query_bytes, scheduler, submit

__all__ = [
    "QID",
    "BatchTemplate",
    "QueryExecError",
    "QueryFuture",
    "QueryTimeoutError",
    "SchedulerClosedError",
    "ServeOverloadError",
    "ServeScheduler",
    "Unbatchable",
    "WorkerDiedError",
    "estimate_query_bytes",
    "is_batchable",
    "scheduler",
    "stack_tables",
    "submit",
]
