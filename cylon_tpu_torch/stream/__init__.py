"""Streaming ingest and incremental views (counterpart of
cylon_tpu/stream/).

- ``ingest.py``: :class:`AppendableTable`, chunked, schema-validated
  appends staged in a host arena of the spill tier, with monotone
  generations, a row watermark an append, and fresh descriptors a
  snapshot.
- ``delta.py``: :class:`IncrementalView`, delta-aware recompute of a
  lazy plan; ``CYLON_TPU_TORCH_NO_IVM=1`` is the full-recompute oracle.
- ``subscribe.py``: :class:`Subscription`, re-resolving futures that ride
  the serving scheduler's admission, leases and batching.
"""
from .ingest import AppendableTable  # noqa: F401
from .delta import IncrementalView, ivm_disabled, ivm_enabled, view  # noqa: F401
from .subscribe import Subscription, subscribe  # noqa: F401

__all__ = [
    "AppendableTable",
    "IncrementalView",
    "Subscription",
    "ivm_disabled",
    "ivm_enabled",
    "subscribe",
    "view",
]
