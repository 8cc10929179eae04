"""The resource ledger: live memory accounting of the tiers the engine
touches (counterpart of cylon_tpu/obs/resource.py, without the serving
leases, which come with the scheduler).

DEVICE
    Every :class:`~cylon_tpu_torch.table.Table` registers its shards'
    tensors here at construction (``table.py`` calls :func:`note_table`),
    and a ``weakref.finalize`` on the table unregisters them: frees are
    observed when the GC drops the table, with no sync (byte counts are
    ``numel() * element_size()``, shape properties). Tensors shared
    between tables (a projection reuses the Column objects) are
    refcounted by identity, so a projection costs no ledger bytes.

HOST + DISK
    Wrapped from the spill engine's own accounting
    (``parallel/spill.arena_bytes``, the numbers behind the
    ``shuffle.spill.host_bytes`` / ``disk_bytes`` gauges).

ATTRIBUTION
    A table created while a query's exec-observation record is open
    (``obs/store.exec_obs``) adds its bytes to that record's ``dev``
    field (the per-fingerprint footprint the observation store journals).
    A table created while a query TRACE is active remembers the trace's
    qid, which powers the leak detector: :meth:`ResourceLedger.leaks`
    flags tables still live ``CYLON_TPU_TORCH_LEAK_GRACE_S`` seconds after
    their query finished, each with its creation site (the first stack
    frame outside ``cylon_tpu_torch/``).

COST: the ledger is off unless an ops surface is on
(``CYLON_TPU_TORCH_METRICS_PORT`` or ``CYLON_TPU_TORCH_OBS_DIR`` set, or
tracing active); the off path is one :func:`enabled` check per table.
"""
from __future__ import annotations

import os
import sys
import threading
import time
import weakref
from collections import deque
from typing import Any, Dict, List, Optional

from ..utils import envgate as _eg

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_lock = threading.Lock()
#: every live ledger, for the /metrics exporter (per-context accounting,
#: process-wide exposition)
_LEDGERS: "weakref.WeakSet" = weakref.WeakSet()
#: qid -> finish time of recently finished query traces (the leak
#: detector's "query closed" clock); FIFO-bounded
_FINISHED: Dict[int, float] = {}
_FINISHED_CAP = 4096


def enabled() -> bool:
    """Is the ledger on? True when any ops surface wants it: the metrics
    endpoint, the observation store, or active tracing. Read per call —
    this is the ONE check the disabled path pays per Table construction."""
    if _eg.METRICS_PORT.get():
        return True
    if _eg.OBS_DIR.get():
        return True
    return _eg.TRACE.truthy()


def ledger(ctx) -> "ResourceLedger":
    """The context's ledger, created on first use (per-context accounting:
    tables register with their own context's ledger)."""
    led = ctx.__dict__.get("_res_ledger")
    if led is None:
        with _lock:
            led = ctx.__dict__.get("_res_ledger")
            if led is None:
                led = ResourceLedger(ctx)
                ctx.__dict__["_res_ledger"] = led
                _LEDGERS.add(led)
    return led


def ledgers() -> List["ResourceLedger"]:
    """Every live context's ledger (the exporter's enumeration)."""
    with _lock:
        return list(_LEDGERS)


def _creation_site() -> str:
    """First stack frame OUTSIDE cylon_tpu_torch/: the user call that
    caused this allocation (what a leak report must point at)."""
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if not fn.startswith(_PKG_DIR):
            return f"{fn}:{f.f_lineno}"
        f = f.f_back
    return "<internal>"


def note_table(table) -> None:
    """Register one freshly constructed Table's tensors with its context's
    ledger (called from ``Table.__init__``). No-op, and the only cost,
    when the ledger is off. Never syncs: byte counts are shape
    properties of tensors already referenced."""
    if not enabled():
        return
    ledger(table.ctx)._register(table)


def query_finished(q) -> None:
    """Stamp a query trace's finish time (called from
    ``obs.trace._maybe_finish``) so the leak detector can age tables
    against their owning query's close."""
    with _lock:
        _FINISHED[q.qid] = time.monotonic()
        while len(_FINISHED) > _FINISHED_CAP:
            _FINISHED.pop(next(iter(_FINISHED)))


def leak_grace_s() -> float:
    try:
        return max(float(_eg.LEAK_GRACE_S.get()), 0.0)
    except ValueError:
        return 30.0


class ResourceLedger:
    """One context's live resource accounting. All state is host dicts
    under one lock; reads (:meth:`snapshot`, :meth:`leaks`) may run from
    a metrics scrape thread while the engine works."""

    def __init__(self, ctx):
        self._ctx_ref = weakref.ref(ctx)
        self._lock = threading.Lock()
        # buffer identity -> [nbytes, refcount] (id() keys are safe:
        # entries are removed when the refcount hits 0, before the id
        # can be reused)
        self._bufs: Dict[int, List[int]] = {}
        # table identity -> {bytes, site, t, qid, obs_key, ref}
        self._tables: Dict[int, Dict[str, Any]] = {}
        # finalizer hand-off: a weakref/GC finalizer can fire
        # SYNCHRONOUSLY on whatever thread happens to be allocating —
        # including one already holding this ledger's lock or the
        # metrics module lock — so the finalizer itself takes NO locks:
        # it appends to this deque (atomic) and the next ledger
        # operation drains it under the lock
        self._dead: "deque" = deque()
        self.device_bytes = 0
        self.device_peak = 0

    # -- registration (engine side) ------------------------------------
    def _register(self, table, attrib: Optional[Dict[str, Any]] = None) -> None:
        from . import store as _store
        from . import trace as _trace

        keys: List[int] = []
        tbytes = 0
        new_bytes = 0
        with self._lock:
            self._drain_dead_locked()
            for arr in _tensors(table):
                k = id(arr)
                keys.append(k)
                nb = int(arr.numel()) * int(arr.element_size())
                tbytes += nb
                b = self._bufs.get(k)
                if b is None:
                    self._bufs[k] = [nb, 1]
                    new_bytes += nb
                else:
                    b[1] += 1
            self.device_bytes += new_bytes
            self.device_peak = max(self.device_peak, self.device_bytes)
            live = self.device_bytes
            ntab = len(self._tables) + 1
            q = _trace.current()
            ent: Dict[str, Any] = {
                "bytes": tbytes,
                "site": (
                    attrib["site"] if attrib else _creation_site()
                ),
                "t": attrib["t"] if attrib else time.monotonic(),
                "qid": (
                    attrib["qid"] if attrib
                    else (q.qid if q is not None else None)
                ),
                "label": (
                    attrib["label"] if attrib
                    else (q.label if q is not None else "")
                ),
                "ref": weakref.ref(table),
                "keys": tuple(keys),
            }
            # finalize() never holds the table
            ent["fin"] = weakref.finalize(
                table, self._unregister, id(table), tuple(keys)
            )
            self._tables[id(table)] = ent
        # gauges refresh on every registration (a projection changes
        # live_tables with zero new bytes) and on snapshot() — so frees,
        # observed at the deferred drain, reach the rollup at the next
        # ledger touch instead of leaving a stale-high current value
        from ..utils.tracing import gauge

        gauge("ledger.device_bytes", live)
        gauge("ledger.live_tables", ntab)
        # footprint attribution: bytes allocated under an open
        # exec-observation record feed the per-fingerprint footprint
        _store.note_dev_bytes(new_bytes)

    def _unregister(self, tid: int, keys) -> None:
        """The table finalizer. MUST stay lock-free and allocation-lean:
        it can run mid-GC on a thread holding arbitrary locks (the
        metrics registry's, even this ledger's own)."""
        self._dead.append((tid, keys))

    def _release_keys_locked(self, keys) -> None:
        freed = 0
        for k in keys:
            b = self._bufs.get(k)
            if b is None:
                continue
            b[1] -= 1
            if b[1] <= 0:
                del self._bufs[k]
                freed += b[0]
        self.device_bytes -= freed

    def _drain_dead_locked(self) -> None:
        """Apply deferred finalizer frees (caller holds ``self._lock``)."""
        while True:
            try:
                tid, keys = self._dead.popleft()
            except IndexError:
                break
            self._tables.pop(tid, None)
            self._release_keys_locked(keys)

    # -- read side (ops surface) ---------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """Point-in-time ledger state: per-context device bytes + peak
        and live-table count, and the process-wide host/disk arena bytes
        (wrapping the ``shuffle.spill.*`` accounting). Host dict reads
        only."""
        from ..parallel import spill as _spill
        from ..utils.tracing import gauge

        with self._lock:
            self._drain_dead_locked()
            dev = self.device_bytes
            peak = self.device_peak
            ntab = len(self._tables)
        # scrape-driven gauge refresh: frees applied by the drain above
        # reach the rollup's current value here
        gauge("ledger.device_bytes", dev)
        gauge("ledger.live_tables", ntab)
        host, host_peak, disk, disk_peak = _spill.arena_bytes()
        return {
            "device_bytes": dev,
            "device_peak": peak,
            "live_tables": ntab,
            "host_bytes": host,
            "host_peak": host_peak,
            "disk_bytes": disk,
            "disk_peak": disk_peak,
        }

    def leaks(self, grace_s: Optional[float] = None) -> List[Dict[str, Any]]:
        """Tables still resident ``grace_s`` (default
        ``CYLON_TPU_TORCH_LEAK_GRACE_S``) seconds after their owning query
        trace finished, each with creation-site attribution. A table
        with no owning trace (created outside any query) is never
        flagged — the detector ages tables against query lifecycle, not
        wall clock."""
        if grace_s is None:
            grace_s = leak_grace_s()
        now = time.monotonic()
        out: List[Dict[str, Any]] = []
        with self._lock:
            self._drain_dead_locked()
            entries = list(self._tables.values())
        with _lock:
            finished = dict(_FINISHED)
        for ent in entries:
            qid = ent.get("qid")
            if qid is None:
                continue
            done = finished.get(qid)
            if done is None or now - done < grace_s:
                continue
            if ent["ref"]() is None:
                continue  # raced the GC: not a leak
            out.append({
                "bytes": ent["bytes"],
                "site": ent["site"],
                "age_s": round(now - done, 3),
                "qid": qid,
                "label": ent["label"],
            })
        return out


def _tensors(table):
    """The distinct data and validity tensors of the shards this process
    holds (a shard shared by two Columns counts once)."""
    seen = set()
    for sh in table._shards:
        if sh is None:
            continue
        for col in sh.values():
            for arr in (col.data, col.valid):
                if arr is not None and id(arr) not in seen:
                    seen.add(id(arr))
                    yield arr
