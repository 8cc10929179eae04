"""AppendableTable: chunked, schema-validated streaming ingest over the
host arena of the spill tier (counterpart of cylon_tpu/stream/ingest.py).

An :class:`AppendableTable` is a growing logical table whose rows live on
the host, in one :class:`~cylon_tpu_torch.parallel.spill.HostArena` per
table: ingested state rides the same budget, promotion and degradation as
shuffle spill (RAM by default, disk-backed buffers past
``CYLON_TPU_TORCH_SPILL_HOST_BUDGET``, counted in ``arena_bytes()``).

Generations and watermarks
    Every committed append bumps a monotone ``generation`` and records a
    row watermark ``(generation -> cumulative row count)``.
    ``table(at_gen)`` snapshots any generation; ``delta_table(since)``
    builds a table of only the rows appended after a watermark. Both
    counts are host-known. Snapshots are stamped ``_stream_gen =
    (source_token, generation)`` (a delta ``(token, since, current)``),
    which ``plan.nodes.Scan._params`` reads into ``gated_fingerprint``:
    cached executors, observation profiles and serving groups never alias
    across refreshes.

Descriptor invalidation
    Appends break sortedness and widen value ranges, so a snapshot never
    inherits ``Ordering`` or range-stat descriptors from an earlier
    generation: every snapshot is a fresh encode with both empty.

Failure domain
    An append either commits (generation bumped, watermark recorded) or
    rolls back completely: validation errors, the
    ``CYLON_TPU_TORCH_STREAM_STATE_BUDGET`` byte budget, arena I/O failures
    and the ``stream.append`` fault seam all surface as a typed
    :class:`~cylon_tpu_torch.fault.errors.StreamIngestError` with the arena
    row cursor restored: the prior generation stays queryable. The seam
    sits inside the ``except OSError`` rollback, so it takes errno kinds
    only (fault/inject.py rejects others).

Staging is chunked by ``CYLON_TPU_TORCH_STREAM_CHUNK_ROWS``, which bounds
the host copy of one step and never reaches a kernel shape (a snapshot's
shards follow the total arena rows).

Under ``torch.distributed`` every rank holds its own arena and must append
the same batches in the same order: a snapshot is ``Table.from_pydict`` of
the global rows, of which each rank stages its own shards' blocks.
"""
from __future__ import annotations

import threading
import weakref
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..fault import inject as _fault
from ..fault.errors import StreamIngestError
from ..parallel.spill import HostArena
from ..table import Table
from ..utils import envgate as _eg
from ..utils.tracing import bump, gauge

#: the staging chunk when CYLON_TPU_TORCH_STREAM_CHUNK_ROWS is unset
DEFAULT_CHUNK_ROWS = 65536

#: process-wide source tokens: two appendable tables (even over the same
#: data) never share a fingerprint identity
_SRC_SEQ_LOCK = threading.Lock()
_SRC_SEQ = 0


def _next_token() -> int:
    global _SRC_SEQ
    with _SRC_SEQ_LOCK:
        _SRC_SEQ += 1
        return _SRC_SEQ


def _chunk_rows() -> int:
    raw = _eg.STREAM_CHUNK_ROWS.get()
    try:
        n = int(raw) if raw else DEFAULT_CHUNK_ROWS
    except ValueError:
        n = DEFAULT_CHUNK_ROWS
    return max(n, 1)


def _state_budget() -> Optional[int]:
    raw = _eg.STREAM_STATE_BUDGET.get()
    try:
        return int(raw) if raw else None
    except ValueError:
        return None


def _is_null(v) -> bool:
    return v is None or (isinstance(v, float) and np.isnan(v))


class _ColSpec:
    """One column's ingest contract: its kind and its arena dtype.

    ``kind`` is ``"str"`` (an object buffer, held in RAM like every decoded
    dictionary) or ``"num"`` (a fixed-width buffer that can go to the disk
    tier). Both carry a validity lane."""

    __slots__ = ("name", "kind", "dtype")

    def __init__(self, name: str, kind: str, dtype: np.dtype):
        self.name = name
        self.kind = kind
        self.dtype = dtype

    def normalize(self, values) -> Tuple[np.ndarray, np.ndarray]:
        """Validate and coerce one appended column to ``(data, valid)`` in
        this column's arena layout. Raises ValueError on a mismatch."""
        arr = values if isinstance(values, np.ndarray) else np.asarray(values)
        if self.kind == "str":
            if arr.dtype != object:
                if not (arr.dtype.kind in ("U", "S") or arr.size == 0):
                    raise ValueError(
                        f"column {self.name!r}: expected strings, got dtype {arr.dtype}")
                arr = arr.astype(object)
            valid = np.fromiter((not _is_null(v) for v in arr), dtype=bool, count=len(arr))
            data = np.array([v if ok else None for v, ok in zip(arr, valid)], dtype=object)
            for v, ok in zip(data, valid):
                if ok and not isinstance(v, str):
                    raise ValueError(
                        f"column {self.name!r}: expected strings, got {type(v).__name__}")
            return data, valid
        # numeric lane
        if arr.dtype == object:
            valid = np.fromiter((not _is_null(v) for v in arr), dtype=bool, count=len(arr))
            data = np.zeros(len(arr), dtype=self.dtype)
            if valid.any():
                picked = np.asarray([v for v in arr[valid]])
                if picked.dtype == object or not np.can_cast(
                        picked.dtype, self.dtype, casting="same_kind"):
                    raise ValueError(
                        f"column {self.name!r}: cannot cast appended values "
                        f"({picked.dtype}) to {self.dtype} (same_kind)")
                data[valid] = picked.astype(self.dtype)
            return data, valid
        if not np.can_cast(arr.dtype, self.dtype, casting="same_kind"):
            raise ValueError(
                f"column {self.name!r}: cannot cast appended values ({arr.dtype}) to "
                f"{self.dtype} (same_kind)")
        return arr.astype(self.dtype, copy=False), np.ones(len(arr), bool)

    def decode(self, data: np.ndarray, valid: np.ndarray):
        """Arena layout -> the host columns ``Table.from_pydict`` takes
        (nulls as None in object arrays)."""
        if self.kind == "str":
            return data
        if valid.all():
            return data
        obj = data.astype(object)
        obj[~valid] = None
        return obj


def _infer_spec(name: str, values) -> _ColSpec:
    arr = values if isinstance(values, np.ndarray) else np.asarray(values)
    if arr.dtype == object or arr.dtype.kind in ("U", "S"):
        nonnull = [v for v in arr if not _is_null(v)]
        if any(isinstance(v, str) for v in nonnull):
            return _ColSpec(name, "str", np.dtype(object))
        if not nonnull:
            raise ValueError(
                f"column {name!r}: cannot infer a dtype from an all-null initial column")
        inferred = np.asarray(nonnull).dtype
        if inferred == object:
            raise ValueError(
                f"column {name!r}: mixed non-string object values are not ingestible")
        return _ColSpec(name, "num", inferred)
    if arr.dtype.kind not in ("i", "u", "f", "b"):
        raise ValueError(f"column {name!r}: unsupported dtype {arr.dtype}")
    return _ColSpec(name, "num", arr.dtype)


class AppendableTable:
    """A growing logical table: a host arena, a generation counter and a
    watermark per append (see the module docstring)."""

    def __init__(self, ctx, data: Dict[str, Any]):
        if not data:
            raise ValueError("AppendableTable needs at least one column")
        self.ctx = ctx
        self._token = _next_token()
        self._lock = threading.RLock()
        self._specs: List[_ColSpec] = [_infer_spec(name, values) for name, values in data.items()]
        self._arena = HostArena([(s.name, s.dtype, True) for s in self._specs])
        self._gen = 0
        #: _marks[g] = cumulative arena rows as of generation g
        self._marks: List[int] = [0]
        #: one-slot snapshot cache (generation, Table); views keep older
        #: generations alive by holding their tables
        self._snap: Optional[Tuple[int, Table]] = None
        #: weak references to listeners (``_on_append(src)``)
        self._listeners: List = []
        self._closed = False
        n0 = self._ingest_batch(data)
        self._marks[0] = self._arena.rows
        if n0 == 0:
            raise ValueError("AppendableTable needs non-empty initial data")

    # -- introspection -------------------------------------------------
    @property
    def generation(self) -> int:
        """The monotone generation counter (0 = the initial load)."""
        return self._gen

    @property
    def row_count(self) -> int:
        """Total ingested rows (host-known)."""
        return self._arena.rows

    @property
    def state_bytes(self) -> int:
        """The state arena's bytes."""
        return self._arena.nbytes

    @property
    def column_names(self) -> List[str]:
        return [s.name for s in self._specs]

    def watermark(self, gen: Optional[int] = None) -> int:
        """Cumulative row count as of ``gen`` (default: the current one)."""
        g = self._gen if gen is None else gen
        if not (0 <= g <= self._gen):
            raise ValueError(f"generation {g} not in [0, {self._gen}]")
        return self._marks[g]

    def rows_since(self, gen: int) -> int:
        """Rows appended after generation ``gen`` (host-known)."""
        return self._arena.rows - self.watermark(gen)

    # -- ingest --------------------------------------------------------
    def _ingest_batch(self, data: Dict[str, Any]) -> int:
        """Validate, normalize and copy one batch into the arena in chunks;
        returns its rows. Raises (ValueError on the schema, OSError from the
        arena) without committing: the caller rolls back and types it."""
        names = list(data.keys())
        if names != self.column_names:
            raise ValueError(
                f"append schema mismatch: expected {self.column_names}, got {names}")
        cols = [s.normalize(data[s.name]) for s in self._specs]
        n = len(cols[0][0])
        for (d, _v), s in zip(cols, self._specs):
            if len(d) != n:
                raise ValueError(f"column {s.name!r}: ragged append ({len(d)} vs {n})")
        if n == 0:
            return 0
        budget = _state_budget()
        if budget is not None:
            est = sum(n * (8 if s.kind == "str" else s.dtype.itemsize) + n for s in self._specs)
            if self._arena.nbytes + est > budget:
                raise StreamIngestError(
                    f"append of {n} rows (~{est} B) would exceed "
                    f"CYLON_TPU_TORCH_STREAM_STATE_BUDGET={budget} "
                    f"(state at {self._arena.nbytes} B)")
        # the ingestion seam: inside the OSError rollback, between the
        # validation and budget admission and the first arena write
        _fault.check("stream.append")
        chunk = _chunk_rows()
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            self._arena.append_batch([(d[lo:hi], v[lo:hi]) for d, v in cols])
            bump("stream.append.chunks")
        return n

    def append(self, data: Dict[str, Any]) -> int:
        """Append one batch; returns the new generation. Commits (generation
        bumped, watermark recorded, listeners notified) or rolls back typed
        (the module docstring's failure domain). An empty batch is a no-op
        that bumps no generation."""
        with self._lock:
            if self._closed:
                raise StreamIngestError("append on a closed AppendableTable")
            saved_rows = self._arena.rows
            try:
                n = self._ingest_batch(data)
            except StreamIngestError:
                raise
            except (ValueError, TypeError) as e:
                # a schema or shape rejection: validation precedes every
                # write, but restore the cursor all the same
                self._arena.rows = saved_rows
                bump("stream.append.rejected")
                raise StreamIngestError("append rejected", cause=e) from e
            except OSError as e:
                # the arena's ladder (ENOSPC/EIO/ENOMEM, the stream.append
                # seam, arena.alloc and spill.write underneath): rows past
                # the restored cursor are dead capacity, the prior
                # generation is untouched
                self._arena.rows = saved_rows
                bump("stream.append.rollback")
                raise StreamIngestError("append rolled back", cause=e) from e
            if n == 0:
                return self._gen
            self._gen += 1
            self._marks.append(self._arena.rows)
            self._snap = None
            bump("stream.append", rows=n)
            gauge("stream.state_bytes", self._arena.nbytes)
            listeners, self._listeners = self._listeners, []
            for ref in listeners:
                if ref() is not None:
                    self._listeners.append(ref)
            gen = self._gen
        # notify outside the lock: a listener may re-enter (refresh ->
        # snapshot) and must not deadlock against a concurrent append
        for ref in listeners:
            sub = ref()
            if sub is not None:
                sub._on_append(self)
        return gen

    # -- snapshots -----------------------------------------------------
    def _slice_pydict(self, lo: int, hi: int) -> Dict[str, Any]:
        cols = self._arena.columns()
        return {s.name: s.decode(d[lo:hi], None if v is None else v[lo:hi])
                for s, (d, v) in zip(self._specs, cols)}

    def _build(self, lo: int, hi: int, stamp) -> Table:
        t = Table.from_pydict(self.ctx, self._slice_pydict(lo, hi))
        # the generation identity Scan._params reads into
        # gated_fingerprint; _stream_src maps a plan's Scans back to their
        # sources (stream/delta.py)
        t._stream_gen = stamp
        t._stream_src = weakref.ref(self)
        return t

    def table(self, at_gen: Optional[int] = None) -> Table:
        """Snapshot of generation ``at_gen`` (default: the current one) as an
        ordinary :class:`Table`: a fresh encode with no order or range-stat
        descriptors carried over from an earlier snapshot."""
        with self._lock:
            g = self._gen if at_gen is None else at_gen
            hi = self.watermark(g)
            if g == self._gen and self._snap is not None:
                return self._snap[1]
            t = self._build(0, hi, (self._token, g))
            if g == self._gen:
                self._snap = (g, t)
            return t

    def delta_table(self, since_gen: int) -> Table:
        """Only the rows appended after generation ``since_gen``, stamped
        ``(token, since, current)`` so a delta plan never aliases a
        snapshot plan in the caches."""
        with self._lock:
            lo = self.watermark(since_gen)
            hi = self._arena.rows
            if lo >= hi:
                raise ValueError(f"no rows after generation {since_gen} (current {self._gen})")
            return self._build(lo, hi, (self._token, since_gen, self._gen))

    # -- lifecycle -----------------------------------------------------
    def subscribe_listener(self, listener) -> None:
        """Register a listener (``_on_append(src)`` is called outside the
        ingest lock after each committed append), held by weak reference:
        dropping the listener unsubscribes it."""
        with self._lock:
            self._listeners.append(weakref.ref(listener))

    def close(self) -> None:
        """Release the state arena (idempotent). Snapshots already built
        stay valid: their rows were copied to the device at encode."""
        with self._lock:
            self._closed = True
            self._snap = None
            self._arena.close()
            gauge("stream.state_bytes", 0)

    def __repr__(self) -> str:
        return (f"AppendableTable[{', '.join(self.column_names)}] gen={self._gen} "
                f"rows={self._arena.rows} state={self._arena.nbytes}B")
