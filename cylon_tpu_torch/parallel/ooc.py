"""Out-of-core join: a thin layer over the spill-tiered shuffle
(counterpart of cylon_tpu/parallel/ooc.py).

Reference analog: the byte-chunked streaming shuffle
(arrow/arrow_all_to_all.cpp:83-141) exists so that tables larger than one
node's memory move through fixed-size buffers. The join is three pieces
over ``parallel/spill.py``, as in the JAX package:

ingest
    Each host chunk is uploaded, stamped with a rider sub-bucket lane
    (murmur3 bits 16 and up, the same hash family every shuffle uses, so a
    key's bucket is the same in every chunk and on both sides) and sent
    through the engine's ``_shuffle_many`` with a caller-owned
    :class:`_BucketSink`: rows hash-route to their owner shard through the
    chunked, budget-bounded rounds (with lane packing and the skew split),
    and each received round streams into per-(bucket, shard) host arenas.
    At world 1 the chunk is its own shard and is staged into the sink
    directly. Device footprint per chunk: the chunk plus the engine's
    bounded round buffers.
join
    Once both streams are drained, bucket b of the left joins bucket b of
    the right (equal hash: co-partitioned, and already on the same shards,
    so the bucket join's own shuffle moves rows within a shard). Pair b+1
    is uploaded before pair b's join, and the results leave the card on
    one drain thread, at most two undrained: two bucket pairs and two
    results on the card at a time.
sink
    Results leave the card through the packed lane copy into ONE host
    arena (:class:`HostSink`), grown from each result's known counts.

Device memory is bounded by max(chunk + round buffers, two bucket pairs and
two results), never by the table: with K buckets a table of N rows needs
about 2N/K rows a shard at the join stage.

The port's residency figures (:attr:`OutOfCoreJoin.max_device_cap`,
``join_phase_device_cap``) count its exact-length rows: the chunk, the
engine's round buffers with their spare rows, the staged pairs and the
undrained results. The JAX package counts padded capacities, so the values
differ.
"""
from __future__ import annotations

import concurrent.futures
import threading
import time
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from ..column import Column
from ..dtypes import DataType, Type
from ..fault.errors import CylonError
from ..ops.partition import hash_partition_ids
from ..table import Table, _ShuffleSpec, _shuffle_many
from ..utils.tracing import bump, span
from . import spill as _spill

__all__ = ["OutOfCoreJoin", "HostSink"]

#: rider lane carrying each row's sub-bucket through the exchange
_SUBPART = "__cylon_subpart"


def _promote(a: np.dtype, b: np.dtype) -> np.dtype:
    """Common decoded dtype of two batches (object dominates: decoded
    dictionary values and nullable bools are object arrays)."""
    if a == np.dtype(object) or b == np.dtype(object):
        return np.dtype(object)
    return np.promote_types(a, b)


def _promote_all(dtype_lists) -> List[np.dtype]:
    """Per column, the common dtype of several batches' column dtypes."""
    out = list(dtype_lists[0])
    for dts in dtype_lists[1:]:
        out = [_promote(a, b) for a, b in zip(out, dts)]
    return out


def _rows_a_shard(t: Table) -> int:
    """Rows of ``t``'s largest shard: its device residency a shard."""
    return int(t.row_counts.max())


def _queued_events(t: Table):
    """{device: CUDA event after the work queued so far} of the cards
    ``t``'s shards live on, or None on the CPU."""
    devs = {t._shards[s][t.column_names[0]].data.device for s in t.ctx.local_shards}
    if any(d.type != "cuda" for d in devs):
        return None
    out = {}
    for d in devs:
        out[d] = torch.cuda.Event()
        out[d].record(torch.cuda.current_stream(d))
    return out


class _BucketSink:
    """Ingest sink of one side: rows arrive from ``_shuffle_many`` already
    routed to their owner shard; this sink bins them by the rider
    sub-bucket lane into per-(bucket, shard) arenas. Values are stored
    DECODED (each chunk encodes its own dictionary, so logical values, not
    codes, are the stable host form; the bucket staging encodes again and
    unifies). Under several processes a rank's arenas hold its own shards
    only."""

    def __init__(self, k: int, world: int, backing: int) -> None:
        self.k = k
        self.world = world
        self.backing = backing
        self.arenas: Dict[tuple, _spill.HostArena] = {}
        self.names: Optional[List[str]] = None
        self.device_rows_peak = 0  # the engine's ingest residency, in rows
        self.fetch_s = 0.0
        # bucket -> (rows over every shard, decoded dtypes): plan_buckets
        self._buckets: Dict[int, tuple] = {}

    def accept(self, table, shard_cols, counts) -> None:
        t0 = time.perf_counter()
        names = table.column_names
        si = names.index(_SUBPART)
        keep = [ci for ci in range(len(names)) if ci != si]
        if self.names is None:
            self.names = [names[ci] for ci in keep]
        meta = [table._ref[n] for n in names]
        for s in range(self.world):
            n = int(counts[s])
            if not n or shard_cols[s] is None:
                continue
            cols = shard_cols[s]
            sub = np.asarray(cols[si][0][:n])
            order = np.argsort(sub, kind="stable")
            bc = np.bincount(sub, minlength=self.k)[: self.k]
            offs = np.concatenate([[0], np.cumsum(bc)]).astype(np.int64)
            decoded = [
                meta[ci].decode_host(
                    np.asarray(cols[ci][0][:n]), None if cols[ci][1] is None else cols[ci][1][:n]
                )[order]
                for ci in keep
            ]
            for b in range(self.k):
                lo, hi = int(offs[b]), int(offs[b + 1])
                if hi <= lo:
                    continue
                arena = self.arenas.get((b, s))
                if arena is None:
                    arena = self.arenas[(b, s)] = _spill.HostArena(
                        [(nm, d.dtype, False) for nm, d in zip(self.names, decoded)],
                        backing=self.backing,
                    )
                batch = []
                for ci, d in enumerate(decoded):
                    want = _promote(arena.schema[ci][1], d.dtype)
                    arena.promote(ci, want)
                    batch.append((d[lo:hi].astype(want, copy=False), None))
                arena.append_batch(batch)
        self.fetch_s += time.perf_counter() - t0

    def plan_buckets(self, ctx) -> None:
        """Each bucket's rows over every shard and its decoded dtypes
        (promoted over its arenas): from this process's arenas, gathered
        from every rank under several processes, so that every rank skips
        the same buckets and stages the same dtypes."""
        mine = {}
        for b in range(self.k):
            got = [a for s in range(self.world) if (a := self.arenas.get((b, s))) is not None]
            if got:
                mine[b] = (sum(a.rows for a in got),
                           _promote_all([[dt for _n, dt, _hv in a.schema] for a in got]))
        if len(ctx.local_shards) != ctx.world_size:
            merged: Dict[int, list] = {}
            for part in ctx.comm.gather_host(mine):
                for b, entry in part.items():
                    merged.setdefault(b, []).append(entry)
            mine = {b: (sum(r for r, _d in es), _promote_all([d for _r, d in es]))
                    for b, es in merged.items()}
        self._buckets = mine

    def bucket_shards(self, b: int):
        """Per-shard logical column dicts of bucket ``b`` (dtypes unified
        across shards; None for a shard another process holds), or None
        when the bucket is empty on every shard."""
        if self.names is None or not self._buckets.get(b, (0, None))[0]:
            return None
        dtypes = self._buckets[b][1]
        shards = []
        for s in range(self.world):
            a = self.arenas.get((b, s))
            cols = a.columns() if a is not None else None
            shards.append({nm: (np.empty((0,), dtypes[ci]) if cols is None
                                else cols[ci][0].astype(dtypes[ci], copy=False))
                           for ci, nm in enumerate(self.names)})
        return shards

    def release(self, b: int) -> None:
        """Free bucket ``b``'s arenas as the join consumes them."""
        for s in range(self.world):
            a = self.arenas.pop((b, s), None)
            if a is not None:
                a.close()

    def close(self) -> None:
        for a in self.arenas.values():
            a.close()
        self.arenas.clear()


class HostSink:
    """Arena-backed result sink: every result leaves the card through the
    packed lane copy (:func:`spill.stage_to_sink`) into ONE host arena,
    reserved from the result's known counts; reads are zero-copy views.
    ``rows`` counts every shard's rows; under several processes a rank's
    arena holds its own shards' rows, shard-major, as ``to_pydict`` orders
    them. Each append records the arena rows each shard took, so that
    ``result_pydict(shard=s)`` gives one shard's rows. It also serves as a
    shuffle spec's caller-owned sink (:meth:`accept`)."""

    def __init__(self, op_id: str = "host_sink", backing: int = _spill.TIER_HOST):
        self.rows = 0
        self.fetch_s = 0.0  # cost split: the results' device -> host copies
        self._backing = backing
        self._arena: Optional[_spill.HostArena] = None
        self._names: Optional[List[str]] = None
        self._spans: Dict[int, List[tuple]] = {}  # shard -> [(first arena row, rows)]

    def process(self, table: Table, edge: int = 0, after=None) -> None:
        """Stage ``table`` into the arena (``after``: {device: event} the
        copy waits for, from a thread other than the producer's)."""
        t0 = time.perf_counter()
        counts = np.asarray(table.row_counts, np.int64)
        n = int(counts.sum())
        if n:
            if self._arena is not None:
                self._arena.reserve(int(counts[table.ctx.local_shards].sum()))
            _spill.stage_to_sink(self, table, counts, after=after)
        self.rows += n
        self.fetch_s += time.perf_counter() - t0

    def accept(self, table, shard_cols, counts) -> None:
        """Decode each shard's physical rows and append them shard-major
        (the global order ``to_pydict`` gives)."""
        meta = [table._ref[n] for n in table.column_names]
        batches = []
        at = self._arena.rows if self._arena is not None else 0
        for s in range(len(counts)):
            n = int(counts[s])
            if not n or shard_cols[s] is None:
                continue
            self._spans.setdefault(s, []).append((at, n))
            at += n
            batches.append([
                meta[ci].decode_host(np.asarray(d[:n]), None if v is None else v[:n])
                for ci, (d, v) in enumerate(shard_cols[s])
            ])
        if not batches:
            return
        merged = [np.concatenate([b[ci] for b in batches]) if len(batches) > 1 else batches[0][ci]
                  for ci in range(len(meta))]
        if self._arena is None:
            self._names = table.column_names
            self._arena = _spill.HostArena(
                [(nm, m.dtype, False) for nm, m in zip(self._names, merged)],
                backing=self._backing,
            )
        out = []
        for ci, m in enumerate(merged):
            want = _promote(self._arena.schema[ci][1], m.dtype)
            self._arena.promote(ci, want)
            out.append((m.astype(want, copy=False), None))
        self._arena.append_batch(out)

    def result(self) -> Table:
        raise RuntimeError("HostSink keeps results on the host; use result_pydict()")

    def result_pydict(self, shard: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Every row this process holds, or the rows of ``shard`` alone in
        the order they arrived."""
        if self._arena is None:
            return {}
        # the read rides the spill retry ladder: a tier-2 EIO retries, then
        # fails typed with the arena closed
        try:
            cols = _spill._retry_io("ooc result read", self._arena.columns)
        except _spill.SpillIOError:
            self.close()
            raise
        if shard is None:
            return {nm: col for nm, (col, _v) in zip(self._names, cols)}
        spans = self._spans.get(shard, [])
        return {nm: np.concatenate([col[a:a + n] for a, n in spans]) if spans else col[:0]
                for nm, (col, _v) in zip(self._names, cols)}

    def close(self) -> None:
        if self._arena is not None:
            self._arena.close()
            self._arena = None
        self._spans = {}


class OutOfCoreJoin:
    """Join two chunk streams whose totals exceed device memory.

    ``execute(left_chunks, right_chunks)`` takes iterables of host column
    dicts and returns the :class:`HostSink`. K buckets bound a bucket's
    device rows to about total / K. The partitioning, the byte budget and
    the skew split all run through ``_shuffle_many``; this class owns only
    the chunk ingest and the result sink. Only ``how="inner"`` is
    supported, as in the JAX package."""

    def __init__(self, ctx, on, how: str = "inner", num_buckets: int = 8,
                 byte_budget: Optional[int] = None, **join_kwargs):
        if how != "inner":
            # an outer join needs the null extension of one-sided buckets,
            # which skipping the empty buckets would drop
            raise NotImplementedError("OutOfCoreJoin supports how='inner' only")
        keys = on if isinstance(on, (list, tuple)) else [on]
        self.ctx = ctx
        self.on = on
        self.keys = list(keys)
        self.k = int(num_buckets)
        self.byte_budget = byte_budget
        self.join_kwargs = join_kwargs
        backing = _spill.TIER_DISK if _spill.forced_tier() == _spill.TIER_DISK else _spill.TIER_HOST
        world = ctx.world_size
        self.lp = _BucketSink(self.k, world, backing)
        self.rp = _BucketSink(self.k, world, backing)
        self.sink = HostSink(backing=backing)
        self._ingest_cap = 0  # an uploaded chunk's rows a shard
        self._join_cap = 0  # the bucket-join stage's rows a shard
        self.stage_s = 0.0  # cost split: bucket uploads (host -> device)
        self.join_s = 0.0  # cost split: the bucket joins
        self.drain_s = 0.0  # cost split: the result downloads (drain thread)

    # -- ingest --------------------------------------------------------
    def _with_subpart(self, t: Table) -> Table:
        """Stamp the sub-bucket lane: murmur3 bits 16 and up (``hash_shift``),
        independent of the low bits the ingest shuffle routes on."""
        kflat = t._key_hash_cols(self.keys)
        return t.add_column(_SUBPART, t._per_shard(lambda s: Column(
            hash_partition_ids(kflat[s], None, self.k, hash_shift=16), DataType(Type.INT32))))

    def _ingest(self, sink: _BucketSink, chunk: Dict[str, np.ndarray]) -> None:
        t = Table.from_pydict(self.ctx, dict(chunk))
        if t.row_count == 0:
            return
        t2 = self._with_subpart(t)
        self._ingest_cap = max(self._ingest_cap, _rows_a_shard(t2))
        if self.ctx.world_size == 1:
            # no shards to route over: the chunk is its own shard
            _spill.stage_to_sink(sink, t2, np.asarray(t2.row_counts))
            return
        _shuffle_many([_ShuffleSpec(t2, tuple(self.keys), self.byte_budget, sink=sink)])

    # -- bucket joins --------------------------------------------------
    def _bucket_table(self, bsink: _BucketSink, b: int) -> Optional[Table]:
        shards = bsink.bucket_shards(b)
        if shards is None:
            return None
        t0 = time.perf_counter()
        local = set(self.ctx.local_shards)
        t = Table.from_shards(self.ctx, [sh if s in local else None for s, sh in enumerate(shards)])
        self.stage_s += time.perf_counter() - t0
        return t

    def _stage_pair(self, b: int):
        """Upload bucket pair ``b``, or None if either side is empty (the
        inner join of an empty side is empty)."""
        if b >= self.k:
            return None
        lt = self._bucket_table(self.lp, b)
        rt = self._bucket_table(self.rp, b)
        self.lp.release(b)
        self.rp.release(b)
        if lt is None or rt is None:
            return None
        return lt, rt

    def _join_buckets(self) -> None:
        # pair b+1 is uploaded before pair b's join, and the results leave
        # the card on one drain thread, at most two undrained (a 2-slot
        # semaphore). A result's copy runs on a side stream that waits for
        # an event recorded right after its join, so it overlaps the next
        # join instead of queuing behind it on the shared stream.
        self.lp.plan_buckets(self.ctx)
        self.rp.plan_buckets(self.ctx)
        drain_slots = threading.Semaphore(2)
        fut_caps: List[tuple] = []
        ex = concurrent.futures.ThreadPoolExecutor(max_workers=1, thread_name_prefix="ooc_drain")

        def drain(out, after):
            t0 = time.perf_counter()
            try:
                self.sink.process(out, after=after)
            finally:
                self.drain_s += time.perf_counter() - t0
                drain_slots.release()

        try:
            staged = self._stage_pair(0)
            for b in range(self.k):
                cur, staged = staged, self._stage_pair(b + 1)
                undrained = sum(c for f, c in fut_caps if not f.done())
                resident = sum(_rows_a_shard(t) for pair in (cur, staged) if pair for t in pair)
                if cur is None:
                    self._join_cap = max(self._join_cap, resident + undrained)
                    continue
                lt, rt = cur
                del cur
                t0 = time.perf_counter()
                out = lt.distributed_join(rt, on=self.on, **self.join_kwargs)
                after = _queued_events(out)
                self.join_s += time.perf_counter() - t0
                cap_out = _rows_a_shard(out)
                self._join_cap = max(self._join_cap, resident + undrained + cap_out)
                del lt, rt
                drain_slots.acquire()  # at most two undrained results
                fut_caps.append((ex.submit(drain, out, after), cap_out))
                del out
        finally:
            # read every future before the shutdown: stopping at the first
            # failure would leave the rest unread and the thread running
            errs = []
            for f, _cap in fut_caps:
                try:
                    f.result()
                except Exception as e:  # noqa: BLE001 - re-raised below
                    errs.append(e)
            ex.shutdown(wait=True)
            if errs:
                raise errs[0]

    def execute(self, left_chunks: Iterable[Dict[str, np.ndarray]],
                right_chunks: Iterable[Dict[str, np.ndarray]]) -> HostSink:
        li, ri = iter(left_chunks), iter(right_chunks)
        # at most ONE chunk per source on the card at a time: the sources
        # are pulled, so the whole input is never resident anywhere at once
        exhausted = [False, False]
        try:
            with span("shuffle.spill.ooc_ingest"):
                while not all(exhausted):
                    for i, (it, sink) in enumerate(((li, self.lp), (ri, self.rp))):
                        if exhausted[i]:
                            continue
                        try:
                            chunk = next(it)
                        except StopIteration:
                            exhausted[i] = True
                            continue
                        self._ingest(sink, chunk)
            bump("shuffle.spill.ooc_joins")
            with span("shuffle.spill.ooc_join"):
                self._join_buckets()
        except BaseException as e:
            # a failed join releases its result arena too and leaves as a
            # typed error: these caller-owned arenas have no retry ladder
            # of their own, so a raw OSError is typed here
            self.sink.close()
            if isinstance(e, OSError) and not isinstance(e, CylonError):
                raise _spill.SpillIOError("out-of-core join spill I/O failed", e) from e
            raise
        finally:
            # closed on failure too: a leaked arena pins its tier-2 files
            # and the arena ledger's bytes
            self.lp.close()
            self.rp.close()
        return self.sink

    # -- observability -------------------------------------------------
    @property
    def max_device_cap(self) -> int:
        """The most device rows a shard held at any stage: the out-of-core
        guarantee is max_device_cap << total rows. The ingest term is the
        engine's own peak (the chunk, a round's buffers with their spare
        rows and the staged rounds), or the chunk alone at world 1."""
        engine_peak = max(self.lp.device_rows_peak, self.rp.device_rows_peak)
        return max(self._ingest_cap, engine_peak, self._join_cap)

    @property
    def join_phase_device_cap(self) -> int:
        """Peak rows a shard of the bucket-join stage alone: the about
        total / K that ``num_buckets`` controls."""
        return self._join_cap

    @property
    def cost_split(self) -> Dict[str, float]:
        """Wall seconds of each phase: spill_fetch the ingest's device ->
        host staging, stage_upload the bucket uploads, join the bucket
        joins, drain_fetch the result downloads, drain_thread the drain
        thread's busy time. Overlapped phases can sum past the end-to-end
        wall: each is its own clock."""
        return {
            "spill_fetch_s": round(self.lp.fetch_s + self.rp.fetch_s, 3),
            "stage_upload_s": round(self.stage_s, 3),
            "join_s": round(self.join_s, 3),
            "drain_fetch_s": round(self.sink.fetch_s, 3),
            "drain_thread_s": round(self.drain_s, 3),
        }
