"""Table of the PyTorch port (counterpart of cylon_tpu/table.py): the
relational operators over W shards, with the chunked shuffle between them.

A table is W shards of exact-length columns, shard s on the context's
``devices[s]``: no padding rows, no shard capacities. A process holds the
shards it owns (``ctx.local_shards``: every shard with the single-process
communicator, one under ``torch.distributed``) and None for the others,
and every shard's row count. A column's dtype, dictionary and whether it
has a validity mask are the same in every shard, on every rank. Rows
loaded from the host split into contiguous blocks (``engine.shard_caps``),
as in the JAX package; each rank stages only its own, and every host read
gives every rank the shards concatenated in order.
Every host value that decides control flow (a shard's row count, the
shuffle's send counts, the PK join's speculation) is gathered from every
rank through the communicator first, so every rank takes the same branch.
``join``, ``groupby``, ``sort``, the set operations and ``unique`` are
per-shard local ops (their per-shard logic in ``ops/``); their
``distributed_*`` forms shuffle first (``_shuffle_many``: a hash shuffle,
or the range shuffle of ``distributed_sort``) and are the local ops when
the world is one device, as there. Ops whose output is a subset of the
input rows (filter, set ops, unique) read every shard's row count in one
host sync.

A table may carry an order descriptor (:mod:`cylon_tpu_torch.ordering`):
``sort``, ``distributed_sort``, ``groupby``, the key-order join and the
fused join-sum set one; row subsets and renames carry it; anything that
reroutes or rewrites rows (a shuffle, an in-place change) drops it. ``sort``,
``groupby``, ``unique``, the set ops and ``join`` read it to skip sorts, as
the JAX package's do, and count each fast path (``ordering.*`` in
``utils/tracing``). ``lazy()`` starts a query plan (``plan/``).

A table may name one of its columns its index (``set_index``; None is the
RangeIndex, the global row number): ``loc`` looks rows up by its values,
``iloc`` by global row number, and ``concat(axis=1)`` aligns on it. Every
op that keeps the index column under its name keeps the index, as in the
JAX package; a groupby output has none.
"""
from __future__ import annotations

import operator as _op
import time as _time
from collections import OrderedDict
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import native
from . import ordering as _ord
from .column import Column, unify_dictionaries
from .context import CylonContext
from .dtypes import (
    DataType, Type, numpy_dtype, promote_concat_dtypes, promote_key_dtypes, torch_dtype,
)
from .engine import round_cap, shard_caps
from .fault.errors import CylonError, SpillIOError
from .ops import cuda_codec as _codec
from .ops import groupby as _g
from .ops import join as _j
from .ops import partition as _p
from .ops import pk_join as _pk
from .ops import quant as _quant
from .ops import setops as _s
from .ops import sketch as _sketch
from .ops import sort as _sort_mod
from .ops import stats as _st
from .ops.gather import (
    KeyCol, lane_plan, pack_gather, wire_bases, wire_has_quant, wire_lane_plan, wire_plan,
    wire_q8_cols, wire_row_bytes,
)
from .ops.hash import hash_dictionary_host
from .ops import radix as _radix
from .ops.sort import lexsort_rows_payload, orderable_key, prefix_run_lane
from .ops.partition import _saturating_int
from .ordering import Ordering
from .parallel import shuffle as _sh
from .parallel import spill as _spill
from .parallel import topo as _topo
from .obs import prof as _prof
from .obs import resource as _obsres
from .obs import store as _obsstore
from .obs import trace as _obstrace
from .utils.tracing import annotate_add, bump, gauge, span

Encoded = Tuple[np.ndarray, Optional[np.ndarray], Any, Optional[np.ndarray]]
Shard = "OrderedDict[str, Column]"


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md: {item})")


def _per_shard(ctx: CylonContext, fn) -> List[Any]:
    """``fn(s)`` for every shard s this process owns, None for the others."""
    out: List[Any] = [None] * ctx.world_size
    for s in ctx.local_shards:
        out[s] = fn(s)
    return out


def _all_local(ctx: CylonContext) -> bool:
    return len(ctx.local_shards) == ctx.world_size


class Row:
    """Read-only cursor over one table row (the JAX package's ``Row``, the
    reference's ``cylon::Row``), handed to :meth:`Table.select_rows`'s
    predicate. Values are decoded host values: strings are strings, nulls
    None or NaN."""

    __slots__ = ("_cols", "_i")

    def __init__(self, cols: Dict[str, np.ndarray], i: int):
        self._cols = cols
        self._i = i

    def __getitem__(self, name: str):
        return self._cols[name][self._i]

    def get(self, name: str):
        return self._cols[name][self._i]

    def keys(self):
        return self._cols.keys()

    @property
    def row_index(self) -> int:
        return self._i


def _dict_insert(dic: np.ndarray, value) -> Tuple[np.ndarray, int, bool]:
    """Insert ``value`` into a sorted dictionary, widening its string dtype
    first (``np.insert`` into a '<U1' array would truncate a longer value).
    Returns (dictionary, the value's code, whether it was inserted)."""
    pos = int(np.searchsorted(dic, value))
    if pos < len(dic) and dic[pos] == value:
        return dic, pos, False
    wide = np.result_type(dic.dtype, np.asarray([value]).dtype)
    return np.insert(dic.astype(wide), pos, value), pos, True


def _grow_dictionary(col: Column, value) -> Tuple[torch.Tensor, np.ndarray, int]:
    """A dictionary column's codes remapped onto its dictionary with
    ``value`` inserted: (codes, dictionary, the value's code)."""
    dic, pos, inserted = _dict_insert(col.dictionary, value)
    data = col.data
    if inserted and len(col.dictionary) and col.length:
        remap = torch.from_numpy(np.searchsorted(dic, col.dictionary).astype(np.int32))
        data = remap.to(data.device).index_select(0, data.clamp(0, len(col.dictionary) - 1))
    return data, dic, pos


def _cast(data: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``data`` converted to ``dtype`` as XLA converts (the JAX package's
    ``astype``): a float to an integer truncates toward zero, saturates at
    the integer's range and maps NaN to 0, where ``Tensor.to`` leaves those
    undefined."""
    if data.dtype.is_floating_point and not dtype.is_floating_point and dtype != torch.bool:
        return _saturating_int(data, dtype)
    return data.to(dtype)


def promote_encoded_shards(shards: List[Optional[Dict[str, Encoded]]]) -> None:
    """Where per-shard encodings disagree on a column's logical type,
    promote every shard in place to a common one (numbers -> float64; any
    string -> string, numbers formatted), as the JAX package does."""
    live = [s for s in shards if s is not None]
    if not live:
        return
    for name in list(live[0].keys()):
        types = {DataType.of(s[name][2]).type for s in live}
        if len(types) == 1:
            continue
        for s in live:
            data, valid, dtype, _d = s[name]
            t = DataType.of(dtype).type
            if Type.STRING in types:
                if t == Type.STRING:
                    continue
                if t == Type.BOOL:
                    vals = np.where(data.astype(bool), "true", "false")
                elif t == Type.DOUBLE:
                    vals = np.array([repr(float(x)) for x in data])
                else:
                    vals = np.array([str(int(x)) for x in data])
                dic, codes = np.unique(np.asarray(vals, str), return_inverse=True)
                s[name] = (codes.astype(np.int32), valid, DataType(Type.STRING), dic)
            elif t != Type.DOUBLE:
                s[name] = (data.astype(np.float64), valid, DataType(Type.DOUBLE), None)


def unify_encoded_shards(shards: List[Optional[Dict[str, Encoded]]]) -> None:
    """Promote disagreeing types, then remap every shard's dictionary codes
    onto the union dictionary in place (the JAX package's function). The
    per-shard dictionaries are sorted and unique, so each fold is the
    native two-pointer merge (``native.dict_union``) where it serves, and
    ``np.union1d`` where it does not."""
    promote_encoded_shards(shards)
    live = [s for s in shards if s is not None]
    if not live:
        return
    for name in list(live[0].keys()):
        if not DataType.of(live[0][name][2]).is_dictionary:
            continue
        union = live[0][name][3]
        for s in live[1:]:
            d = s[name][3]
            got = native.dict_union(np.asarray(union), np.asarray(d))
            union = got[0] if got is not None else np.union1d(union, d)
        for s in live:
            data, valid, dtype, d = s[name]
            remap = np.searchsorted(union, d).astype(np.int32)
            s[name] = (remap[data] if len(d) else data, valid, dtype, union)


def _encode_arrow_array(chunked) -> Encoded:
    """pyarrow ChunkedArray/Array -> (physical, valid, DataType, dictionary),
    typed (the JAX package's function; reference arrow/arrow_types.cpp):
    strings and dictionary arrays become codes on the sorted unique
    dictionary (code order == value order), integers with nulls stay
    integral, timestamps, dates and durations become int64 nanoseconds,
    validity bitmaps the mask."""
    import pyarrow as pa
    import pyarrow.compute as pc

    arr = chunked.combine_chunks() if hasattr(chunked, "combine_chunks") else chunked
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.chunk(0) if arr.num_chunks == 1 else pa.concat_arrays(arr.chunks)
    valid = ~np.asarray(arr.is_null()) if arr.null_count else None
    t = arr.type
    if pa.types.is_string(t) or pa.types.is_large_string(t):
        arr = arr.dictionary_encode()
        t = arr.type
    if pa.types.is_dictionary(t):
        raw_dict = np.asarray(arr.dictionary.to_pylist(), dtype=str)
        codes = np.asarray(pc.fill_null(arr.indices, 0)).astype(np.int32)
        sorted_dict, remap = np.unique(raw_dict, return_inverse=True)
        return remap.astype(np.int32)[codes], valid, DataType(Type.STRING), sorted_dict
    if pa.types.is_timestamp(t) or pa.types.is_date(t):
        data = np.asarray(arr.cast(pa.timestamp("ns")).fill_null(0)).astype(np.int64)
        return data, valid, DataType(Type.TIMESTAMP), None
    if pa.types.is_duration(t):
        data = np.asarray(arr.cast(pa.duration("ns")).fill_null(0)).astype(np.int64)
        return data, valid, DataType(Type.DURATION), None
    if pa.types.is_boolean(t):
        return np.asarray(arr.fill_null(False)), valid, DataType(Type.BOOL), None
    if pa.types.is_floating(t) or pa.types.is_integer(t):
        data = np.asarray(arr.fill_null(0.0 if pa.types.is_floating(t) else 0))
        return data, valid, DataType.from_numpy_dtype(data.dtype), None
    raise TypeError(f"unsupported arrow type {t}")


class Table:
    def __init__(
        self,
        ctx: CylonContext,
        shards: Sequence[Optional[Shard]],
        counts: Sequence[int],
        index_name: Optional[str] = None,
    ):
        if len(shards) != ctx.world_size or len(counts) != ctx.world_size:
            raise ValueError(f"a table of this context has {ctx.world_size} shards")
        if any(shards[s] is None for s in ctx.local_shards):
            raise ValueError("a table needs every shard this process owns")
        self.ctx = ctx
        self._shards: List[Optional[Shard]] = list(shards)
        self._counts = np.asarray(counts, np.int64)
        # the index column's name; None is the RangeIndex (global row number)
        self.index_name = index_name if index_name in self._ref else None
        self._built_index = None  # (kind, index name) -> the index build_index made
        # the order descriptor: None unless an op attaches one (ordering.py)
        self._ordering: Optional[Ordering] = None
        # column range stats (ops/stats.py): name -> ColStat bounds of the
        # orderable encoding. Empty unless a pass that touched the data
        # attached them (the shuffle's count phase, ensure_stats): a missed
        # propagation costs a lane-packing chance, never a result
        self._stats: Dict[str, _st.ColStat] = {}
        # the resource ledger: a no-op unless an ops surface is on; never
        # a sync (the byte counts are shape properties)
        _obsres.note_table(self)

    def _per_shard(self, fn) -> List[Any]:
        return _per_shard(self.ctx, fn)

    def _map_shards(self, fn) -> List[Optional[Shard]]:
        return [None if sh is None else fn(sh) for sh in self._shards]

    @property
    def _ref(self) -> Shard:
        """This process's first shard: the schema (names, types,
        dictionaries, validity masks), the same in every shard."""
        return self._shards[self.ctx.local_shards[0]]

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    @classmethod
    def from_encoded(cls, ctx: CylonContext, encoded: Dict[str, Encoded]) -> "Table":
        """Build a table from host columns already encoded as
        ``Column.encode_host`` returns them, by this package or the JAX
        package: (physical data, valid | None, logical type, sorted
        dictionary | None) per column. Shard s takes the s-th contiguous
        block of rows. Under several processes every rank passes the same
        global columns and stages only the blocks of its own shards."""
        n = len(next(iter(encoded.values()))[0]) if encoded else 0
        for phys, *_rest in encoded.values():
            if len(phys) != n:
                raise ValueError("all columns must have equal length")
        counts, _cap = shard_caps(n, ctx.world_size)
        offs = np.concatenate([[0], np.cumsum(counts)])

        def block(s):
            lo, hi = int(offs[s]), int(offs[s + 1])
            return OrderedDict(
                (name, (phys[lo:hi], None if valid is None else valid[lo:hi], dtype, dictionary))
                for name, (phys, valid, dtype, dictionary) in encoded.items()
            )

        return cls.from_encoded_shards(ctx, _per_shard(ctx, block), counts)

    @classmethod
    def from_encoded_shards(
        cls,
        ctx: CylonContext,
        shards: Sequence[Optional[Dict[str, Encoded]]],
        counts: Optional[Sequence[int]] = None,
    ) -> "Table":
        """Per-rank ingest (the JAX package's ``from_encoded_shards``):
        ``shards[s]`` maps column name -> (physical data, valid | None,
        logical type, sorted dictionary | None) for shard s's rows, and is
        None for a shard another process owns; each process stages only
        its own shards, so no rank holds the global table. ``counts`` (the
        global rows per shard) is required when other processes own
        shards. Dictionaries must already be unified across shards.

        The physical dtype comes from the declared logical type and never
        from local data, and a column has a validity mask on every shard
        when any shard gives one (one gather of the flags), so every rank
        builds the same lane plan: a rank that chose otherwise would
        exchange buffers of another width."""
        world = ctx.world_size
        if len(shards) != world:
            raise ValueError(f"need {world} shards, got {len(shards)}")
        local = ctx.local_shards
        if any(shards[s] is None for s in local):
            raise ValueError("every shard this process owns needs its data")
        if counts is None:
            if not _all_local(ctx):
                raise ValueError("counts (global, [world]) are required when other "
                                 "processes own shards")
            counts = [len(next(iter(sh.values()))[0]) if sh else 0 for sh in shards]
        counts = np.asarray(counts, np.int64)
        if counts.shape != (world,):
            raise ValueError(f"counts must hold {world} row counts")
        ref = shards[local[0]]
        names = list(ref)
        has_valid = ctx.comm.all_gather_counts(
            [[shards[s][n][1] is not None for n in names] for s in local]
        ).reshape(world, len(names)).any(axis=0)

        def stage(s):
            sh, device = shards[s], ctx.devices[s]
            if list(sh) != names:
                raise ValueError(f"shard {s} has columns {list(sh)}, not {names}")
            cols: Shard = OrderedDict()
            for i, name in enumerate(names):
                phys, valid, dtype, _dictionary = sh[name]
                dt = DataType.of(ref[name][2])
                if DataType.of(dtype) != dt:
                    raise ValueError(f"shard dtype mismatch for {name!r}: {dtype} vs {dt}")
                if len(phys) != counts[s]:
                    raise ValueError(f"shard {s}: {len(phys)} rows of {name!r}, counts say {counts[s]}")
                # a private host copy: the table never aliases the caller's array
                data = torch.from_numpy(np.array(phys, dtype=dt.physical_dtype)).to(device)
                v = None
                if has_valid[i]:
                    v = (torch.ones(len(phys), dtype=torch.bool) if valid is None
                         else torch.from_numpy(np.array(valid, dtype=bool))).to(device)
                cols[name] = Column(data, dt, v, ref[name][3])
            return cols

        return cls(ctx, _per_shard(ctx, stage), counts)

    @classmethod
    def from_shards(cls, ctx: CylonContext, shards: Sequence[Optional[Dict[str, Any]]]) -> "Table":
        """Per-shard construction (the JAX package's ``from_shards``): shard
        s's rows come from ``shards[s]``, a dict of host columns, as each MPI
        rank loads its own file. Each shard is encoded alone, then types are
        promoted and dictionaries unified across shards. Under several
        processes ``shards[s]`` is None for a shard another process owns:
        every rank gathers the others' column types, dictionaries and row
        counts, so that all of them unify alike."""
        world = ctx.world_size
        if len(shards) != world:
            raise ValueError(f"need {world} shards, got {len(shards)}")
        local = ctx.local_shards
        names = list(shards[local[0]].keys())
        enc: List[Optional[Dict[str, Encoded]]] = [None] * world
        for s in local:
            enc[s] = OrderedDict((n, Column.encode_host(np.asarray(shards[s][n]))) for n in names)
        return cls._from_local_encoded(ctx, enc)

    @classmethod
    def _from_local_encoded(cls, ctx: CylonContext,
                            enc: List[Optional[Dict[str, Encoded]]]) -> "Table":
        """A table from the encodings of this process's shards (None for
        the others'), e.g. the files of a per-rank read: every rank gathers
        the others' row counts, types and dictionaries as zero-row
        stand-ins, so all of them promote and unify alike, then stages its
        own shards."""
        local = ctx.local_shards
        if _all_local(ctx):
            unify_encoded_shards(enc)
            return cls.from_encoded_shards(ctx, enc)
        mine = {s: (len(next(iter(enc[s].values()))[0]) if enc[s] else 0,
                    [(n, e[2], e[3]) for n, e in enc[s].items()]) for s in local}
        counts = np.zeros(ctx.world_size, np.int64)
        for got in ctx.comm.gather_host(mine):
            for s, (rows, cols) in got.items():
                counts[s] = rows
                if enc[s] is None:
                    enc[s] = OrderedDict(
                        (n, (np.empty((0,), DataType.of(dt).physical_dtype), None, dt, dic))
                        for n, dt, dic in cols)
        unify_encoded_shards(enc)
        return cls.from_encoded_shards(ctx, [e if s in local else None for s, e in enumerate(enc)],
                                       counts)

    @classmethod
    def from_pydict(cls, ctx: CylonContext, data: Dict[str, Any]) -> "Table":
        arrays = {k: np.asarray(v) for k, v in data.items()}
        n = len(next(iter(arrays.values()))) if arrays else 0
        for v in arrays.values():
            if len(v) != n:
                raise ValueError("all columns must have equal length")
        encoded = OrderedDict(
            (name, Column.encode_host(values)) for name, values in arrays.items()
        )
        return cls.from_encoded(ctx, encoded)

    @classmethod
    def from_pandas(cls, ctx: CylonContext, df) -> "Table":
        return cls.from_pydict(ctx, {str(c): df[c].to_numpy() for c in df.columns})

    def _with_shards(self, shards: Sequence[Shard], counts=None) -> "Table":
        """This table's context and index over other shards (its row counts
        unless ``counts`` is given): the index survives while its column
        does."""
        return Table(self.ctx, shards, self._counts if counts is None else counts,
                     index_name=self.index_name)

    # ------------------------------------------------------------------
    # properties and host conversion
    # ------------------------------------------------------------------
    @property
    def world_size(self) -> int:
        return self.ctx.world_size

    @property
    def ordering(self) -> Optional[Ordering]:
        """The table's order descriptor or None (:mod:`cylon_tpu_torch.ordering`)."""
        return self._ordering

    def with_ordering(self, ordering: Optional[Ordering]) -> "Table":
        """A handle over the same shards declaring ``ordering``, checked
        against the schema; the caller vouches for the order."""
        t = self._with_shards(self._shards)
        t._ordering = _ord.validate(ordering, self.column_names)
        return t

    def _attach_ordering(self, ordering: Optional[Ordering]) -> "Table":
        """Set ``ordering`` if its keys are still columns, else leave none."""
        if ordering is not None and all(k in self._ref for k in ordering.keys):
            self._ordering = ordering
        return self

    @property
    def column_stats(self) -> Dict[str, "_st.ColStat"]:
        """The known column range stats (ops/stats.py): name -> [lo, hi]
        bounds of the column's orderable encoding. May be empty:
        :meth:`ensure_stats` measures on demand."""
        return dict(self._stats)

    def _attach_stats(self, stats: Optional[Dict[str, "_st.ColStat"]],
                      rename: Optional[Dict[str, str]] = None) -> "Table":
        """Carry range bounds onto this table for every column that still
        exists with the same encoding class (row subsets, permutations,
        renames: the bounds stay sound); a lapsed entry drops silently."""
        if not stats:
            return self
        out = {}
        for name, stat in stats.items():
            if stat is None:
                continue
            name = (rename or {}).get(name, name)
            col = self._ref.get(name)
            if col is None or _st.enc_class(col.data.dtype) != stat.cls:
                continue
            out[name] = stat
        if out:
            self._stats = {**self._stats, **out}
        return self

    def _fusion_specs(self, names: Sequence[str],
                      ascending: Optional[Sequence[bool]] = None) -> Optional[list]:
        """Per key ``(enc_class, field_bits, has_valid, ascending)`` for
        :func:`ops.sort.plan_lane_fusion`, or None where a key has no
        measurable stats (shared by sort and groupby)."""
        stats = self.ensure_stats(names)
        specs = []
        for i, kn in enumerate(names):
            stat = stats.get(kn)
            if stat is None:
                return None
            specs.append((stat.cls, _st.field_bits(stat), self._ref[kn].valid is not None,
                          bool(ascending[i]) if ascending is not None else True))
        return specs or None

    def ensure_stats(self, names: Sequence[str]) -> Dict[str, Optional["_st.ColStat"]]:
        """Range stats of ``names``, measured on demand and kept on this
        table (cleared by an in-place change, absent on fresh handles);
        None for a column with no packable encoding (float64). One pass per
        missing column a shard and one host fetch, gathered from every
        rank; a table that came out of a shuffle already holds them. {}
        when CYLON_TPU_TORCH_NO_LANE_PACK is set."""
        if not _st.enabled():
            return {}
        out: Dict[str, Optional[_st.ColStat]] = {}
        missing = []
        for n in names:
            cls = _st.enc_class(self._ref[n].data.dtype)
            got = self._stats.get(n)
            if cls is None:
                out[n] = None
            elif got is not None and got.cls == cls:
                out[n] = got
            else:
                missing.append((n, cls))
        if missing:
            words = self._gather_counts([
                torch.cat([_st.stat_words(self._flat_cols(s, [n])[0]) for n, _c in missing])
                for s in self.ctx.local_shards
            ]).reshape(self.world_size, len(missing), 4)
            bump("lane_pack.stats_kernel")
            for i, (n, cls) in enumerate(missing):
                self._stats[n] = out[n] = _st.fold_stat_words(words[:, i, :], cls)
        return out

    @property
    def column_names(self) -> List[str]:
        return list(self._ref.keys())

    @property
    def row_count(self) -> int:
        return int(self._counts.sum())

    @property
    def row_counts(self) -> np.ndarray:
        """Rows per shard."""
        return self._counts.copy()

    def __len__(self) -> int:
        return self.row_count

    def column(self, name: str) -> Column:
        """The whole column; at world > 1 its shards concatenated in order on
        this process's first device (a copy), on every rank."""
        ref = self._ref[name]
        if self.world_size == 1:
            return ref
        dev = self.ctx.device
        if _all_local(self.ctx):
            parts = [sh[name] for sh in self._shards]
            data = torch.cat([c.data.to(dev) for c in parts])
            valid = None if ref.valid is None else torch.cat([c.valid.to(dev) for c in parts])
        else:
            data, valid = (None if x is None else torch.from_numpy(x).to(dev)
                           for x in self._host_physical([name])[name])
        return Column(data, ref.dtype, valid, ref.dictionary)

    def _host_physical_shard(self, name: str, shard: int):
        """One shard's rows in physical encoding: (data, valid | None)."""
        if self._shards[shard] is None:
            raise ValueError(f"shard {shard} is owned by another process")
        col = self._shards[shard][name]
        data = col.data.cpu().numpy()
        return data, None if col.valid is None else col.valid.cpu().numpy()

    def _host_physical(self, names: Sequence[str]) -> Dict[str, Tuple[np.ndarray, Any]]:
        """The whole columns in physical encoding, (data, valid | None), the
        shards in order; under several processes one gather of every
        rank's shards, so every rank gets them (the JAX package's
        ``_fetch``)."""
        shards = {s: {n: self._host_physical_shard(n, s) for n in names}
                  for s in self.ctx.local_shards}
        if not _all_local(self.ctx):
            for part in self.ctx.comm.gather_host(shards):
                shards.update(part)
        out = {}
        for n in names:
            parts = [shards[s][n] for s in range(self.world_size)]
            valid = None if parts[0][1] is None else np.concatenate([v for _d, v in parts])
            out[n] = (np.concatenate([d for d, _v in parts]), valid)
        return out

    def to_pydict(self) -> Dict[str, np.ndarray]:
        host = self._host_physical(self.column_names)
        return {name: self._ref[name].decode_host(*host[name]) for name in self.column_names}

    def to_pandas(self):
        import pandas as pd

        return pd.DataFrame(self.to_pydict())

    def rename(self, mapping: Union[Dict[str, str], Sequence[str]]) -> "Table":
        if isinstance(mapping, dict):
            new_names = [mapping.get(n, n) for n in self.column_names]
        else:
            new_names = list(mapping)
        out = self._with_shards(
            self._map_shards(lambda sh: OrderedDict(zip(new_names, sh.values())))
        )
        ren = dict(zip(self.column_names, new_names))
        return out._attach_ordering(_ord.rename(self._ordering, ren))._attach_stats(
            self._stats, rename=ren
        )

    def project(self, columns: Sequence[Union[str, int]]) -> "Table":
        names = self._resolve_cols(columns)
        out = self._with_shards(self._map_shards(lambda sh: OrderedDict((n, sh[n]) for n in names)))
        # rows untouched: the order survives on the longest key prefix kept
        return out._attach_ordering(_ord.truncate_to(self._ordering, names))._attach_stats(
            self._stats
        )

    def drop(self, columns: Sequence[str]) -> "Table":
        gone = set(columns)
        out = self._with_shards(self._map_shards(
            lambda sh: OrderedDict((n, c) for n, c in sh.items() if n not in gone)
        ))
        return out._attach_ordering(
            _ord.truncate_to(self._ordering, out.column_names)
        )._attach_stats(self._stats)

    def add_prefix(self, prefix: str) -> "Table":
        """Prefix every column name; a set index follows its column."""
        out = self.rename([prefix + n for n in self.column_names])
        out.index_name = None if self.index_name is None else prefix + self.index_name
        return out

    def add_suffix(self, suffix: str) -> "Table":
        out = self.rename([n + suffix for n in self.column_names])
        out.index_name = None if self.index_name is None else self.index_name + suffix
        return out

    def _split_rows(self, x: torch.Tensor) -> List[Optional[torch.Tensor]]:
        """A tensor over the table's rows in order, as one slice per shard
        this process owns, on that shard's device."""
        offs = np.concatenate([[0], np.cumsum(self._counts)])
        return self._per_shard(lambda s: x[int(offs[s]):int(offs[s + 1])].to(self.ctx.devices[s]))

    def add_column(self, name: str, col: Union[Column, Sequence[Optional[Column]]]) -> "Table":
        """A new (or replaced) column: one :class:`Column` per shard (None
        for a shard another process owns), or one Column over all rows in
        table order, split into the shards."""
        local = self.ctx.local_shards
        if isinstance(col, Column):
            if col.length != self.row_count:
                raise ValueError(f"add_column: {col.length} rows for a table of {self.row_count}")
            data = self._split_rows(col.data)
            valid = None if col.valid is None else self._split_rows(col.valid)
            parts = self._per_shard(lambda s: Column(
                data[s], col.dtype, None if valid is None else valid[s], col.dictionary
            ))
        elif (
            isinstance(col, (list, tuple)) and len(col) == self.world_size
            and all(isinstance(col[s], Column) for s in local)
        ):
            if [col[s].length for s in local] != self._counts[local].tolist():
                raise ValueError("add_column: a shard's column length differs from its rows")
            parts = list(col)
        else:
            raise TypeError(
                "add_column expects a Column or one Column per shard; use from_pydict for host data"
            )

        def with_col(s):
            out, c, dev = OrderedDict(self._shards[s]), parts[s], self.ctx.devices[s]
            out[name] = Column(
                c.data.to(dev), c.dtype, None if c.valid is None else c.valid.to(dev), c.dictionary
            )
            return out

        return self._with_shards(self._per_shard(with_col))

    def _global_rowid_column(self) -> List[Column]:
        """Per shard, an int32 column of each row's global index in table
        order. Carried through a shuffle it lets unique keep='first'/'last'
        pick by the original order, which the rounds do not keep."""
        if self.row_count > 2**31 - 1:
            raise ValueError(
                f"global row ids exceed int32 range ({self.row_count} rows); order-sensitive "
                "distributed ops (unique keep='first'/'last') are limited to 2^31-1 global rows"
            )
        offs = np.concatenate([[0], np.cumsum(self._counts)])
        i32 = DataType(Type.INT32)
        return self._per_shard(lambda s: Column(torch.arange(
            int(offs[s]), int(offs[s + 1]), dtype=torch.int32, device=self.ctx.devices[s]
        ), i32))

    # ------------------------------------------------------------------
    # row selection
    # ------------------------------------------------------------------
    def _shard_masks(self, mask) -> List[Optional[torch.Tensor]]:
        """One bool row mask per shard this process owns from a one-column
        Table, a Column over all rows, one bool tensor (or Column) per shard
        (None for a shard another process owns), or a host mask over all
        rows. A null entry counts as False."""

        def as_bool(m):
            if isinstance(m, Column):
                return m.data.to(torch.bool) if m.valid is None else m.data.to(torch.bool) & m.valid
            return m.to(torch.bool)

        local = self.ctx.local_shards
        if isinstance(mask, Table):
            if not (mask._counts == self._counts).all():
                raise ValueError("filter: the mask table's shards differ from the table's")
            mask = mask._map_shards(lambda sh: next(iter(sh.values())))
        if isinstance(mask, (list, tuple)) and len(mask) == self.world_size and all(
            isinstance(mask[s], (torch.Tensor, Column)) for s in local
        ):
            if [mask[s].shape[0] if isinstance(mask[s], torch.Tensor) else mask[s].length
                    for s in local] != self._counts[local].tolist():
                raise ValueError("filter: a per-shard mask must match every shard's rows")
            return self._per_shard(lambda s: as_bool(mask[s]).to(self.ctx.devices[s]))
        if isinstance(mask, Column):
            mask = as_bool(mask)
        elif not isinstance(mask, torch.Tensor):
            mask = torch.from_numpy(np.asarray(mask, dtype=bool).reshape(-1))
        if mask.shape[0] != self.row_count:
            raise ValueError(f"filter: a mask of {mask.shape[0]} rows for {self.row_count}")
        return self._split_rows(mask.to(torch.bool))

    def _shard_like(self, s: int, names: Sequence[str], out: Sequence[KeyCol]) -> Shard:
        """Shard s of an output: the gathered (data, valid) pairs under
        ``names``, with the types and dictionaries of this table's columns."""
        return OrderedDict(
            (n, Column(d, self._shards[s][n].dtype, v, self._shards[s][n].dictionary))
            for n, (d, v) in zip(names, out)
        )

    def _emit(self, parts, out_names: Optional[Sequence[str]] = None) -> "Table":
        """Rows picked per shard: ``parts[s]`` is (columns, idx with -1
        padding, count as a device scalar) for each shard this process
        owns. Reads the counts in one host sync, gathers every rank's, and
        gathers each shard's rows into the columns ``out_names`` (default:
        all) of this table."""
        out_names = self.column_names if out_names is None else out_names
        counts = self._gather_counts([parts[s][2] for s in self.ctx.local_shards])
        # every column gets a validity mask, all-true where it had none, as
        # the JAX package's pack_gather gives it: a later shuffle, sort or
        # groupby then plans the same lanes
        return self._with_shards(self._per_shard(lambda s: self._shard_like(
            s, out_names, pack_gather(parts[s][0], parts[s][1][: int(counts[s])])
        )), counts)

    def _gather_counts(self, local: Sequence[Any]) -> np.ndarray:
        """Every shard's row count, from this process's (host ints or
        device scalars, read in one host sync)."""
        if local and isinstance(local[0], torch.Tensor):
            dev = self.ctx.device
            local = torch.stack([t.to(dev) for t in local]).cpu().numpy()
        return self.ctx.comm.all_gather_counts(local)

    def filter(self, mask) -> "Table":
        """Keep the rows where ``mask`` is True, in order (see
        :meth:`_shard_masks` for the mask's forms)."""
        masks = self._shard_masks(mask)
        return self._emit(self._per_shard(
            lambda s: (self._flat_cols(s), *_s.compact_mask(masks[s], masks[s].shape[0]))
        ))._attach_ordering(self._ordering)._attach_stats(self._stats)  # a row subset in order

    def select(self, predicate) -> "Table":
        """Keep the rows where ``predicate`` holds; it maps each shard's dict
        of column tensors to that shard's bool mask."""
        return self.filter(self._map_shards(
            lambda sh: predicate({n: c.data for n, c in sh.items()})
        ))

    def take(self, indices) -> "Table":
        """Rows by global (table-order) index, negative from the end; the
        output's rows split evenly over the shards, as a loaded table's.
        Under several processes the rows a shard gives to another
        process's output shard go through one host gather."""
        idx = np.asarray(indices, np.int64).reshape(-1)
        n_total = self.row_count
        idx = np.where(idx < 0, idx + n_total, idx)
        if len(idx) and (idx.min() < 0 or idx.max() >= n_total):
            raise IndexError("take index out of range")
        offs = np.concatenate([[0], np.cumsum(self._counts)])
        src = np.searchsorted(offs[1:], idx, side="right")
        local = idx - offs[src]
        counts, _cap = shard_caps(len(idx), self.world_size)
        o = np.concatenate([[0], np.cumsum(counts)])
        dest = np.repeat(np.arange(self.world_size), counts)
        devices = self.ctx.devices

        def gather_from(s, sel):
            return pack_gather(self._flat_cols(s), torch.from_numpy(local[sel]).to(devices[s]),
                               all_valid=True)

        shipped = {}  # (source shard, output shard) -> host (data, valid) per column
        if not _all_local(self.ctx):
            mine = {}
            for s in self.ctx.local_shards:
                for d in np.unique(dest[src == s]):
                    if self._shards[d] is None:
                        mine[(s, int(d))] = [
                            (x.cpu().numpy(), None if v is None else v.cpu().numpy())
                            for x, v in gather_from(s, (src == s) & (dest == d))
                        ]
            for part in self.ctx.comm.gather_host(mine):
                shipped.update(part)

        def out_shard(d):
            dev = devices[d]
            sd = src[o[d]:o[d + 1]]
            order = np.argsort(sd, kind="stable")
            pieces = []
            for s in np.unique(sd):
                if self._shards[s] is not None:
                    sel = np.zeros(len(idx), bool)
                    sel[o[d]:o[d + 1]] = sd == s
                    pieces.append(gather_from(s, sel))
                else:
                    pieces.append([(torch.from_numpy(x), None if v is None else torch.from_numpy(v))
                                   for x, v in shipped[(int(s), d)]])
            inv = torch.from_numpy(np.argsort(order, kind="stable")).to(dev)
            cols: Shard = OrderedDict()
            for ci, (name, c) in enumerate(self._ref.items()):
                if pieces:
                    data = torch.cat([p[ci][0].to(dev) for p in pieces])[inv]
                    valid = None if c.valid is None else torch.cat(
                        [p[ci][1].to(dev) for p in pieces])[inv]
                else:
                    data = c.data.new_empty(0).to(dev)
                    valid = None if c.valid is None else c.valid.new_empty(0).to(dev)
                cols[name] = Column(data, c.dtype, valid, c.dictionary)
            return cols

        return self._with_shards(self._per_shard(out_shard), counts)

    def hash_partition(
        self, hash_columns: Sequence[Union[str, int]], num_partitions: int
    ) -> Dict[int, "Table"]:
        """Local hash partition of every shard into ``num_partitions``
        tables by the murmur3 row hash, through :meth:`filter`."""
        khash = self._key_hash_cols(self._resolve_cols(hash_columns))
        pids = self._per_shard(lambda s: _p.hash_partition_ids(khash[s], None, num_partitions))
        return {p: self.filter(self._per_shard(lambda s: pids[s] == p))
                for p in range(num_partitions)}

    @staticmethod
    def concat(
        tables: Sequence["Table"],
        axis: int = 0,
        join: str = "inner",
        algorithm: str = "sort",
        distributed: bool = False,
    ) -> "Table":
        """axis=0: row-stack same-schema tables shard by shard (the
        reference's Merge). axis=1: join each table onto the result so far
        on their index columns (``join``: inner, left, right, outer), or on
        the global row number where a table has the RangeIndex; an outer or
        right join coalesces the index. ``distributed`` joins through
        :meth:`distributed_join` (a shuffle) at world > 1, else shard by
        shard. The inputs are never changed."""
        tables = list(tables)
        if not tables:
            raise ValueError("need at least one table")
        if any(not isinstance(t, Table) for t in tables):
            raise ValueError("concat expects Tables")
        if axis == 0:
            return _concat_tables(tables)
        if axis != 1:
            raise ValueError(f"invalid axis {axis}, must be 0 or 1")
        tmp_key, tmp_rkey = "__concat_index__", "__concat_rkey__"
        for t in tables:
            if tmp_key in t.column_names or tmp_rkey in t.column_names:
                raise ValueError(f"column names {tmp_key}/{tmp_rkey} are reserved by concat")

        def keyed(t: "Table") -> Tuple["Table", str, bool]:
            if t.index_name is not None:
                return t, t.index_name, False
            return t.add_column(tmp_key, t._global_rowid_column()), tmp_key, True

        res, res_key, res_tmp = keyed(tables[0])
        for i, other in enumerate(tables[1:], start=1):
            o, o_key, _ = keyed(other)
            # the right key rides under a reserved name, so the drop below
            # never takes a user column
            o = o.rename({o_key: tmp_rkey})
            join_fn = res.distributed_join if distributed and res.world_size > 1 else res.join
            # a suffix per table: three tables sharing a name must not
            # collide on the second join
            res = join_fn(
                o, how=join, left_on=[res_key], right_on=[tmp_rkey],
                suffixes=("", "_y" if i == 1 else f"_y{i}"),
                algorithm=algorithm if algorithm in ("sort", "hash") else "sort",
            )
            if join in ("right", "outer", "fullouter", "full_outer"):
                # right-only rows hold their index value in the right key
                prefer_r = join == "right"

                def coalesce(sh):
                    lcol, rcol = sh[res_key], sh[tmp_rkey]
                    a, b = (rcol, lcol) if prefer_r else (lcol, rcol)
                    dt = promote_concat_dtypes(a.data.dtype, b.data.dtype)
                    data = torch.where(a.valid_mask(), a.data.to(dt), b.data.to(dt))
                    valid = None if a.valid is None or b.valid is None else a.valid | b.valid
                    out_t = lcol.dtype if lcol.dtype.is_dictionary else DataType.from_numpy_dtype(
                        numpy_dtype(dt))
                    out = OrderedDict(sh)
                    out[res_key] = Column(data, out_t, valid, lcol.dictionary)
                    return out

                res = res._with_shards(res._map_shards(coalesce))
            res = res.drop([tmp_rkey])
        if res_tmp:
            return res.drop([res_key]) if res_key in res.column_names else res
        return res.set_index(res_key) if res_key in res.column_names else res

    @staticmethod
    def merge(tables: Sequence["Table"]) -> "Table":
        """Row-stack same-schema tables: :meth:`concat` with axis=0."""
        return Table.concat(tables, axis=0)

    # ------------------------------------------------------------------
    # shuffle (the distributed backbone)
    # ------------------------------------------------------------------
    def shuffle(
        self,
        hash_columns: Sequence[Union[str, int]],
        byte_budget: Optional[int] = None,
    ) -> "Table":
        """Hash-partition on the given columns to world_size partitions with
        the chunked all-to-all. ``byte_budget`` caps the per-round exchange
        buffer (default: the context's ``shuffle_byte_budget``)."""
        names = self._resolve_cols(hash_columns)
        if self.world_size == 1:
            return self
        return self._shuffle_impl(names, byte_budget=byte_budget)

    def _key_hash_cols(self, key_names: Sequence[str]) -> List[List[KeyCol]]:
        """Per shard, the key columns for HASH partitioning, dictionary
        columns replaced by the value hash of their strings (int64 holding
        the uint32, which hashes as the JAX package's uint32 lane): equal
        strings route alike whichever table encoded them."""
        out: List[Optional[List[KeyCol]]] = self._per_shard(lambda s: [])
        for n in key_names:
            c0 = self._ref[n]
            hh = None
            if c0.dtype.is_dictionary:
                hh = torch.from_numpy(hash_dictionary_host(c0.dictionary).astype(np.int64))
            for s in self.ctx.local_shards:
                c = self._shards[s][n]
                if hh is None:
                    out[s].append((c.data, c.valid))
                elif len(hh) == 0:
                    out[s].append((torch.zeros_like(c.data, dtype=torch.int64), c.valid))
                else:
                    h = hh.to(c.data.device)
                    out[s].append((h[c.data.clamp(0, len(hh) - 1).to(torch.int64)], c.valid))
        return out

    def _shuffle_impl(self, key_names: Sequence[str], byte_budget: Optional[int] = None, *,
                      kind: str = "hash", task_map: Optional[np.ndarray] = None) -> "Table":
        """One table through :func:`_shuffle_many`: a hash shuffle on
        ``key_names``, or (``kind="task"``) the task shuffle, which sends a
        row to worker ``task_map[t]`` of the task id t in its one key column."""
        return _shuffle_many([_ShuffleSpec(self, tuple(key_names), byte_budget, kind=kind,
                                           task_map=task_map)])[0]

    # ------------------------------------------------------------------
    # join
    # ------------------------------------------------------------------
    def _resolve_cols(self, spec) -> List[str]:
        if isinstance(spec, (str, int)):
            spec = [spec]
        names = [self.column_names[s] if isinstance(s, int) else s for s in spec]
        missing = [n for n in names if n not in self._ref]
        if missing:
            raise KeyError(f"unknown columns {missing}")
        return names

    def _resolve_join_keys(self, other, on, left_on, right_on):
        if on is not None:
            names = self._resolve_cols(on)
            return names, names
        if left_on is None or right_on is None:
            raise ValueError("join requires `on` or both `left_on`/`right_on`")
        return self._resolve_cols(left_on), other._resolve_cols(right_on)

    def _flat_cols(self, shard: int, names: Optional[Sequence[str]] = None) -> List[KeyCol]:
        cols = self._shards[shard]
        names = self.column_names if names is None else names
        return [(cols[n].data, cols[n].valid) for n in names]

    def join(
        self,
        other: "Table",
        on: Optional[Union[str, Sequence[str]]] = None,
        how: str = "inner",
        left_on: Optional[Sequence[str]] = None,
        right_on: Optional[Sequence[str]] = None,
        suffixes: Tuple[str, str] = ("_x", "_y"),
        algorithm: str = "sort",
        config: Optional[Any] = None,
        emit_order: str = "left",
    ) -> "Table":
        """Per-shard (local) equi-join, all four types; output rows in
        left-row order (pandas merge order), left columns then right
        columns, suffixes on name collisions.

        ``emit_order='key'`` (INNER / LEFT, not with 'pallas_pk') emits the
        rows grouped by the join key straight out of the probe's merged
        sort and stamps that order on the output, so a groupby or sort on
        the key that follows skips its sort. The left-order emit keeps the
        left input's order descriptor. A right table whose descriptor
        proves it sorted by the join key skips the right sort
        (``ordering.join_presorted_probe``).

        ``algorithm``: 'sort' and 'hash' both run the sort join;
        'pallas_pk' runs the bucketed PK-FK probe (kernel B5) for an inner
        join on one null-free integer key of <= 32 bits, speculating that
        the right keys are unique: a duplicate or a bucket overflow on any
        shard reruns the exact sort join. ``config`` takes a
        :class:`~cylon_tpu_torch.join_config.JoinConfig` and must then be
        the only join argument."""
        if config is not None:
            if (
                on is not None or left_on is not None or right_on is not None
                or how != "inner" or suffixes != ("_x", "_y")
                or algorithm != "sort" or emit_order != "left"
            ):
                raise ValueError(
                    "pass either config= or explicit join arguments, not both"
                )
            return self.join(other, **config.kwargs())
        _check_join_args(algorithm, emit_order)
        if other.ctx.devices != self.ctx.devices:
            raise ValueError("join of tables on different devices")
        l_names, r_names = self._resolve_join_keys(other, on, left_on, right_on)
        if emit_order == "key" and how not in ("inner", "left"):
            raise ValueError(
                "emit_order='key' needs how='inner'/'left' (the unmatched-"
                "right append of right/outer joins has no key-ordered emit)"
            )
        if algorithm == "pallas_pk":
            return self._pallas_pk_join(other, l_names, r_names, how, suffixes)
        howi = _j.join_type_id(how)
        # read before the dictionary remap, which keeps code order
        r_presorted = _ord.covers_prefix(
            other._ordering, r_names,
            need_canonical=not all(other._ref[n].valid is None for n in r_names),
        )
        emit_key = emit_order == "key"
        left, right = _unify_dict_pair(self, other, l_names, r_names)
        # factorize-lane fusion (ops/stats.py): the multi-key / masked
        # probe's joint factorize bit-packs both sides' canonical key lanes,
        # sized by the pair's merged range stats
        join_fuse = _plan_join_fusion(left, l_names, right, r_names)
        if join_fuse is not None:
            bump("lane_pack.join_fused", rows=join_fuse.n_plain - join_fuse.n_words)
        out_names = _suffix_names(left.column_names, right.column_names, suffixes)
        l_rename = dict(zip(left.column_names, out_names[: len(left.column_names)]))
        if emit_key:
            ordering = Ordering(
                keys=tuple(l_rename[n] for n in l_names), ascending=(True,) * len(l_names),
                nulls_last=True, scope="shard", canonical=True,
                lexsort_exact=all(left._ref[n].valid is None for n in l_names),
            )
        elif howi in (_j.INNER, _j.LEFT):
            # rows repeat in left order: the left descriptor survives
            ordering = _ord.rename(self._ordering, l_rename)
        else:
            ordering = None
        if r_presorted:
            bump("ordering.join_presorted_probe")
        with span("join.speculative", rows=int(self._counts.sum())):
            probes = self._per_shard(lambda s: _j.spec_probe(
                left._flat_cols(s, l_names), right._flat_cols(s, r_names), right._flat_cols(s),
                howi, r_presorted=r_presorted, emit_key_order=emit_key, key_fuse=join_fuse,
            ))
            bump("host_sync")  # the join's one count read
            counts = self._gather_counts([probes[s]["total"] for s in self.ctx.local_shards])
            # every rank checks every shard's count, so all raise alike
            _j.count_overflow_check(int(counts.max()))
            if emit_key:
                bump("ordering.join_key_order_emit")
            return self._with_shards(self._per_shard(lambda s: _out_shard(
                out_names, left, right, s,
                _j.spec_emit(probes[s], left._flat_cols(s), right._flat_cols(s), howi,
                             int(counts[s])),
            )), counts)._attach_ordering(ordering)

    def _pallas_pk_join(
        self, other: "Table", l_names, r_names, how: str, suffixes: Tuple[str, str]
    ) -> "Table":
        """``algorithm='pallas_pk'``: per shard, the bucketed PK-FK probe
        (ops/pk_join.py, kernel B5), then one packed gather a side. One host
        sync reads this process's (total, bad) per shard and one gather
        brings every rank's: a miss on any shard reruns the exact sort join
        on the original tables, left-order output, on every rank."""
        if how != "inner":
            raise ValueError("algorithm='pallas_pk' supports how='inner' only")
        left, right = _unify_dict_pair(self, other, l_names, r_names)
        left, right = _promote_key_pair(left, right, l_names, r_names)
        lk0, rk0 = left._ref[l_names[0]], right._ref[r_names[0]]
        if len(l_names) != 1 or lk0.valid is not None or rk0.valid is not None:
            raise ValueError(
                "algorithm='pallas_pk' needs a single null-free key column"
            )
        kd = lk0.data.dtype
        if kd not in _pk.KEY_DTYPES:
            raise ValueError(
                "algorithm='pallas_pk' needs an integer (or dictionary-"
                f"encoded) key <= 32 bits, got {numpy_dtype(kd)}"
            )
        # the bucket count from the capacities the JAX package pads every
        # shard to, so that the buckets, the overflow decision and the
        # output order are its own
        caps = (round_cap(left._counts.max()), round_cap(right._counts.max()))
        # at a power-of-two W the shuffle routes a row to shard h & (W - 1)
        # of the same hash, so within a shard those low bits are constant:
        # the bucket id takes the bits above them, or a shard would fill 1/W
        # of its buckets and overflow them (the JAX package takes the low
        # bits at every world size, so after its shuffle a shard uses 1/W of
        # its buckets). At other W the shuffle routes by h % W, no low bit is
        # constant, and the shift only picks other bits of the same hash.
        shift = (self.world_size - 1).bit_length()
        parts = self._per_shard(lambda s: _pk.pk_inner_join(
            left._shards[s][l_names[0]].data, right._shards[s][r_names[0]].data,
            caps=caps, shift=shift,
        ))
        bump("host_sync")
        stats = self._gather_counts([
            torch.stack([parts[s][2], parts[s][3].to(parts[s][2].dtype)])
            for s in self.ctx.local_shards
        ])  # [W, (total, bad)] on every rank
        if int(stats[:, 1].sum()) != 0:
            _pk.COUNTS["fallback"] += 1
            return self.join(
                other, left_on=l_names, right_on=r_names, how=how, suffixes=suffixes
            )
        out_names = _suffix_names(left.column_names, right.column_names, suffixes)

        def emit(s):
            l_idx, r_idx, _total, _bad = parts[s]
            n = int(stats[s, 0])
            # all-true masks where a column had none, as the JAX package's
            out = pack_gather(left._flat_cols(s), l_idx[:n]) + pack_gather(
                right._flat_cols(s), r_idx[:n]
            )
            return _out_shard(out_names, left, right, s, out)

        return self._with_shards(self._per_shard(emit), stats[:, 0])

    def distributed_join(
        self,
        other: "Table",
        on: Optional[Union[str, Sequence[str]]] = None,
        how: str = "inner",
        *,
        mode: str = "eager",
        **kwargs,
    ) -> "Table":
        """The flagship op: hash-shuffle both tables on the join keys, then
        the local join per shard. One device: the local join.

        ``mode='fused'`` runs the shuffle -> join chain as one step at
        static capacities with one host read per attempt
        (:meth:`_fused_join`, parallel/pipeline.py); its join is built in,
        so it takes ``algorithm`` 'sort' or 'hash' and the left-order
        emit only."""
        if on is not None:
            kwargs["on"] = on
        kwargs.setdefault("how", how)
        if mode == "fused":
            if kwargs.get("algorithm", "sort") not in ("sort", "hash"):
                raise ValueError(
                    "mode='fused' builds the sort join into the fused step; "
                    f"algorithm={kwargs['algorithm']!r} needs mode='eager'"
                )
            if kwargs.get("emit_order", "left") != "left":
                raise ValueError(
                    "mode='fused' builds the left-order emit into the fused step; "
                    "emit_order='key' needs mode='eager'"
                )
            return self._fused_join(other, **kwargs)
        if mode != "eager":
            raise ValueError(f"unknown join mode {mode!r}")
        if self.world_size == 1:
            return self.join(other, **kwargs)
        _check_join_args(kwargs.get("algorithm", "sort"), kwargs.get("emit_order", "left"))
        _j.join_type_id(kwargs["how"])
        l_names, r_names = self._resolve_join_keys(
            other, kwargs.get("on"), kwargs.get("left_on"), kwargs.get("right_on")
        )
        left, right = _unify_dict_pair(self, other, l_names, r_names)
        # promote key dtype pairs BEFORE hashing: the hash words depend on
        # the physical dtype, so an int32 5 and an int64 5 would otherwise
        # land on different shards
        left, right = _promote_key_pair(left, right, l_names, r_names)
        # the semi-join sketch filter prunes provably partnerless rows before
        # the exchange, by join type (inner: both sides; left/right: the
        # other side only; outer: off)
        ls, rs = _shuffle_pair(left, l_names, right, r_names,
                               semi=_sketch.join_filter_sides(kwargs["how"]))
        return ls.join(rs, **kwargs)

    def _fused_join(
        self,
        other: "Table",
        on=None,
        how: str = "inner",
        left_on=None,
        right_on=None,
        suffixes: Tuple[str, str] = ("_x", "_y"),
        capacity_factor: float = 2.0,
        max_retries: int = 3,
        respill: int = 1,
        num_slices: int = 1,
        **_ignored,
    ) -> "Table":
        """shuffle -> join as one fused step (parallel/pipeline.py), with
        ONE host read per attempt: every shard's (output count, overflow).

        ``respill``: extra exchange rounds per shuffle, so a bucket up to
        ``(1 + respill) * bucket_cap`` rows drains with no host read; past
        it the overflow doubles the capacities and retries.
        ``num_slices`` = K > 1 runs K hash-slice rounds, each join over
        about n/K rows (forced to 1 at world 1).

        Capacities are the JAX package's, from the port's ``round_cap(max
        shard rows)`` where it has ``shard_cap``: ``bucket_cap =
        round_cap(capacity_factor * cap / (W * K))`` clamped by the byte
        budget, ``join_cap = round_cap(2 * (1 + respill) * W *
        bucket_cap)`` (at world 1 the sum of both sides' caps). The
        outputs are trimmed to exact length after the read."""
        from .parallel import pipeline as _pl

        if other.ctx.devices != self.ctx.devices:
            raise ValueError("join of tables on different devices")
        ctx = self.ctx
        world = self.world_size
        l_names, r_names = self._resolve_join_keys(other, on, left_on, right_on)
        howi = _j.join_type_id(how)
        left, right = _unify_dict_pair(self, other, l_names, r_names)
        left, right = _promote_key_pair(left, right, l_names, r_names)
        lk_idx = tuple(left.column_names.index(n) for n in l_names)
        rk_idx = tuple(right.column_names.index(n) for n in r_names)
        cap_l, cap_r = round_cap(int(left._counts.max())), round_cap(int(right._counts.max()))
        respill = int(respill)
        if respill < 0:
            raise ValueError("respill must be >= 0")
        num_slices = int(num_slices)
        if num_slices < 1:
            raise ValueError("num_slices must be >= 1")
        local = ctx.local_shards
        lref, rref = left._flat_cols(local[0]), right._flat_cols(local[0])
        if world <= 1:
            num_slices = 1  # no shuffle for the slice filter to ride
        bucket_cap = round_cap(int(capacity_factor * max(cap_l, cap_r) / max(world * num_slices, 1)))
        if world > 1:
            # the eager engine's byte budget caps the per-round buffer; an
            # undersized first attempt is recovered by the retry
            row_bytes = max(_sh.exchange_row_bytes(lref), _sh.exchange_row_bytes(rref))
            from .plan import feedback as _feedback

            # the re-coster's tuned budget overrides the context's here as
            # in _plan_state
            bucket_cap = min(bucket_cap, _sh.budget_bucket_cap(
                row_bytes, world, _feedback.tuned_shuffle_budget() or ctx.shuffle_byte_budget,
                bucket_cap))
            join_cap = round_cap(2 * (1 + respill) * world * bucket_cap)
        else:
            join_cap = round_cap(cap_l + cap_r)
        # the lossy wire tier rides both fused shuffles; keys never quantize
        quant_l = _quant.quant_spec([d.dtype for d, _v in lref], lk_idx, ctx.quant_tol)
        quant_r = _quant.quant_spec([d.dtype for d, _v in rref], rk_idx, ctx.quant_tol)
        l_in = [left._flat_cols(s) for s in local]
        r_in = [right._flat_cols(s) for s in local]
        dev0 = ctx.device
        # the effective 2-D topology routes every fused exchange as the
        # structured two-hop (parallel/topo.py), read once a call
        topo = _topo.effective(ctx) if world > 1 else None
        for _attempt in range(max_retries):
            if world > 1:
                rb_l, rb_r = _sh.exchange_row_bytes(lref), _sh.exchange_row_bytes(rref)
                bump("shuffle.exchanged_bytes", rows=_pl.fused_exchange_bytes(
                    world, bucket_cap, respill, rb_l, rb_r, num_slices))
                for rb_side in (rb_l, rb_r):
                    fi, fo = _pl.fused_axis_bytes(world, bucket_cap, respill, rb_side, topo,
                                                  num_slices)
                    if fi:
                        bump("shuffle.coll_bytes.intra", rows=fi)
                    bump("shuffle.coll_bytes.inter", rows=fo)
            step = _pl.make_distributed_join_step(
                ctx, lk_idx, rk_idx, howi, bucket_cap, join_cap, respill, num_slices,
                quant_l=quant_l, quant_r=quant_r, topo=topo,
            )
            t0_prof = _time.perf_counter()
            prof_on = _prof.profiling_active()
            ev0 = _obstrace.device_event() if prof_on else None
            with span("join.fused", rows=int(left._counts.sum() + right._counts.sum())):
                out, nout, ov = step(l_in, r_in)
                mine = torch.stack([
                    torch.cat([n.reshape(1).to(torch.int64), o.to(torch.int64)]).to(dev0)
                    for n, o in zip(nout, ov)
                ])
                ev1 = _obstrace.device_event() if ev0 is not None else None  # the read passes it
                bump("host_sync")
                stats = ctx.comm.all_gather_counts(mine.cpu().numpy())  # THE host read
                # the fused step's stage clocks: the read above is this
                # attempt's end, every unit shape-derived (host math only)
                if prof_on:
                    _prof.record_stages(
                        "fused",
                        _prof.fused_units(world, bucket_cap, num_slices * (1 + respill),
                                          int(left._counts.sum()), int(right._counts.sum()),
                                          join_cap),
                        world, t0_prof, _time.perf_counter(), (ev0, ev1),
                    )
            nout_h = stats[:, 0]
            ov_shuffle, ov_join = int(stats[:, 1].sum()), int(stats[:, 2].max())
            if ov_shuffle == 0 and ov_join == 0:
                out_names = _suffix_names(left.column_names, right.column_names, suffixes)
                by_shard = dict(zip(local, out))

                def emit(s):
                    n = int(nout_h[s])
                    cols = [(d[:n], None if v is None else v[:n]) for d, v in by_shard[s]]
                    return _out_shard(out_names, left, right, s, cols)

                return self._with_shards(self._per_shard(emit), nout_h)
            if ov_join >= 2**31 - 1:
                # the step's saturated int32-wrap sentinel: resizing would
                # overflow the int32 row ids downstream
                raise RuntimeError(
                    "fused join per-shard output count exceeds int32 (extreme skew); "
                    "use mode='eager'"
                )
            if ov_shuffle > 0:
                bucket_cap *= 2
                join_cap = max(join_cap, round_cap(2 * (1 + respill) * world * bucket_cap))
            if ov_join > 0:
                # the join lane reports the exact shortfall: one step converges
                join_cap = round_cap(join_cap + ov_join)
        raise RuntimeError(
            f"fused join overflowed after {max_retries} capacity retries (extreme skew); "
            "use mode='eager'"
        )

    # ------------------------------------------------------------------
    # groupby
    # ------------------------------------------------------------------
    def groupby(
        self,
        by: Union[str, int, Sequence[Union[str, int]]],
        agg: Dict[str, Union[str, int, Sequence[Union[str, int]]]],
        ddof: int = 1,
        quantile: float = 0.5,
        _sorted: bool = False,
    ) -> "Table":
        """Per-shard groupby-aggregate: the key columns in sorted key order,
        then one column ``<col>_<op>`` per (column, op), op in
        sum/count/min/max/mean/var/std/nunique/quantile/median (``ddof``
        for var and std, ``quantile`` for quantile and median).
        ``_sorted`` (internal, :meth:`pipeline_groupby`): the rows are
        already sorted by the keys, so the groups are their runs. Where the
        order descriptor proves the rows canonically ordered by the keys,
        the groups are their runs too (``ordering.groupby_run_detect``).
        The groups come out in canonical key order, which the output's
        descriptor says (not after a caller-vouched ``_sorted``)."""
        key_names = self._resolve_cols(by)
        provably_sorted = _ord.covers_prefix(self._ordering, key_names)
        if not _sorted and provably_sorted:
            _sorted = True
            bump("ordering.groupby_run_detect")
        out_canonical = (not _sorted) or provably_sorted
        # canonical-lane fusion (ops/stats.py): the factorize lexsort's lane
        # stack bit-packs into fewer words where the key ranges are known;
        # the group ids are the same
        gb_fuse = None
        if not _sorted and _st.enabled():
            gspecs = self._fusion_specs(key_names)
            if gspecs:
                gb_fuse = _sort_mod.plan_lane_fusion(gspecs, pad_bits=1, prefix_bits=0,
                                                     allow64=True)
        if gb_fuse is not None:
            bump("lane_pack.groupby_fused", rows=gb_fuse.n_plain - gb_fuse.n_words)

        def ids_fn(keys):
            return _g.sorted_group_ids(keys) if _sorted else _g.group_ids(keys, fuse=gb_fuse)

        specs: List[Tuple[str, int, str]] = []
        for col, ops in agg.items():
            self._resolve_cols(col)
            for o in ops if isinstance(ops, (list, tuple)) else [ops]:
                oid = _g.agg_op_id(o)
                specs.append((col, oid, o if isinstance(o, str) else _agg_name(oid)))
        def group(s):
            sh = self._shards[s]
            keys = self._flat_cols(s, key_names)
            ids, ng = ids_fn(keys)
            rep = _g.group_representatives(ids, ng)
            # the key columns get all-true masks where they had none, as the
            # JAX package's gather_column gives them
            key_out = pack_gather(keys, rep)
            cols: Shard = OrderedDict()
            for n, (d, v) in zip(key_names, key_out):
                cols[n] = Column(d, sh[n].dtype, v, sh[n].dictionary)
            for col, oid, oname in specs:
                a, av = _g.aggregate_column(oid, sh[col].data, sh[col].valid, ids, ng,
                                            ddof=ddof, quantile=quantile)
                cols[f"{col}_{oname}"] = Column(
                    a, DataType.from_numpy_dtype(numpy_dtype(a.dtype)), av, None
                )
            return cols, ng

        with span("groupby.emit", rows=int(self._counts.sum())):
            parts = self._per_shard(group)
            counts = self._gather_counts([parts[s][1] for s in self.ctx.local_shards])
            res = Table(self.ctx, self._per_shard(lambda s: parts[s][0]), counts)
        res._attach_stats({n: self._stats.get(n) for n in key_names})
        if out_canonical:
            res._attach_ordering(Ordering(
                keys=tuple(key_names), ascending=(True,) * len(key_names), nulls_last=True,
                scope="shard", canonical=True,
                lexsort_exact=all(self._ref[n].valid is None for n in key_names),
            ))
        return res

    def distributed_groupby(
        self,
        by: Union[str, int, Sequence[Union[str, int]]],
        agg: Dict[str, Union[str, Sequence[str]]],
        **kw,
    ) -> "Table":
        """Distributed groupby: a local pre-combine when every op is
        associative (sum/min/max), a hash shuffle on the keys, the final
        local groupby. Any other op (count, mean, var, std, nunique,
        quantile) cannot pre-combine: the raw rows are shuffled. One
        device: the local groupby."""
        if self.world_size == 1:
            return self.groupby(by, agg, **kw)
        key_names = self._resolve_cols(by)
        all_ops = []
        for ops in agg.values():
            ops_list = ops if isinstance(ops, (list, tuple)) else [ops]
            all_ops += [_g.agg_op_id(o) for o in ops_list]
        t = self
        if all(o in _g.ASSOCIATIVE for o in all_ops):
            pre = t.groupby(by, agg, **kw)
            # rename the aggregates back to the source names so the final
            # pass re-aggregates them under the same spec
            ren, newagg = {}, {}
            for col, ops in agg.items():
                o = ops if isinstance(ops, (str, int)) else (ops[0] if len(ops) == 1 else None)
                if o is None:  # several ops on one column cannot share its name
                    pre = None
                    break
                oname = o if isinstance(o, str) else _agg_name(_g.agg_op_id(o))
                ren[f"{col}_{oname}"] = col
                newagg[col] = o
            if pre is not None:
                shuffled = pre.rename(ren)._shuffle_impl(key_names)
                return shuffled.groupby(by, newagg, **kw)
        return t._shuffle_impl(key_names).groupby(by, agg, **kw)

    def pipeline_groupby(
        self,
        by: Union[str, int, Sequence[Union[str, int]]],
        agg: Dict[str, Union[str, int, Sequence[Union[str, int]]]],
        **kw,
    ) -> "Table":
        """Groupby over input ALREADY sorted by the key columns (the
        reference's PipelineGroupBy): one run-detection pass replaces the
        factorize lexsort. The caller is responsible for the sortedness, as
        in the reference."""
        return self.groupby(by, agg, _sorted=True, **kw)

    def distributed_pipeline_groupby(
        self,
        by: Union[str, int, Sequence[Union[str, int]]],
        agg: Dict[str, Union[str, int, Sequence[Union[str, int]]]],
        **kw,
    ) -> "Table":
        """The range shuffle on the keys (global key order across shards),
        the local sort, then :meth:`pipeline_groupby`. One device: the sort
        and the pipeline groupby."""
        key_names = self._resolve_cols(by)
        t = self
        if self.world_size > 1:
            t = _shuffle_many([_ShuffleSpec(self, tuple(key_names), kind="range")])[0]
        return t.sort(key_names).pipeline_groupby(by, agg, **kw)

    # ------------------------------------------------------------------
    # sort
    # ------------------------------------------------------------------
    def sort(
        self,
        order_by: Union[str, int, Sequence[Union[str, int]]],
        ascending: Union[bool, Sequence[bool]] = True,
    ) -> "Table":
        """Per-shard stable sort by several keys, each ascending or not,
        nulls last (NaN last too, in either direction): one lexsort (kernel
        K1) and one packed gather a shard.

        Where the order descriptor already gives the whole spec exactly,
        the sort is a new handle over the same shards
        (``ordering.sort_elided``); where it gives a mask-free key prefix,
        the prefix becomes one run-id lane and only the rest is sorted
        (``ordering.sort_suffix``): the same rows in the same order."""
        names = self._resolve_cols(order_by)
        asc = _resolve_asc(ascending, len(names))
        m = _ord.matches_sort_spec(self._ordering, names, asc)
        if m == len(names):
            bump("ordering.sort_elided")
            # a fresh handle: an in-place change of the result must not
            # reach this table
            return self._with_shards(self._shards)._attach_ordering(self._ordering)
        # run ids agree with the lexsort only over mask-free prefix keys
        if not (0 < m < len(names) and all(self._ref[n].valid is None for n in names[:m])):
            m = 0
        # sort-word fusion (ops/stats.py, ops/sort.py): measured key ranges
        # bit-pack the suffix key lanes, null flags and the prefix lane into
        # the fewest words; CYLON_TPU_TORCH_NO_LANE_PACK=1 turns it off. The
        # prefix field is as wide as the JAX package's (its shard capacity)
        fuse = None
        if _st.enabled():
            specs = self._fusion_specs(names[m:], asc[m:])
            if specs:
                prefix_bits = (round_cap(int(self._counts.max())) + 1).bit_length() if m else 0
                fuse = _sort_mod.plan_lane_fusion(specs, pad_bits=2, prefix_bits=prefix_bits,
                                                  allow64=True)

        def sort_shard(s):
            prefix = prefix_run_lane(self._flat_cols(s, names[:m])) if m else None
            perm, _ = lexsort_rows_payload(
                self._flat_cols(s, names[m:]), int(self._counts[s]), ascending=asc[m:],
                prefix_lane=prefix, fuse=fuse,
            )
            out = pack_gather(self._flat_cols(s), perm, all_valid=True)
            return self._shard_like(s, self.column_names, out)

        if m:
            bump("ordering.sort_suffix")
        if fuse is not None:
            bump("lane_pack.sort_fused", rows=fuse.n_plain - fuse.n_words)
        mask_free = all(self._ref[n].valid is None for n in names)
        t0_prof = _time.perf_counter()
        ev0 = _obstrace.device_event() if _prof.profiling_active() else None
        passes0 = _radix.COUNTS["passes"]
        with span("sort", rows=int(self._counts.sum())):
            res = self._with_shards(self._per_shard(sort_shard))._attach_stats(self._stats)
        passes = _radix.COUNTS["passes"] - passes0
        # the sort's evidence: K1's one-sweep passes over the rows (the
        # stage clock resolves when its query finishes; host math only)
        _prof.record_sort("radix", passes, int(self._counts.sum()), self.world_size, t0_prof, ev0)
        _obsstore.note_sort("radix", _time.perf_counter() - t0_prof, passes, 0)
        return res._attach_ordering(Ordering(
            keys=tuple(names), ascending=asc, nulls_last=True, scope="shard",
            canonical=mask_free and all(asc), lexsort_exact=True,
        ))

    def distributed_sort(
        self,
        order_by: Union[str, int, Sequence[Union[str, int]]],
        ascending: Union[bool, Sequence[bool]] = True,
        num_bins: int = 0,
        num_samples: int = 0,
    ) -> "Table":
        """Global sample sort: a range shuffle on the first key (its global
        ``num_bins``-bin histogram, default 16 x W), then the local sort, so
        shard i's rows all precede shard i+1's. ``num_samples`` is accepted
        and unused, as in the JAX package. One device: the local sort."""
        names = self._resolve_cols(order_by)
        asc = _resolve_asc(ascending, len(names))
        o = self._ordering
        if o is not None and o.scope == "global" and _ord.matches_sort_spec(o, names, asc) == len(names):
            # already in this global order: a fresh handle, same shards
            bump("ordering.dist_sort_elided")
            return self._with_shards(self._shards)._attach_ordering(o)
        if self.world_size == 1:
            return self.sort(names, asc)
        shuffled = _shuffle_many([
            _ShuffleSpec(self, (names[0],), kind="range", asc0=asc[0], num_bins=num_bins)
        ])[0]
        res = shuffled.sort(names, asc)
        if res._ordering is not None:
            # range bins on the first key + the local sort: shard i's rows
            # precede shard i+1's
            res._ordering = res._ordering._replace(scope="global")
        return res

    def _join_sum_pushdown(
        self,
        other: "Table",
        left_on: Sequence[str],
        right_on: Sequence[str],
        val_col: str,
        out_key_names: Sequence[str],
        out_val: str,
    ) -> "Table":
        """INNER join + groupby-SUM(``val_col``, a left column) BY the join
        key, per shard in one pass (``ops.join.join_sum_by_key_pushdown``):
        the planner's ``fused_join_groupby`` lowering. The caller has
        co-partitioned the pair, unified its dictionaries and promoted its
        keys, as before a local join. Output: the left key columns named
        ``out_key_names`` (join-pair order), then ``out_val``, the sum over
        the join result (null where every left value of the group is
        null); groups in canonical key order. One host sync reads every
        shard's group count."""
        val = self._ref[val_col]

        def fused(s):
            lk = self._flat_cols(s, left_on)
            sums, ng, _nj, reps, vcnt = _j.join_sum_by_key_pushdown(
                lk, other._flat_cols(s, right_on), self._flat_cols(s, [val_col])[0],
            )
            return lk, sums, ng, reps, vcnt

        t0_prof = _time.perf_counter()
        prof_on = _prof.profiling_active()
        ev0 = _obstrace.device_event() if prof_on else None
        with span("join.sum_pushdown", rows=int(self._counts.sum())):
            parts = self._per_shard(fused)
            bump("host_sync")  # the group counts' one read
            counts = self._gather_counts([parts[s][2] for s in self.ctx.local_shards])
        # the pushdown's stage clocks: shape-derived units, pending until
        # the query finishes (host math only)
        if prof_on:
            _prof.record_fused(
                _prof.fused_units(self.world_size, 0, 1, int(self._counts.sum()),
                                  int(other._counts.sum()), int(counts.max()) if len(counts) else 0),
                self.world_size, t0_prof, ev0,
            )

        def shard(s):
            lk, sums, _ng, reps, vcnt = parts[s]
            n = int(counts[s])
            cols: Shard = OrderedDict()
            for name, src, (d, v) in zip(out_key_names, left_on,
                                          pack_gather(lk, reps[:n])):  # all-true masks
                c = self._shards[s][src]
                cols[name] = Column(d, c.dtype, v, c.dictionary)
            cols[out_val] = Column(sums[:n], DataType.from_numpy_dtype(numpy_dtype(sums.dtype)),
                                   None if val.valid is None else vcnt[:n] > 0, None)
            return cols

        return Table(self.ctx, self._per_shard(shard), counts)._attach_ordering(Ordering(
            keys=tuple(out_key_names), ascending=(True,) * len(out_key_names), nulls_last=True,
            scope="shard", canonical=True,
            lexsort_exact=all(self._ref[n].valid is None for n in left_on),
        ))

    def lazy(self):
        """A lazy query plan over this table (``plan/lazy.py``): build it
        with ``filter``/``select``/``join``/``groupby``/``sort``/``union``/
        ``limit``, read it with ``explain()``, run it with ``collect()``."""
        from .plan.lazy import LazyFrame

        return LazyFrame.from_table(self)

    # ------------------------------------------------------------------
    # set operations and unique
    # ------------------------------------------------------------------
    def _setop_pair(self, other: "Table") -> Tuple["Table", "Table"]:
        if self.column_names != other.column_names:
            raise ValueError("set operations require identical schemas")
        if other.ctx.devices != self.ctx.devices:
            raise ValueError("set operation of tables on different devices")
        return _unify_dict_pair(self, other, self.column_names, other.column_names)

    def union(self, other: "Table") -> "Table":
        """Distinct rows of both tables, in first-occurrence order of
        [self ++ other], per shard."""
        return self._two_table_setop(other, "union")

    def subtract(self, other: "Table") -> "Table":
        """Distinct rows of self not in other, in self's order, per shard."""
        return self._two_table_setop(other, "subtract")

    def intersect(self, other: "Table") -> "Table":
        """Distinct rows of self also in other, in self's order, per shard."""
        return self._two_table_setop(other, "intersect")

    def _two_table_setop(self, other: "Table", op: str) -> "Table":
        def sortable(t: "Table") -> bool:
            # one mask-free column (not float64) sorted ascending: run
            # detection and a binary search replace the shared sort
            if len(t._ref) != 1:
                return False
            c = next(iter(t._ref.values()))
            return (c.valid is None and c.data.dtype != torch.float64
                    and _ord.covers_prefix(t._ordering, t.column_names, need_canonical=False))

        sorted_fast = sortable(self) and sortable(other)
        a, b = self._setop_pair(other)
        if op == "union" and any(
            ca.dtype != cb.dtype for ca, cb in zip(a._ref.values(), b._ref.values())
        ):
            # mixed dtypes: the union takes concat's promoted column types
            return _concat_tables([a, b]).unique()
        if sorted_fast:
            bump("ordering.setop_sorted_probe")

        def setop(s):
            lc, rc = a._flat_cols(s), b._flat_cols(s)
            if op == "union":
                emit = _s.union_emit_sorted if sorted_fast else _s.union_emit
                idx, total, cat = emit(lc, rc)
                return cat, idx, total
            emit = _s.setop_emit_sorted if sorted_fast else _s.setop_emit
            return (lc, *emit(lc, rc, op == "intersect"))

        with span(f"setop.{op}", rows=int(a._counts.sum())):
            res = a._emit(a._per_shard(setop))
        # subtract and intersect keep a subset of the left rows in order
        if op == "union":
            return res
        return res._attach_ordering(self._ordering)._attach_stats(a._stats)

    def distributed_union(self, other: "Table") -> "Table":
        return self._dist_setop(other, "union")

    def distributed_subtract(self, other: "Table") -> "Table":
        return self._dist_setop(other, "subtract")

    def distributed_intersect(self, other: "Table") -> "Table":
        return self._dist_setop(other, "intersect")

    def _dist_setop(self, other: "Table", op: str) -> "Table":
        """Both tables hash-shuffled on all columns in one engine call, then
        the local op per shard. One device: the local op."""
        if self.world_size == 1:
            return getattr(self, op)(other)
        a, b = self._setop_pair(other)
        # intersect and subtract are semi joins: rows provably absent from
        # the side that decides their fate never ship (null == null, as the
        # sketches treat nulls)
        asf, bsf = _shuffle_pair(a, a.column_names, b, b.column_names,
                                 semi=_sketch.setop_filter_sides(op))
        return getattr(asf, op)(bsf)

    def unique(
        self,
        columns: Optional[Sequence[Union[str, int]]] = None,
        keep: str = "first",
        _order_col: Optional[str] = None,
    ) -> "Table":
        """Per-shard dedup on ``columns`` (default: all), keeping the last
        row of each key in row order for ``keep="last"`` and the first for
        any other value, as the JAX package does. ``_order_col`` (internal)
        names a column whose values decide first/last in place of the row
        position; it is left out of the output."""
        names = self.column_names if columns is None else self._resolve_cols(columns)
        names = [n for n in names if n != _order_col]
        out_names = [n for n in self.column_names if n != _order_col]
        # over rows canonically ordered by the keys, the first and last of
        # each key are its run's ends: run detection, no sort
        sorted_fast = (_order_col is None and keep in ("first", "last")
                       and _ord.covers_prefix(self._ordering, names))
        if sorted_fast:
            bump("ordering.unique_run_detect")
        keep = "last" if keep == "last" else "first"

        def dedup(s):
            sh = self._shards[s]
            if sorted_fast:
                idx, total = _s.unique_emit_sorted(self._flat_cols(s, names), keep)
            else:
                order_lane = None if _order_col is None else orderable_key(sh[_order_col].data)
                idx, total = _s.unique_emit(self._flat_cols(s, names), keep, order_lane)
            return self._flat_cols(s, out_names), idx, total

        # a subset of the rows in order: the descriptor survives
        with span("unique", rows=int(self._counts.sum())):
            res = self._emit(self._per_shard(dedup), out_names)
        return res._attach_ordering(
            self._ordering
        )._attach_stats(self._stats)

    def distributed_unique(
        self, columns: Optional[Sequence[Union[str, int]]] = None, keep: str = "first"
    ) -> "Table":
        """A hash shuffle on the key columns, then the local unique, with a
        global row id carried through the shuffle so that keep='last' (or
        first, for any other value) picks by the table's order. One device:
        the local unique."""
        if self.world_size == 1:
            return self.unique(columns, keep)
        names = self.column_names if columns is None else self._resolve_cols(columns)
        rid = "__rowid__"
        while rid in self.column_names:  # never collide with a user column
            rid += "_"
        t = self.add_column(rid, self._global_rowid_column())
        return t._shuffle_impl(names).unique(names, keep, _order_col=rid)

    # ------------------------------------------------------------------
    # whole-table aggregates (the JAX package's Table.sum/count/min/max/
    # mean/minmax, the reference's compute::Sum/Count/Min/Max): a masked
    # reduction per shard, then one all_reduce over every shard
    # ------------------------------------------------------------------
    def _reduce(self, column: Union[str, int], local_fn, op: str) -> Tuple[Column, torch.Tensor]:
        """(the column's schema, ``op`` over every shard of ``local_fn(data,
        ok)``), ``ok`` the shard's non-null rows."""
        name = self._resolve_cols(column)[0]

        def part(s):
            c = self._shards[s][name]
            ok = torch.ones_like(c.data, dtype=torch.bool) if c.valid is None else c.valid
            return local_fn(c.data, ok)

        parts = [part(s) for s in self.ctx.local_shards]
        return self._ref[name], self.ctx.comm.all_reduce(parts, op)[0]

    def sum(self, column: Union[str, int]):
        """Sum of the non-null values; integers (and bool) add in int64."""

        def local(d, ok):
            if not d.dtype.is_floating_point:
                d = d.to(torch.int64)
            return torch.where(ok, d, torch.zeros_like(d)).sum()

        return self._reduce(column, local, "sum")[1].item()

    def count(self, column: Union[str, int]) -> int:
        """Non-null values."""
        return int(self._reduce(column, lambda d, ok: ok.sum(), "sum")[1].item())

    def min(self, column: Union[str, int]):
        """Least non-null value (a dictionary column's string); the type's
        largest value when there is none, as in the JAX package."""
        return self._extreme(column, "min")

    def max(self, column: Union[str, int]):
        return self._extreme(column, "max")

    def _extreme(self, column, op: str):
        def local(d, ok):
            work, _back = _g._signed_work(d)
            fill = _g._type_extrema(work.dtype)[0 if op == "min" else 1]
            vals = torch.cat([torch.where(ok, work, fill), work.new_full((1,), fill)])
            return vals.amin() if op == "min" else vals.amax()

        col, out = self._reduce(column, local, op)
        _work, back = _g._signed_work(col.data[:0])
        return _decode_scalar(col, back(out.reshape(1))[0].item())

    def mean(self, column: Union[str, int]) -> float:
        """Mean of the non-null values in float64 (0.0 when there is none)."""
        both = self._reduce(
            column,
            lambda d, ok: torch.stack([
                torch.where(ok, d.to(torch.float64), 0.0).sum(), ok.sum().to(torch.float64)
            ]),
            "sum",
        )[1]
        return (both[0] / both[1].clamp(min=1)).item()

    def minmax(self, column: Union[str, int]):
        """(min, max) of the non-null values (reference MinMax)."""
        return self.min(column), self.max(column)

    # ------------------------------------------------------------------
    # the pandas-flavoured surface (the JAX package's table.py: null
    # handling, isin, astype, where/mask, operators, row UDFs, indexing)
    # ------------------------------------------------------------------
    @property
    def column_count(self) -> int:
        return len(self._ref)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.row_count, self.column_count)

    @property
    def context(self) -> CylonContext:
        return self.ctx

    def dtype_of(self, name: str) -> DataType:
        return self._ref[self._resolve_cols(name)[0]].dtype

    @classmethod
    def from_numpy(cls, ctx: CylonContext, names: Sequence[str], arrays) -> "Table":
        return cls.from_pydict(ctx, dict(zip(names, arrays)))

    @classmethod
    def from_list(cls, ctx: CylonContext, names: Sequence[str], data_list: Sequence) -> "Table":
        """One list per column (pycylon ``Table.from_list``); values infer
        their encoding as in :meth:`from_pydict`."""
        return cls.from_pydict(ctx, {
            n: np.asarray(col, dtype=object) if any(isinstance(v, str) for v in col)
            else np.asarray(col)
            for n, col in zip(names, data_list)
        })

    def to_numpy(self, order: str = "F") -> np.ndarray:
        """The columns stacked as a 2-D host array; object columns (strings,
        nullable ints and bools) go through float64. ``order`` is accepted
        and unused, as in the JAX package."""
        cols = [np.asarray(v, dtype=np.float64 if v.dtype == object else None)
                for v in self.to_pydict().values()]
        return np.stack(cols, axis=1) if cols else np.empty((0, 0))

    def to_string(self, row_limit: int = 10) -> str:
        """A head/tail render past ``row_limit`` rows (pandas' renderer)."""
        df = self.to_pandas()
        if self.row_count <= row_limit:
            return df.to_string()
        return df.to_string(max_rows=max(2 * (row_limit // 2), 2)) + "\n"

    def show(self, row1: int = -1, row2: int = -1, col1: int = -1, col2: int = -1) -> None:
        """Print the table, or its [row1:row2, col1:col2] window."""
        df = self.to_pandas()
        if (row1, row2, col1, col2) != (-1, -1, -1, -1):
            r2 = len(df) if row2 == -1 else row2
            c2 = df.shape[1] if col2 == -1 else col2
            df = df.iloc[max(row1, 0):r2, max(col1, 0):c2]
        print(df.to_string())

    def _map_columns(self, fn) -> "Table":
        """Every column of every shard through ``fn(column) -> Column``."""
        return self._with_shards(self._map_shards(
            lambda sh: OrderedDict((n, fn(c)) for n, c in sh.items())
        ))

    def isnull(self) -> "Table":
        """A bool table, True where a value is null (a column without a
        validity mask has none)."""
        bool_t = DataType(Type.BOOL)
        return self._map_columns(lambda c: Column(~c.valid_mask(), bool_t))

    def notnull(self) -> "Table":
        bool_t = DataType(Type.BOOL)
        return self._map_columns(lambda c: Column(c.valid_mask().clone(), bool_t))

    def isna(self) -> "Table":
        return self.isnull()

    def notna(self) -> "Table":
        return self.notnull()

    def fillna(self, value) -> "Table":
        """Nulls replaced by ``value`` in every column that has a validity
        mask (the mask goes). A dictionary column takes ``value`` into its
        sorted dictionary and remaps its codes."""

        def fill(c: Column) -> Column:
            if c.valid is None:
                return c
            if c.dtype.is_dictionary:
                data, dic, pos = _grow_dictionary(c, value)
                return Column(torch.where(c.valid, data, torch.full_like(data, pos)), c.dtype, None, dic)
            fill_v = torch.tensor(value, dtype=c.data.dtype, device=c.data.device)
            return Column(torch.where(c.valid, c.data, fill_v), c.dtype, None, None)

        # the dictionary grows alike on every shard: it is the schema's
        return self._map_columns(fill)

    def dropna(self, axis: int = 0, how: str = "any", inplace: bool = False) -> "Table":
        """The reference's Table.dropna, whose axis is pandas' flipped:
        ``axis=0`` drops the COLUMNS holding a null, ``axis=1`` the ROWS
        (:func:`compute.drop_na` takes pandas' axis)."""
        from . import compute as _c

        if axis not in (0, 1):
            raise ValueError("axis must be 0 or 1")
        out = _c.drop_na(self, how=how, axis=1 - axis)
        if inplace:
            self._shards, self._counts = out._shards, out._counts
            self.index_name = out.index_name
            self._built_index = None
            self._ordering = out._ordering
            self._stats = dict(out._stats)
            return self
        return out

    def isin(self, values, skip_null: bool = True) -> "Table":
        """:func:`compute.is_in`: a bool table, True where a value is in
        ``values``."""
        from . import compute as _c

        return _c.is_in(self, values, skip_null=skip_null)

    def _host_column_like(self, phys: np.ndarray, valid, dtype: DataType, dictionary) -> List[Optional[Column]]:
        """A host column over all rows in table order, split into this
        table's shards (None for a shard another process owns)."""
        data = self._split_rows(torch.from_numpy(np.ascontiguousarray(phys)))
        v = None if valid is None else self._split_rows(torch.from_numpy(np.asarray(valid, bool)))
        return self._per_shard(lambda s: Column(data[s], dtype, None if v is None else v[s], dictionary))

    def astype(self, dtype_map: Union[Any, Dict[str, Any]]) -> "Table":
        """Column types converted, strings both ways: string -> number parses
        the dictionary on the host and looks the codes up; number -> string
        builds a dictionary of the values' text on the host (every rank alike
        under torch.distributed). Float -> integer converts as XLA does
        (truncating, saturating, NaN -> 0)."""
        if not isinstance(dtype_map, dict):
            dtype_map = {n: dtype_map for n in self.column_names}
        t = self
        for n, dt in dtype_map.items():
            c = self._ref[n]
            want_str = dt in (str, "str", "string", "object") or (
                isinstance(dt, np.dtype) and dt.kind in ("U", "S", "O")
            )
            if c.dtype.is_dictionary:
                if want_str:
                    continue
                nd = np.dtype(dt)
                parsed = torch.from_numpy(np.ascontiguousarray(c.dictionary.astype(nd)))
                out_t = DataType.from_numpy_dtype(nd)

                def parse(col, parsed=parsed, out_t=out_t):
                    look = parsed.to(col.data.device)
                    data = (look.index_select(0, col.data.clamp(0, len(parsed) - 1))
                            if len(parsed) else look.new_zeros(col.length))
                    return Column(data, out_t, col.valid, None)

                cols = t._map_shards(lambda sh: sh[n])
                t = t.add_column(n, [None if x is None else parse(x) for x in cols])
            elif want_str:
                data_np, valid_np = t._host_physical([n])[n]
                enc, valid2, dtype2, dic = Column.encode_host(
                    np.array([str(v) for v in data_np], object))
                if valid_np is not None:
                    valid2 = valid_np if valid2 is None else (valid2 & valid_np)
                t = t.add_column(n, t._host_column_like(enc, valid2, dtype2, dic))
            else:
                nd = np.dtype(dt)
                td, out_t = torch_dtype(nd), DataType.from_numpy_dtype(nd)
                cols = t._map_shards(lambda sh: sh[n])
                t = t.add_column(n, [None if x is None else Column(_cast(x.data, td), out_t, x.valid)
                                     for x in cols])
        return t

    def where(self, cond, other=None) -> "Table":
        """Keep each value where ``cond`` is True (a null ``cond`` counts as
        False), else ``other``, or null when ``other`` is None. A dictionary
        column takes ``other`` into its dictionary."""
        masks = self._shard_masks(cond)

        def shard(s):
            keep, out = masks[s], OrderedDict()
            for n, c in self._shards[s].items():
                if other is None:
                    out[n] = Column(c.data, c.dtype, keep if c.valid is None else keep & c.valid,
                                    c.dictionary)
                    continue
                v = None if c.valid is None else torch.where(keep, c.valid, True)
                if c.dtype.is_dictionary:
                    data, dic, pos = _grow_dictionary(c, other)
                    out[n] = Column(torch.where(keep, data, torch.full_like(data, pos)), c.dtype, v, dic)
                else:
                    fill_v = torch.tensor(other, dtype=c.data.dtype, device=c.data.device)
                    out[n] = Column(torch.where(keep, c.data, fill_v), c.dtype, v, None)
            return out

        return self._with_shards(self._per_shard(shard))

    def mask(self, cond, other=None) -> "Table":
        """Replace where ``cond`` is True: :meth:`where` of its negation (a
        null ``cond`` keeps the value)."""
        masks = self._shard_masks(cond)
        return self.where(self._per_shard(lambda s: ~masks[s]), other)

    def applymap(self, fn) -> "Table":
        """A Python function over every value, on the host: each shard's
        decoded values go through ``fn`` and are encoded again (types
        re-inferred, dictionaries unified over the shards), so the rows stay
        on their shards and the index survives."""
        host = self._host_physical(self.column_names)
        offs = np.concatenate([[0], np.cumsum(self._counts)])
        enc: List[Optional[Dict[str, Encoded]]] = []
        for s in range(self.world_size):
            lo, hi = int(offs[s]), int(offs[s + 1])
            enc.append(OrderedDict(
                (n, Column.encode_host(np.asarray([fn(x) for x in self._ref[n].decode_host(
                    d[lo:hi], None if v is None else v[lo:hi])], dtype=object)))
                for n, (d, v) in host.items()
            ))
        unify_encoded_shards(enc)
        out = Table.from_encoded_shards(
            self.ctx, [e if s in self.ctx.local_shards else None for s, e in enumerate(enc)],
            self._counts)
        out.index_name = self.index_name if self.index_name in out._ref else None
        return out

    def select_rows(self, predicate) -> "Table":
        """Keep the rows for which ``predicate(Row)`` holds: a Python row
        function run on the host over the decoded values (the reference's
        Select); prefer the vectorized :meth:`select`."""
        host = self.to_pydict()
        n = self.row_count
        return self.filter(np.fromiter((bool(predicate(Row(host, i))) for i in range(n)),
                                       bool, count=n))

    def iterrows(self) -> Iterator[Tuple[Any, "OrderedDict[str, Any]"]]:
        """(index value, row as an OrderedDict) per row, on the host."""
        host = self.to_pydict()
        names = self.column_names
        idx = host[self.index_name] if self.index_name is not None else np.arange(self.row_count)
        for i in range(self.row_count):
            yield idx[i], OrderedDict((n, host[n][i]) for n in names)

    def equals(self, other: "Table", ordered: bool = True) -> bool:
        """Content equality. ``ordered``: row for row on the devices when the
        shards hold the same row counts (a null equals a null whatever its
        payload, NaN equals NaN), else through pandas on the host (its
        float tolerance, as in the JAX package). Unordered: the tables as
        multisets of rows, each a groupby-count over all columns, compared
        by a subtract both ways."""
        if self.column_names != other.column_names or self.row_count != other.row_count:
            return False
        if ordered:
            if (self._counts == other._counts).all():
                return self._device_equal(other)
            import pandas.testing as pdt

            try:
                pdt.assert_frame_equal(self.to_pandas(), other.to_pandas(), check_dtype=False)
                return True
            except AssertionError:
                return False
        a, b = self._row_multiset(), other._row_multiset()
        if a.row_count != b.row_count:
            return False
        return (a.distributed_subtract(b).row_count == 0
                and b.distributed_subtract(a).row_count == 0)

    def _device_equal(self, other: "Table") -> bool:
        for n in self.column_names:
            if self._ref[n].dtype.is_dictionary != other._ref[n].dtype.is_dictionary:
                return False
        a, b = _unify_dict_pair(self, other, self.column_names, other.column_names)

        def shard_ok(s):
            ok = torch.ones((), dtype=torch.bool, device=self.ctx.devices[s])
            for n in a.column_names:
                ca, cb = a._shards[s][n], b._shards[s][n]
                va, vb = ca.valid_mask(), cb.valid_mask().to(ca.data.device)
                db = cb.data.to(ca.data.device)
                same = ca.data == db
                if ca.data.is_floating_point() and db.is_floating_point():
                    same = same | (torch.isnan(ca.data) & torch.isnan(db))
                ok = ok & ((va == vb) & (same | ~va)).all()
            return ok.to(torch.int64)

        return bool(self._gather_counts([shard_ok(s) for s in self.ctx.local_shards]).all())

    def _row_multiset(self) -> "Table":
        """(distinct row, multiplicity): a groupby-count over every column."""
        w = "__row_weight__"
        ones = self._per_shard(lambda s: Column(
            torch.ones(int(self._counts[s]), dtype=torch.int32, device=self.ctx.devices[s]),
            DataType(Type.INT32)))
        return self.add_column(w, ones).distributed_groupby(self.column_names, {w: "count"})

    # pycylon's item access and operators; a comparison returns a bool table
    def __getitem__(self, key):
        """A column name or a list of them -> a projection; a slice -> the
        rows by position; a bool mask -> :meth:`filter`."""
        if isinstance(key, str):
            return self.project([key])
        if isinstance(key, (list, tuple)) and key and all(isinstance(k, str) for k in key):
            return self.project(list(key))
        if isinstance(key, slice):
            return self.take(np.arange(*key.indices(self.row_count)))
        return self.filter(key)

    def __setitem__(self, key, value) -> None:
        """``t['c'] = values | scalar | Column`` adds or replaces a column;
        ``t[mask] = scalar`` sets the masked rows' values (:meth:`mask`)."""
        self._built_index = None
        self._ordering = None  # an in-place change voids any order claim
        self._stats = {}  # ...and any range-stats claim
        if isinstance(key, str):
            if isinstance(value, Column) or (
                isinstance(value, (list, tuple)) and any(isinstance(v, Column) for v in value)
            ):
                new = self.add_column(key, value)
            else:
                if np.isscalar(value):
                    value = np.full(self.row_count, value)
                phys, valid, dtype, dic = Column.encode_host(np.asarray(value))
                new = self.add_column(key, self._host_column_like(phys, valid, dtype, dic))
        else:
            new = self.mask(key, value)
        self._shards = new._shards

    def __bool__(self) -> bool:
        raise ValueError(
            "The truth value of a Table is ambiguous; use Table.equals() or row_count"
        )

    def __hash__(self):  # __eq__ returns a table; hashing stays by identity
        return id(self)

    def _cmp(self, other, op):
        from . import compute as _c

        return _c.table_compare_op(self, other, op)

    def __eq__(self, other):  # noqa: A003 (pycylon's elementwise equality)
        return self._cmp(other, _op.eq)

    def __ne__(self, other):
        return self._cmp(other, _op.ne)

    def __lt__(self, other):
        return self._cmp(other, _op.lt)

    def __le__(self, other):
        return self._cmp(other, _op.le)

    def __gt__(self, other):
        return self._cmp(other, _op.gt)

    def __ge__(self, other):
        return self._cmp(other, _op.ge)

    def _math(self, op, other):
        from . import compute as _c

        return _c.math_op(self, op, other)

    def __add__(self, other):
        return self._math("add", other)

    def __radd__(self, other):
        return self._math("add", other)

    def __sub__(self, other):
        return self._math("sub", other)

    def __mul__(self, other):
        return self._math("mul", other)

    def __rmul__(self, other):
        return self._math("mul", other)

    def __truediv__(self, other):
        from . import compute as _c

        return _c.division_op(self, "/", other)

    def __floordiv__(self, other):
        from . import compute as _c

        return _c.division_op(self, "floordiv", other)

    def __neg__(self):
        from . import compute as _c

        return _c.neg(self)

    def __invert__(self):
        from . import compute as _c

        return _c.invert(self)

    def __and__(self, other):
        return self._math(_op.and_, other)

    def __or__(self, other):
        return self._math(_op.or_, other)

    # ------------------------------------------------------------------
    # indexing (set_index / loc / iloc; the JAX package's indexing/)
    # ------------------------------------------------------------------
    def set_index(self, column: Union[str, int], drop: bool = False) -> "Table":
        """Name a column the index. ``drop=True`` is refused: the index is a
        column of the table."""
        if drop:
            raise ValueError("drop=True unsupported: the index is a live column")
        t = self._with_shards(self._shards)
        t.index_name = self._resolve_cols(column)[0]
        return t._attach_ordering(self._ordering)

    def reset_index(self) -> "Table":
        t = self._with_shards(self._shards)
        t.index_name = None
        return t._attach_ordering(self._ordering)

    @property
    def index(self):
        from .indexing import ColumnIndex, RangeIndex

        if self.index_name is None:
            return RangeIndex(self.row_count)
        return ColumnIndex(self.index_name)

    def get_index(self):
        return self.index

    def build_index(self, kind: str = "hash"):
        """Build once, and keep, the sorted view of the index column that
        later ``loc`` list lookups probe on its device: 'hash' skips a
        missing label, 'linear' raises KeyError for it, as the reference's
        LinearIndex."""
        from .indexing import HashIndex, LinearIndex

        if self._built_index is not None and self._built_index[0] == (kind, self.index_name):
            return self._built_index[1]
        if kind == "hash":
            idx = HashIndex(self)
        elif kind == "linear":
            idx = LinearIndex(self)
        else:
            raise ValueError(f"unknown index kind {kind!r}")
        self._built_index = ((kind, self.index_name), idx)
        return idx

    @property
    def loc(self):
        from .indexing import LocIndexer

        return LocIndexer(self)

    @property
    def iloc(self):
        from .indexing import ILocIndexer

        return ILocIndexer(self)

    def task_partition(self, hash_columns: Sequence[Union[str, int]], plan) -> Dict[int, "Table"]:
        """Task-based all-to-all (the reference's ArrowTaskAllToAll and
        LogicalTaskPlan): hash rows into the plan's logical tasks and send
        each task to its owning worker. Returns {task_id: Table}
        (:func:`cylon_tpu_torch.parallel.task.task_partition`)."""
        from .parallel.task import task_partition as _tp

        return _tp(self, hash_columns, plan)

    # ------------------------------------------------------------------
    # Arrow and CSV (io/, native/)
    # ------------------------------------------------------------------
    @classmethod
    def from_arrow(cls, ctx: CylonContext, atable) -> "Table":
        """From a pyarrow.Table, typed (reference Table::FromArrowTable):
        dictionary arrays keep their codes (remapped onto a sorted
        dictionary), integer columns with nulls stay integral, validity
        bitmaps become the mask (:func:`_encode_arrow_array`)."""
        return cls.from_encoded(ctx, OrderedDict(
            (name, _encode_arrow_array(atable.column(name))) for name in atable.column_names))

    def to_arrow(self, shard: Optional[int] = None):
        """Typed pyarrow.Table: dictionary columns as pa.DictionaryArray
        (codes and dictionary), validity masks as null bitmaps, integers
        integral. ``shard=i`` exports shard i's rows alone, fetched without
        a gather (per-rank IO; the shard must be this process's)."""
        import pyarrow as pa

        if shard is None:
            host = self._host_physical(self.column_names)
        else:
            host = {n: self._host_physical_shard(n, shard) for n in self.column_names}
        arrays = []
        for name in self.column_names:
            col, (data, valid) = self._ref[name], host[name]
            mask = None if valid is None else ~valid
            if col.dtype.is_dictionary:
                arr = pa.DictionaryArray.from_arrays(
                    pa.array(np.asarray(data, np.int32), mask=mask),
                    pa.array(col.dictionary.astype(object)))
            elif col.dtype.type == Type.TIMESTAMP:
                arr = pa.array(data.astype("datetime64[ns]"), mask=mask)
            elif col.dtype.type == Type.DURATION:
                arr = pa.array(data.astype("timedelta64[ns]"), mask=mask)
            else:
                arr = pa.array(data, mask=mask)
            arrays.append(arr)
        return pa.Table.from_arrays(arrays, names=self.column_names)

    def to_csv(self, path, csv_write_options=None) -> None:
        """Write CSV (reference table.pyx to_csv): one file, or one a shard
        given a list of world_size paths (:func:`io.csv.write_csv`)."""
        from .io.csv import write_csv

        write_csv(self, path, csv_write_options)

    def __repr__(self):
        return (
            f"Table(rows={self.row_count}, columns={self.column_names}, "
            f"world_size={self.world_size})"
        )


def _decode_scalar(col: Column, value):
    if col.dtype.is_dictionary:
        return col.dictionary[int(value)]
    return value


def _resolve_asc(ascending, k: int) -> Tuple[bool, ...]:
    if isinstance(ascending, bool):
        return (ascending,) * k
    asc = tuple(bool(a) for a in ascending)
    if len(asc) != k:
        raise ValueError(f"{len(asc)} ascending flags for {k} sort keys")
    return asc


def _check_join_args(algorithm: str, emit_order: str) -> None:
    if algorithm not in ("sort", "hash", "pallas_pk"):
        raise ValueError(f"unknown join algorithm {algorithm!r}")
    if emit_order not in ("left", "key"):
        raise ValueError(f"unknown emit_order {emit_order!r}")
    if emit_order == "key" and algorithm == "pallas_pk":
        raise ValueError("emit_order='key' is not supported by algorithm='pallas_pk'")


def _out_shard(out_names, left: "Table", right: "Table", s: int, out) -> Shard:
    """Shard s of a join output: the gathered (data, valid) pairs under the
    output names, with the source columns' types and dictionaries."""
    src = list(left._shards[s].values()) + list(right._shards[s].values())
    cols: Shard = OrderedDict()
    for name, c, (d, v) in zip(out_names, src, out):
        cols[name] = Column(d, c.dtype, v, c.dictionary)
    return cols


def _suffix_names(lnames, rnames, suffixes):
    overlap = set(lnames) & set(rnames)
    out = [n + suffixes[0] if n in overlap else n for n in lnames]
    out += [n + suffixes[1] if n in overlap else n for n in rnames]
    return out


def _agg_name(oid: int) -> str:
    return {
        _g.SUM: "sum", _g.COUNT: "count", _g.MIN: "min", _g.MAX: "max",
        _g.MEAN: "mean", _g.VAR: "var", _g.STDDEV: "std", _g.NUNIQUE: "nunique",
        _g.QUANTILE: "quantile",
    }[oid]


def _remap_codes(col: Column, mapping: np.ndarray, dictionary: np.ndarray) -> Column:
    if col.length == 0:
        return Column(col.data, col.dtype, col.valid, dictionary)
    m = torch.from_numpy(mapping).to(col.data.device)
    data = m.index_select(0, col.data.clamp(0, len(mapping) - 1))
    return Column(data, col.dtype, col.valid, dictionary)


def _plan_join_fusion(left: Table, l_names, right: Table, r_names):
    """Sort-word fusion plan of a join pair's factorize lanes, or None: lane
    packing is off; the pair takes the one-uint32-key fast path (one lane
    already, no stats pass); a key pair's dtypes differ; or a key has no
    measurable stats. The merged bounds of both sides size each field."""
    if not _st.enabled():
        return None
    if len(l_names) == 1:
        ca, cb = left._ref[l_names[0]], right._ref[r_names[0]]
        if (ca.valid is None and cb.valid is None
                and ca.data.element_size() <= 4 and cb.data.element_size() <= 4):
            return None
    lstats = left.ensure_stats(l_names)
    rstats = right.ensure_stats(r_names)
    specs = []
    for ln, rn in zip(l_names, r_names):
        ca, cb = left._ref[ln], right._ref[rn]
        if ca.data.dtype != cb.data.dtype:
            return None
        a, b = lstats.get(ln), rstats.get(rn)
        if a is None or b is None:
            return None
        merged = a.merge(b)
        if merged is None:
            return None
        specs.append((merged.cls, _st.field_bits(merged),
                      ca.valid is not None or cb.valid is not None, True))
    return _sort_mod.plan_lane_fusion(specs, pad_bits=1, prefix_bits=0, allow64=True)


def _unify_dict_pair(
    a: Table, b: Table, a_cols: Sequence[str], b_cols: Sequence[str]
) -> Tuple[Table, Table]:
    """Remap the dictionary codes of paired string key columns onto their
    union dictionary, so codes compare across the two tables. A pure
    function of the dictionaries, which every rank holds alike."""
    new_a, new_b = a._map_shards(OrderedDict), b._map_shards(OrderedDict)
    changed_a, changed_b = set(), set()
    for an, bn in zip(a_cols, b_cols):
        ca, cb = a._ref[an], b._ref[bn]
        if ca.dtype.is_dictionary != cb.dtype.is_dictionary:
            raise ValueError(f"cannot join string key {an!r} with numeric key {bn!r}")
        if not ca.dtype.is_dictionary:
            continue
        if ca.dictionary is cb.dictionary or (
            len(ca.dictionary) == len(cb.dictionary)
            and (ca.dictionary == cb.dictionary).all()
        ):
            continue
        union, map_a, map_b = unify_dictionaries(ca, cb)
        for sh in filter(None, new_a):
            sh[an] = _remap_codes(sh[an], map_a, union)
        for sh in filter(None, new_b):
            sh[bn] = _remap_codes(sh[bn], map_b, union)
        changed_a.add(an)
        changed_b.add(bn)
    if not changed_a:
        return a, b
    # the remap keeps code order, so an order claim survives it; range
    # stats survive on the columns whose codes were not rewritten
    return (
        a._with_shards(new_a)._attach_ordering(a._ordering)._attach_stats(
            {n: v for n, v in a._stats.items() if n not in changed_a}),
        b._with_shards(new_b)._attach_ordering(b._ordering)._attach_stats(
            {n: v for n, v in b._stats.items() if n not in changed_b}),
    )


def _promote_key_pair(
    a: Table, b: Table, a_cols: Sequence[str], b_cols: Sequence[str]
) -> Tuple[Table, Table]:
    """Cast paired numeric key columns to their common promoted dtype (numpy
    rules) so both sides hash and compare identically."""
    new_a, new_b = a._map_shards(OrderedDict), b._map_shards(OrderedDict)
    changed = False
    for an, bn in zip(a_cols, b_cols):
        ca, cb = a._ref[an], b._ref[bn]
        if ca.dtype.is_dictionary or cb.dtype.is_dictionary:
            continue  # mixed string/numeric pairs are rejected by _unify_dict_pair
        if ca.data.dtype == cb.data.dtype:
            continue
        common = promote_key_dtypes(ca.data.dtype, cb.data.dtype)
        dt = DataType.from_numpy_dtype(numpy_dtype(common))
        for shards, name in ((new_a, an), (new_b, bn)):
            for sh in filter(None, shards):
                c = sh[name]
                sh[name] = Column(c.data.to(common), dt, c.valid, None)
        changed = True
    if not changed:
        return a, b
    # a widening cast keeps value order; range stats of the cast columns
    # drop (_attach_stats also re-checks the encoding class)
    ra = a._with_shards(new_a)._attach_ordering(a._ordering)
    rb = b._with_shards(new_b)._attach_ordering(b._ordering)
    return (
        ra._attach_stats({n: v for n, v in a._stats.items() if ra._ref[n] is a._ref[n]}),
        rb._attach_stats({n: v for n, v in b._stats.items() if rb._ref[n] is b._ref[n]}),
    )


def concat(tables: Sequence[Table]) -> Table:
    """Row-stack same-schema tables shard by shard (pycylon's Table.concat,
    the JAX package's module-level ``concat``, which the C ABI's
    ``ct_api_merge`` calls)."""
    return _concat_tables(list(tables))


def _concat_tables(tables: Sequence[Table]) -> Table:
    """Row-wise concat of same-schema tables, per shard, as a balanced
    binary fold (the reference's Merge)."""
    if len(tables) == 1:
        return tables[0]
    mid = len(tables) // 2
    a, b = _concat_tables(tables[:mid]), _concat_tables(tables[mid:])
    if a.column_names != b.column_names:
        raise ValueError("concat requires identical schemas")
    if a.ctx.devices != b.ctx.devices:
        raise ValueError("concat of tables on different devices")
    a, b = _unify_dict_pair(a, b, a.column_names, b.column_names)
    shards = []
    for sa, sb in zip(a._shards, b._shards):
        if sa is None:
            shards.append(None)
            continue
        cols: Shard = OrderedDict()
        for name, ca in sa.items():
            cb = sb[name]
            common = promote_concat_dtypes(ca.data.dtype, cb.data.dtype)
            valid = None
            if ca.valid is not None or cb.valid is not None:
                valid = torch.cat([
                    torch.ones_like(c.data, dtype=torch.bool) if c.valid is None else c.valid
                    for c in (ca, cb)
                ])
            dt = ca.dtype if common == ca.data.dtype else DataType.from_numpy_dtype(numpy_dtype(common))
            cols[name] = Column(
                torch.cat([ca.data.to(common), cb.data.to(common)]), dt, valid, ca.dictionary
            )
        shards.append(cols)
    return a._with_shards(shards, a._counts + b._counts)


# ----------------------------------------------------------------------
# the chunked shuffle engine
# ----------------------------------------------------------------------

class _ShuffleSpec(NamedTuple):
    """One table of a shuffle: its keys, the per-round byte budget (None:
    the context's) and the kind: "hash" routes a row by the murmur3 hash
    of its keys, "range" by the range partition of its first key
    (``asc0``: that key's direction; ``num_bins``: 0 for 16 x W), "task"
    by ``task_map[t]`` of the logical task id t in its one key column.

    The sketch fields carry the semi-join filter (ops/sketch.py): with
    ``sketch`` (per owned shard, the pair's combined ``[S, L]`` sketches
    of :func:`_pair_sketches`), the count phase probes the key columns
    against row ``probe_row`` and a row that provably has no partner on
    the other side goes to B2a's pid mode as P, never to the exchange."""

    table: Table
    key_names: Tuple[str, ...]
    byte_budget: Optional[int] = None
    kind: str = "hash"
    asc0: bool = True
    num_bins: int = 0
    sketch: Optional[Dict[int, torch.Tensor]] = None
    probe_row: int = 0
    use_range: bool = False
    #: per owned shard the key hashes the sketch build made of this table
    #: (both sides filtered: each table is built and probed), or None
    key_hashes: Optional[Dict[int, Tuple[torch.Tensor, torch.Tensor]]] = None
    #: the task kind's task -> worker map ([T] ints)
    task_map: Optional[np.ndarray] = None
    #: a caller-owned host sink, ``accept(table, shard_cols, counts)``: the
    #: received rows stream into it as decoded physical columns (no q8
    #: codes) at tier 1 or 2, and the shuffle returns None for this table
    #: (the out-of-core ingest, parallel/ooc.py)
    sink: Optional[Any] = None


def _shuffle_state(spec: _ShuffleSpec) -> dict:
    """Per-table count phase: per source shard the partition-id lane of
    kernel B2a (hash mode: from the key words; range mode: the range pid
    lane it is given), each tile's first position within each bucket (the
    scan of B2a's histogram, for B2b) and the bucket totals (the send
    counts). A semi-filtered table also gets the filtered lane: the same
    pids with P for the rows the other side's sketch prunes, through B2a in
    pid mode, beside the unfiltered counts. Beside them, the stat words of
    every statable column (lane packing), to ride the same host fetch."""
    t = spec.table
    world, local = t.world_size, t.ctx.local_shards
    if not t.column_names:
        raise ValueError("cannot shuffle a table without columns")
    counts = [int(n) for n in t._counts]
    if spec.kind == "range":
        pids = _p.range_partition_ids(
            [t._flat_cols(s, spec.key_names[:1])[0] for s in local],
            world, t.ctx.comm, spec.num_bins, spec.asc0,
        )
        packs = {s: _codec.pack_hist(None, None, (), counts[s], world, pid=pid)
                 for s, pid in zip(local, pids)}
    elif spec.kind == "hash":
        khash = t._key_hash_cols(spec.key_names)
        packs = {s: _codec.pack_hist(*_codec.key_words(khash[s]), counts[s], world) for s in local}
    elif spec.kind == "task":
        # task t goes to worker task_map[t]: one gather, then B2a in pid mode
        tmap = torch.from_numpy(np.asarray(spec.task_map, np.int32))
        packs = {}
        for s in local:
            tasks = t._shards[s][spec.key_names[0]].data
            wid = tmap.to(tasks.device).index_select(0, tasks.clamp(0, len(tmap) - 1).to(torch.int64))
            packs[s] = _codec.pack_hist(None, None, (), counts[s], world, pid=wid)
    else:
        raise ValueError(f"unknown shuffle kind {spec.kind!r}")
    flat = {s: t._flat_cols(s) for s in local}
    ref = flat[local[0]]  # the schema's, the same on every rank
    stat_cols = tuple(
        ci for ci, (d, _v) in enumerate(ref) if _st.enabled() and _st.enc_class(d.dtype) is not None
    )
    # the lossy wire tier (ops/quant.py): float payload columns may ride
    # quantized fields; key columns never do. It rides the wire codec, so
    # CYLON_TPU_TORCH_NO_LANE_PACK turns it off too
    names = t.column_names
    quant_sig = _quant.quant_spec(
        [d.dtype for d, _v in ref], [names.index(n) for n in spec.key_names],
        t.ctx.quant_tol if _st.enabled() else 0.0,
    )
    shards = {}
    for s, (lane, hist) in packs.items():
        sh = {"lane": lane, "hist": hist}
        meas = [hist.sum(1).to(torch.int64)]
        if spec.sketch is not None:
            keys = t._flat_cols(s, spec.key_names)
            hashes = None if spec.key_hashes is None else spec.key_hashes[s]
            ok = _sketch.probe(keys, spec.sketch[s][spec.probe_row], spec.use_range, hashes)
            pid_f = torch.where(ok, lane, torch.full_like(lane, world))
            sh["lane_f"], sh["hist_f"] = _codec.pack_hist(None, None, (), counts[s], world, pid=pid_f)
            meas.append(sh["hist_f"].sum(1).to(torch.int64))
        meas += [_st.stat_words(flat[s][ci]) for ci in stat_cols]
        sh["meas"] = torch.cat(meas)
        shards[s] = sh
    # the relay and the spill arenas cross the host with the 'q8' columns
    # of the signature only (qb16 and qf32 are wire-only)
    relay_qsig = tuple(c if c == "q8" else None for c in quant_sig)
    plan = lane_plan(ref)
    return {
        "spec": spec, "t": t, "ctx": t.ctx, "world": world, "local": local, "flat": flat,
        "ref": ref, "row_bytes": _sh.exchange_row_bytes(ref), "stat_cols": stat_cols,
        "quant_sig": quant_sig, "shards": shards, "plan": plan,
        "relay_qsig": relay_qsig if any(relay_qsig) else None,
        # the two-hop exchange (parallel/topo.py) needs the JAX package's
        # word lanes for its headers: a table of only non-null float64
        # columns has none there (they ride a passthrough), and stays flat
        "topo_cfg": _topo.effective(t.ctx),
        "has_lanes": any(dt != torch.float64 or hv for dt, _nl, hv in plan),
    }


def _count_phase(st: dict) -> None:
    """The count phase's one host fetch: this process's send counts
    (unfiltered, filtered) and stat words, gathered from every rank, so
    that every rank plans from the same numbers. Folds the global column
    stats and keeps them on the input table (later local ops skip their
    stats pass) and for the wire plan and the output."""
    w, local = st["world"], st["local"]
    dev0 = st["ctx"].device
    bump("host_sync")
    mine = torch.stack([st["shards"][s]["meas"].to(dev0) for s in local]).cpu().numpy()
    got = st["ctx"].comm.all_gather_counts(mine)  # [src, per]
    semi = st["spec"].sketch is not None
    st["counts_u"] = got[:, :w]  # [src, dst]
    st["counts_f"] = got[:, w:2 * w] if semi else None
    base = 2 * w if semi else w
    sw = got[:, base:].reshape(w, len(st["stat_cols"]), 4)
    st["col_stats"] = {
        ci: _st.fold_stat_words(sw[:, i, :], _st.enc_class(st["ref"][ci][0].dtype))
        for i, ci in enumerate(st["stat_cols"])
    }
    names = st["t"].column_names
    st["t"]._attach_stats({names[ci]: v for ci, v in st["col_stats"].items()})


def _plan_state(st: dict) -> None:
    """The schedule of one table, in the JAX package's order:

    1. the semi filter's plan-aware gate: shipped bytes are rounds x W x
       bucket_cap x row bytes however full the buffers are, so the filter
       applies only where the filtered counts give a strictly cheaper
       ``plan_rounds`` plan (``cap_f * k_f < cap_u * k_u``);
    2. the skew split (``spill.plan_schedule``): a non-skewed matrix keeps
       ``plan_rounds``' plan; where a bucket is over 4x the mean, the rounds
       are sized for the cold buckets and each heavy bucket's rows past
       the quota ``K * bucket_cap`` go through the host relay;
    3. the wire gate: the narrowed rows are re-planned through
       ``plan_schedule`` at their row bytes and apply only where their
       schedule ships strictly fewer bytes, a relayed row costing
       ``RELAY_COST_FACTOR`` x its plain row bytes either way;
    4. under a declared 2-D topology (parallel/topo.py), the two-hop plan
       (``cap_o``; a tight ``CYLON_TPU_TORCH_OUTER_BUDGET`` halves the
       budget and re-plans until the outer hop fits) and the per-axis
       ledger ``shuffle.coll_bytes.{intra,inter,inter_alt}``;
    5. the spill tier (``spill.choose_tier``, from the staged bytes of the
       fullest shard) and, past tier 0, the engine's arena sink, with the
       q8 columns of the quantized tier held as codes; under two hops at
       tier 0, the split of the relay: same-group tails to the device ring;
    6. the analytic peak device bytes of a shard (the
       ``shuffle.spill.peak_device_bytes`` gauge): its input rows, a
       round's send and receive buffers (both hops' under two hops), the
       compacted round outputs held on the device (every round at tier 0,
       at most two when spilled), its host relay extraction and its ring
       buffers, at the plain row bytes. The port's buffers are
       exact-length, so the value departs from the JAX package's, which
       counts padded capacities."""
    from .plan import feedback as _feedback

    w = st["world"]
    # an explicit per-call budget wins; then the feedback re-coster's
    # tuned budget of the running plan (only inside a plan execution whose
    # fingerprint carries it); then the context's
    budget = int(st["spec"].byte_budget or _feedback.tuned_shuffle_budget()
                 or st["ctx"].shuffle_byte_budget)
    # the skew split's engagement ratio: the re-coster's tuned trigger
    # where the straggler evidence earned one, else the static 4x mean
    skew_trigger = _feedback.tuned_skew_trigger()
    row_bytes = st["row_bytes"]
    st["use_filter"] = False
    if st["counts_f"] is not None:
        unf, filt = st["counts_u"], st["counts_f"]
        tot_u, tot_f = int(unf.sum()), int(filt.sum())
        gauge("shuffle.semi_filter.selectivity", tot_f / max(tot_u, 1))
        _obsstore.note_semi(sel=tot_f / max(tot_u, 1), built=True)
        cap_u, k_u = _sh.plan_rounds(unf, row_bytes, w, budget)
        cap_f, k_f = _sh.plan_rounds(filt, row_bytes, w, budget)
        st["use_filter"] = cap_f * k_f < cap_u * k_u
        if st["use_filter"]:
            bump("shuffle.semi_filter.applied")
            bump("shuffle.semi_filter.pruned_rows", rows=tot_u - tot_f)
            st["send_counts"] = filt
        else:
            bump("shuffle.semi_filter.gate_skipped")
            st["send_counts"] = unf
    else:
        st["send_counts"] = st["counts_u"]
    sched = _spill.plan_schedule(st["send_counts"], row_bytes, w, budget, trigger=skew_trigger)
    st["wire"] = st["bases"] = None
    if st["col_stats"] or any(c is not None for c in st["quant_sig"]):
        stats_list: List[Optional[Tuple[str, int]]] = [None] * len(st["ref"])
        for ci, stat in st["col_stats"].items():
            stats_list[ci] = (stat.cls, _st.field_bits(stat))
        wplan = wire_plan(wire_lane_plan(st["ref"]), stats_list, quant=st["quant_sig"])
        if wplan is not None:
            rb_w = wire_row_bytes(wplan)
            sched_w = _spill.plan_schedule(st["send_counts"], rb_w, w, budget,
                                           trigger=skew_trigger)
            relay_rb = _spill.RELAY_COST_FACTOR * row_bytes
            total_wire = sched_w.coll_row_slots(w) * rb_w + sched_w.relay_rows() * relay_rb
            total_plain = sched.coll_row_slots(w) * row_bytes + sched.relay_rows() * relay_rb
            if total_wire < total_plain:
                st["wire"] = wplan
                st["bases"] = wire_bases(wplan, st["col_stats"])
                sched = sched_w
                bump("lane_pack.wire.applied")
                bump("lane_pack.wire.bytes_saved", rows=int(total_plain - total_wire))
                gauge("lane_pack.wire.row_bytes_ratio", rb_w / max(row_bytes, 1))
                if wire_has_quant(wplan):
                    bump("shuffle.quant.applied")
                    bump("shuffle.quant.cols", rows=sum(1 for f in wplan.fields if f.kind == "q"))
                    bump("shuffle.quant.bytes_saved", rows=int(total_plain - total_wire))
                    gauge("shuffle.quant.row_bytes_ratio", rb_w / max(row_bytes, 1))
            else:
                bump("lane_pack.wire.gate_skipped")
                if wire_has_quant(wplan):
                    bump("shuffle.quant.gate_skipped")
    st["sched"] = sched
    st["bucket_cap"], st["n_rounds"] = sched.bucket_cap, sched.n_rounds
    rb_eff = row_bytes if st["wire"] is None else wire_row_bytes(st["wire"])
    nh = _sh.wire_header_rows(st["wire"]) if st["wire"] is not None else _sh.HEADER_ROWS
    # the two-hop decision (parallel/topo.py): a declared 2-D topology
    # routes the exchange as an inner hop and a dense cross-outer hop. It
    # needs word lanes for the headers and exactly one header row (a
    # q8-widened wire keeps the flat path: its per-chunk scale blocks do
    # not survive the hop-2 repack). The re-coster's tuned hop mode can
    # force "1hop" for the shape; None takes two hops on a declared mesh.
    tcfg = st["topo_cfg"]
    two_hop_ok = (tcfg is not None and (st["has_lanes"] or st["wire"] is not None) and nh == 1
                  and not wire_q8_cols(st["wire"]))
    tp = None
    if two_hop_ok and _feedback.tuned_hop_mode() != "1hop":
        ob = _topo.outer_budget()
        while True:
            tp = _topo.plan_two_hop(st["send_counts"], tcfg, st["bucket_cap"], st["n_rounds"], nh)
            # a tighter CYLON_TPU_TORCH_OUTER_BUDGET halves the global
            # budget (more, smaller rounds) until the combined buffer fits
            if not ob or st["bucket_cap"] <= 8 or tcfg.outer * (tp.cap_o + nh) * int(rb_eff) <= ob:
                break
            budget //= 2
            sched = _spill.plan_schedule(st["send_counts"], int(rb_eff), w, budget,
                                         trigger=skew_trigger)
            st["sched"] = sched
            st["bucket_cap"], st["n_rounds"] = sched.bucket_cap, sched.n_rounds
    st["topo_plan"] = tp
    bc, k = st["bucket_cap"], st["n_rounds"]
    # rows of one round's compacted output: W chunks flat; the inner hop-1
    # self chunks and the outer combined chunks under two hops
    recv_cap = tp.inner * bc + tp.outer * tp.cap_o if tp is not None else w * bc
    # the per-axis byte ledger: intra = inner-axis bytes, inter =
    # cross-outer bytes, inter_alt = the flat exchange's inter bytes from
    # the same counts (the pair the locality gate reads from one run)
    intra_b = inter_b = 0
    if tcfg is not None:
        intra_b, inter_b = _topo.axis_coll_bytes(tcfg, w, bc, k, int(rb_eff), nh,
                                                 cap_o=None if tp is None else tp.cap_o)
        bump("shuffle.coll_bytes.intra", rows=intra_b)
        bump("shuffle.coll_bytes.inter", rows=inter_b)
        annotate_add(coll_bytes_intra=intra_b, coll_bytes_inter=inter_b)
    # the other hop mode's cross-outer bytes from the same counts (flat
    # where two hops ran, two hops where the flat exchange was forced), so
    # one run carries both modes' evidence for the hop-mode proposer
    inter_alt = -1
    if two_hop_ok:
        alt_cap_o = None if tp is not None else _topo.plan_two_hop(
            st["send_counts"], tcfg, bc, k, nh).cap_o
        inter_alt = _topo.axis_coll_bytes(tcfg, w, bc, k, int(rb_eff), nh, cap_o=alt_cap_o)[1]
        bump("shuffle.coll_bytes.inter_alt", rows=inter_alt)
    # shipped bytes: flat, K rounds x W^2 bucket blocks x the (narrowed)
    # row bytes; two-hop, both hops' bytes; and the relay's rows at their
    # plain row bytes
    coll_bytes = intra_b + inter_b if tp is not None else sched.coll_row_slots(w) * int(rb_eff)
    # the bytes ride the span that runs the shuffle (a plan node's):
    # explain(analyze=True) prints them on its line
    annotate_add(coll_bytes=coll_bytes, shuffle_rounds=int(st["n_rounds"]))
    bump("shuffle.exchanged_bytes", rows=coll_bytes)
    if sched.adaptive:
        bump("shuffle.spill.relay_bytes", rows=sched.relay_rows() * int(row_bytes))
        annotate_add(relay_bytes=sched.relay_rows() * int(row_bytes))
    st["new_counts"] = st["send_counts"].sum(axis=0).astype(np.int64)
    bump("shuffle.rounds", rows=k)

    # the tier: choose_tier's; a caller-owned sink takes at least tier 1
    # (the rows' destination is the host)
    spec = st["spec"]
    staged = int(st["new_counts"].max()) * row_bytes
    # the re-coster may promote the tier before the budget line from the
    # staged bytes it observed (never below the measured decision)
    tier = _spill.choose_tier(staged, tuned=_feedback.tuned_spill_tier())
    if spec.sink is not None and tier == _spill.TIER_HBM:
        tier = _spill.TIER_HOST
    # the relay under two hops: same-outer-group tails ride the device
    # ring, cross-outer tails keep the host relay. Only at tier 0 with
    # plain lanes: a q8 relay and a spilled shuffle keep the whole host
    # relay (their rows cross the host anyway)
    st["ring"], st["relay_host"] = None, sched.relay
    if sched.adaptive and tp is not None:
        intra_m, inter_m = _topo.split_relay(sched.relay, tcfg)
        if intra_m is not None and tier == _spill.TIER_HBM and st["relay_qsig"] is None:
            cap_ri = _topo.ring_cap(intra_m)
            st["ring"], st["relay_host"] = (intra_m, cap_ri), inter_m
            bump("shuffle.relay.ring_rows", rows=int(intra_m.sum()))
            ring_b = _topo.ring_bytes(tcfg, cap_ri, int(row_bytes))
            bump("shuffle.coll_bytes.intra", rows=ring_b)
            annotate_add(coll_bytes_intra=ring_b)
    st["sink"], st["stage_qsig"] = None, None
    if tier != _spill.TIER_HBM:
        bump("shuffle.spill.shuffles")
        gauge("shuffle.spill.tier", tier)
    if tier != _spill.TIER_HBM and spec.sink is not None:
        st["sink"] = _spill.CallerSink(spec.sink, st["t"])
    elif tier != _spill.TIER_HBM:
        qsig, names = st["relay_qsig"], st["t"].column_names
        st["stage_qsig"] = qsig
        quant_map, schema = {}, []
        for ci, (dt, _nl, has_valid) in enumerate(st["plan"]):
            ndt = numpy_dtype(dt)
            if qsig is not None and qsig[ci] == "q8":
                quant_map[ci], ndt = ndt, np.dtype(np.uint8)
            schema.append((names[ci], ndt, has_valid))
        st["sink"] = _spill.ShardArenaSink(
            w, schema, _spill.TIER_DISK if tier == _spill.TIER_DISK else _spill.TIER_HOST,
            quant=quant_map or None)
    staged_rounds = k if tier == _spill.TIER_HBM else min(k, 2)
    relay = st["relay_host"]
    relay_out = int(relay.sum(axis=1).max()) if relay is not None else 0
    # a round's send buffer and hop-1 (or flat) receive buffer; under two
    # hops its hop-2 send buffer, with its spare rows, and receive buffer;
    # then the staged outputs, the host relay's extraction and the ring's
    # buffers (every step of the rotation stays until the absorb)
    two_hop_rows = 2 * tp.outer * (tp.cap_o + nh) + _sh.DROP_ROWS if tp is not None else 0
    ring_rows = tcfg.inner * st["ring"][1] if st["ring"] is not None else 0
    peak_rows = (int(st["t"]._counts.max()) + 2 * w * (bc + nh) + _sh.DROP_ROWS + two_hop_rows
                 + staged_rounds * recv_cap + relay_out + ring_rows)
    st["dev_peak_bytes"] = peak_rows * row_bytes
    if spec.sink is not None:
        spec.sink.device_rows_peak = max(getattr(spec.sink, "device_rows_peak", 0), peak_rows)
    # this shuffle's planning inputs and decisions for the observation
    # store (host dict work, only under an active exec record)
    if _obsstore.recording():
        m = np.asarray(st["send_counts"], np.int64)
        _obsstore.note_shuffle(
            world=w, row_bytes=int(row_bytes), hot=int(m.max()) if m.size else 0,
            mean_bucket=-(-int(m.sum()) // max(m.size, 1)),
            staged=int(staged),
            tier=int(tier), rounds=int(k),
            coll=coll_bytes,
            budget=budget, static_budget=int(st["ctx"].shuffle_byte_budget),
            wire=st["wire"] is not None, relay=sched.adaptive,
            topo=tuple(tcfg) if tcfg is not None else None, hop2=tp is not None,
            intra=intra_b, inter=inter_b, inter_alt=int(inter_alt),
        )


def _send_rows(st: dict, s: int) -> dict:
    """Shard ``s``'s send state under the decided plan: its row-major lane
    matrix (the wire-narrowed words, float64 columns as two lanes behind
    them, or the plain lanes; None under a q8 plan, whose words are
    encoded per round under that round's chunk scales) and the pid lane,
    tile bases and bucket totals B2b and the rounds read."""
    sh = st["shards"][s]
    packed = None
    if not wire_q8_cols(st["wire"]):
        packed = _sh.send_lanes(st["flat"][s], st["wire"], st["bases"])
    lane, hist = (sh["lane_f"], sh["hist_f"]) if st["use_filter"] else (sh["lane"], sh["hist"])
    return {"packed": packed, "lane": lane, "base": _codec.scan_tiles(hist),
            "cnt": hist.sum(1, dtype=torch.int32)}


def _received_cols(st: dict, moved: torch.Tensor) -> List[KeyCol]:
    """The columns of the received rows, a front-packed ``[rows, LM]``
    lane matrix of :func:`_send_rows`' layout (plus each row's q8 scale
    lanes under a quantized plan)."""
    return _sh.received_cols(st["ref"], st["wire"], st["bases"], moved)


def _shuffle_many(specs: Sequence[_ShuffleSpec]) -> List[Optional[Table]]:
    """The chunked shuffle engine (every Distributed* op funnels through
    here), the JAX package's phases with its two host syncs:

    1. COUNT: kernel B2a per source shard (twice for a semi-filtered one:
       hash mode, then pid mode with the pruned rows at P), and the stat
       words of every statable column; ONE fetch per table of this
       process's rows of the [W, W] send-count matrices and the words,
       gathered from every rank, so that every rank plans alike;
    2. PLAN (:func:`_plan_state`): the semi-filter gate, the schedule
       (``spill.plan_schedule``: ``bucket_cap``, K rounds and, for skewed
       counts, the relay matrix), the wire gate, the spill tier and the
       analytic peak device bytes;
    3. RELAY (a skewed schedule only): each source's rows past the quota
       of a heavy bucket are extracted once (``spill.relay_extract``) and
       start for the host before round 0, so the copy overlaps the rounds;
       under two hops at tier 0 the same-group tails ride the device ring
       instead (``topo.ring_extract``, ``topo.ring_relay``);
    4. K ROUNDS of PACK (kernel B2b + the header-fused lane scatter),
       COLLECTIVE (one all_to_all; under a 2-D topology the inner and the
       outer grouped all_to_alls of ``topo.two_hop_exchange``), COMPACT
       (kernel B3; under two hops once on the same-group rows and once on
       the combined chunks), with no host sync; each round keeps its live
       rows, whose count the plan already knows. Under tier 1 or 2 round r's output is decoded, packed and
       copied to the host once round r+1 is dispatched, and lands in the
       arenas before round r+2 is, so at most two staged outputs are ever
       on the device;
    5. ONE deferred fetch per table of every round's received counts,
       gathered from every rank and checked against the plan on every
       rank (a mismatch is an internal routing bug, raised everywhere);
       then the result: each shard's rounds in round order, then the rows
       relayed to it in source order (``spill.fetch_relay``: regrouped on
       the host by the communicator), then the ring's rows in step order,
       or the arenas rebuilt on the device
       (``spill.arena_result``) when spilled. A spec with a caller-owned
       ``sink`` gets no table (None): its staged rounds and relayed rows
       went to ``sink.accept(table, shard_cols, counts)``.

    Failure domain: any exception of phases 3-5 closes every arena the
    engine owns (a caller's sink is the caller's to close), and a raw
    ``OSError`` leaves as ``SpillIOError``.
    """
    states = []
    for spec in specs:
        with span("shuffle.count", rows=int(spec.table._counts.sum())):
            st = _shuffle_state(spec)
            _count_phase(st)
        states.append(st)
    for st in states:
        _plan_state(st)
        st["send"] = {s: _send_rows(st, s) for s in st["local"]}
        st["rounds_out"] = {s: [] for s in st["local"]}
        st["recv"] = []
        st["prev"] = st["pending"] = None
    gauge("shuffle.spill.peak_device_bytes", sum(st["dev_peak_bytes"] for st in states))
    try:
        return _shuffle_many_rounds(states)
    except BaseException as e:
        for st in states:
            if st["sink"] is not None:
                st["sink"].close()
        if isinstance(e, OSError) and not isinstance(e, CylonError):
            raise SpillIOError("spilled shuffle failed", e) from e
        raise


def _stage_round(st: dict) -> None:
    """Tier 1/2: land the round whose copy is in flight, then start the copy
    of the round kept in ``st["prev"]`` (its received lane matrices)."""
    if st["pending"] is not None:
        st["pending"].land()
        st["pending"] = None
    if st["prev"] is not None:
        moved, expect = st["prev"]
        st["prev"] = None
        cols = {d: _received_cols(st, m) for d, m in moved.items()}
        st["pending"] = _spill.stage_table(st["sink"], st["plan"], cols, expect, st["row_bytes"],
                                           qspec=st["stage_qsig"])


def _shuffle_many_rounds(states: List[dict]) -> List[Optional[Table]]:
    """Phases 3-5 of :func:`_shuffle_many` under the ``shuffle.exchange``
    span: the relay extraction (and the ring under two hops), the round
    loop (``shuffle.round.pack`` / ``.collective`` / ``.compact`` a table
    and round), the deferred fetch and the result. With the profiler on,
    the stage clocks (obs/prof.py) take the window between two CUDA events
    around the rounds (the deferred read passes the later one) or, on the
    CPU, the host window."""
    with span("shuffle.exchange", rows=sum(int(st["t"]._counts.sum()) for st in states)):
        return _exchange_rounds(states)


def _exchange_rounds(states: List[dict]) -> List[Optional[Table]]:
    t0 = _time.perf_counter()
    ev0 = _obstrace.device_event() if _prof.profiling_active() else None
    for st in states:
        sched = st["sched"]
        st["relay_copies"] = st["ring_out"] = None
        if st["ring"] is not None:  # same-group tails: the device ring
            intra_m, cap_ri = st["ring"]
            with span("shuffle.round.relay_ring", rows=int(intra_m.sum())):
                bufs = [_topo.ring_extract(st["flat"][s], st["send"][s]["lane"],
                                           st["send"][s]["base"], intra_m[s], sched.quota, cap_ri)
                        for s in st["local"]]
                st["ring_out"] = _topo.ring_relay(st["ctx"].comm, bufs, st["local"],
                                                  st["topo_cfg"], intra_m.sum(axis=0))
        if st["relay_host"] is not None:
            with span("shuffle.round.relay", rows=int(st["relay_host"].sum())):
                st["relay_copies"] = {
                    s: _spill.relay_extract(st["flat"][s], st["send"][s]["lane"],
                                            st["send"][s]["base"], st["relay_host"][s], sched.quota,
                                            qspec=st["relay_qsig"])
                    for s in st["local"]
                }

    for r in range(max(st["n_rounds"] for st in states)):
        for st in states:
            if r >= st["n_rounds"]:
                continue
            spilled = st["sink"] is not None
            if spilled and st["pending"] is not None:
                st["pending"].land()  # round r-2 leaves the device
                st["pending"] = None
            w, bc, wplan, tp = st["world"], st["bucket_cap"], st["wire"], st["topo_plan"]
            nh = _sh.wire_header_rows(wplan) if wplan is not None else _sh.HEADER_ROWS
            dev0, local = st["ctx"].device, st["local"]
            t_pk0 = _time.perf_counter()
            bufs = []
            with span("shuffle.round.pack"):
                for s in local:
                    sh = st["send"][s]
                    dest = _codec.pack_dest(sh["lane"], sh["base"], r, w, bc)
                    rc = _sh.round_counts(sh["cnt"], bc, r)
                    packed, hx = sh["packed"], None
                    if packed is None:  # q8 fields: this round's chunk scales
                        packed, hx = _sh.round_send(st["flat"][s], wplan, st["bases"], dest, w, bc)
                    bufs.append(_sh.pack_lane_buffer(packed, dest, rc, w, bc, header_extra=hx,
                                                     n_header=nh))
            t_pk1 = _time.perf_counter()
            expect = _expected_received(st["send_counts"], bc, r)
            fresh = {}
            if tp is None:
                with span("shuffle.round.collective"):
                    got = _sh.exchange_buffer(st["ctx"].comm, bufs)
                t_cp0 = _time.perf_counter()
                with span("shuffle.round.compact"):
                    for d, g in zip(local, got):
                        recv = _sh.header_counts(g, w)
                        moved = _codec.compact_move(_sh.with_scale_lanes(g, wplan, w, nh), recv,
                                                    w, bc, n_header=nh)
                        fresh[d] = [moved[: int(expect[d])]]
                        st["recv"].append(recv.to(dev0, copy=True))
            else:
                # two hops; B3 front-packs the same-group rows (final after
                # hop 1), then the combined cross-outer chunks: the JAX
                # package's one compaction over their concatenation
                topo = st["topo_cfg"]
                n_self, n_cross = _topo.round_split(st["send_counts"], topo, bc, r)
                with span("shuffle.round.collective"):
                    got = _topo.two_hop_exchange(st["ctx"].comm, bufs, local, topo, bc, tp.cap_o,
                                                 nh)
                t_cp0 = _time.perf_counter()
                with span("shuffle.round.compact"):
                    for d, (g2, self_rows, self_cnt) in zip(local, got):
                        recv2 = _sh.header_counts(g2, tp.outer)
                        m1 = _codec.compact_move(self_rows, self_cnt, tp.inner, bc, n_header=0)
                        m2 = _codec.compact_move(g2, recv2, tp.outer, tp.cap_o, n_header=nh)
                        fresh[d] = [m1[: int(n_self[d])], m2[: int(n_cross[d])]]
                        st["recv"].append(torch.cat([self_cnt, recv2]).to(dev0))
            # the codec's evidence for the observation store: pack and
            # compact host walls and their row passes (B2a + B2b, B3)
            if _obsstore.recording():
                rows_in = sum(int(st["send_counts"][s].sum()) for s in local)
                _obsstore.note_codec("cuda" if dev0.type == "cuda" else "plain",
                                     (t_pk1 - t_pk0) + (_time.perf_counter() - t_cp0),
                                     2 * rows_in + int(sum(int(expect[d]) for d in local)), 0)
            if spilled:
                st["fresh"] = ({d: p[0] if len(p) == 1 else torch.cat(p) for d, p in fresh.items()},
                               expect)
            else:
                for d, parts in fresh.items():
                    st["rounds_out"][d].extend(parts)
        # after every table's round-r dispatch: round r-1 starts for the host
        for st in states:
            fresh = st.pop("fresh", None)
            if fresh is not None:
                _stage_round(st)
                st["prev"] = fresh

    t_disp = _time.perf_counter()
    ev1 = _obstrace.device_event() if ev0 is not None else None
    t_dev = None
    results = []
    for st in states:
        w, bc, k, local = st["world"], st["bucket_cap"], st["n_rounds"], st["local"]
        bump("host_sync")
        # the deferred sync: every round's received counts per local shard
        # ([W] by source flat, [inner + outer] by hop under two hops) and the
        # ring's absorbed rows, in one fetch
        mine = torch.stack(st["recv"]).view(k, len(local), -1).transpose(0, 1).reshape(len(local), -1)
        if st["ring_out"] is not None:
            mine = torch.cat([mine, torch.stack([n.to(mine.device) for _r, n in st["ring_out"]])
                              .view(-1, 1).to(mine.dtype)], 1)
        got_all = st["ctx"].comm.all_gather_counts(mine.cpu().numpy())  # [dst, ...]
        t_dev = t_dev or _time.perf_counter()  # the first read: every round has landed
        width = (got_all.shape[1] - (st["ring_out"] is not None)) // k
        expect_all = [_expected_received(st["send_counts"], bc, r) for r in range(k)]
        for r, expect in enumerate(expect_all):
            got = got_all[:, r * width:(r + 1) * width].sum(axis=1)
            if not (got == expect).all():
                raise RuntimeError(
                    f"shuffle round {r}: received row counts {got} != "
                    f"expected {expect}: internal routing bug"
                )
        if st["ring_out"] is not None:
            expect_ring = st["ring"][0].sum(axis=0).astype(np.int64)
            if not (got_all[:, -1] == expect_ring).all():
                raise RuntimeError(
                    f"shuffle relay ring: absorbed row counts {got_all[:, -1]} != "
                    f"expected {expect_ring}: internal routing bug"
                )
        t = st["t"]
        spilled = st["sink"] is not None
        if spilled:  # flush the staging window
            _stage_round(st)
            _stage_round(st)
        per_dst = None
        if st["relay_copies"] is not None:
            per_dst, rcounts = _spill.fetch_relay(
                st["ctx"].comm, st["plan"], st["relay_copies"], st["relay_host"], local,
                qspec=st["relay_qsig"])
            st["relay_copies"] = None
            if spilled:
                st["sink"].accept(per_dst, rcounts)
        if spilled and st["spec"].sink is not None:
            st["sink"] = None  # the rows live in the caller's sink
            results.append(None)
            continue
        if spilled:
            res = _spill.arena_result(st["sink"], t, counts=st["new_counts"])
            st["sink"] = None
            res = t._with_shards(res._shards, res._counts)
        else:
            def received(d, st=st, t=t):
                parts = st["rounds_out"][d]
                moved = parts[0] if len(parts) == 1 else torch.cat(parts)
                return _shard_of(t, d, _received_cols(st, moved))

            res = t._with_shards(_per_shard(st["ctx"], received), sum(expect_all))
            # the JAX package's order: the rounds, the host relay, the ring
            parts = [res]
            if per_dst is not None:
                parts.append(_spill.shards_to_table(t, per_dst, rcounts))
            if st["ring_out"] is not None:
                ring = dict(zip(local, st["ring_out"]))
                parts.append(t._with_shards(
                    _per_shard(st["ctx"], lambda d, t=t: _shard_of(
                        t, d, _sh.compact_received_lanes(st["plan"], ring[d][0]))),
                    expect_ring))
                st["ring_out"] = None
            if len(parts) > 1:
                res = _concat_tables(parts)
        # the shuffle moves rows, not values: the measured bounds hold
        names = t.column_names
        results.append(res._attach_stats({names[ci]: v for ci, v in st["col_stats"].items()}))
    # the overlap ledger: the share of the window (open to the deferred
    # read's return) spent issuing the rounds
    t_dev = t_dev or t_disp
    gauge("shuffle.overlap_efficiency", min(max(t_disp - t0, 0.0) / max(t_dev - t0, 1e-9), 1.0))
    # per-stage per-shard stage clocks (obs/prof.py): host arithmetic over
    # the count matrices and the window; the read above passed ev1
    _prof.record_shuffle(
        [(st["send_counts"], st["n_rounds"], st["bucket_cap"], st["sched"].relay,
          None if st["topo_plan"] is None else
          (st["topo_plan"].outer, st["topo_plan"].inner, st["topo_plan"].cap_o))
         for st in states],
        states[0]["world"], t0, t_dev, (ev0, ev1),
    )
    return results


def _shard_of(t: Table, d: int, cols: List[KeyCol]) -> Shard:
    """Shard d of ``t``'s schema holding the physical columns ``cols``."""
    out: Shard = OrderedDict()
    for (name, c), (data, valid) in zip(t._shards[d].items(), cols):
        out[name] = Column(data, c.dtype, valid, c.dictionary)
    return out


def _expected_received(send_counts: np.ndarray, bucket_cap: int, round_idx: int) -> np.ndarray:
    """Rows each shard receives in a round, from the count phase's matrix."""
    return np.clip(send_counts - round_idx * bucket_cap, 0, bucket_cap).sum(axis=0)


def _pair_sketches(
    a: Table, a_keys: Sequence[str], b: Table, b_keys: Sequence[str], sides: str,
    force: bool = False,
) -> Optional[dict]:
    """The combined semi-join key sketches of a shuffle pair
    (ops/sketch.py): each side named in ``sides`` ('both'/'a'/'b', the
    tables that get FILTERED) needs the OTHER side's sketch. Every needed
    local sketch rides ONE ``comm.all_gather``.

    None where the filter is not sound or not worth it: a paired key's
    hashing family differs across the sides (the local op may equate
    values the sketches hash apart), or the prunable payload is under
    ``SEMI_FILTER_MIN_PAYOFF`` times the sketch collective's bytes. The
    range words engage only where both first keys share an exact
    monotone-uint32 class (dictionary codes qualify)."""
    from .config import SEMI_FILTER_MIN_PAYOFF

    ctx = a.ctx
    world = ctx.world_size
    for an, bn in zip(a_keys, b_keys):
        ca, cb = a._ref[an], b._ref[bn]
        if ca.dtype.is_dictionary != cb.dtype.is_dictionary:
            return None
        ha, hb = _sketch.hash_class(ca.data.dtype), _sketch.hash_class(cb.data.dtype)
        if ha is None or ha != hb:
            return None
    ra = _sketch.range_class(a._ref[a_keys[0]].data.dtype)
    rb = _sketch.range_class(b._ref[b_keys[0]].data.dtype)
    use_range = ra is not None and ra == rb
    build = []
    if sides in ("both", "b"):
        build.append(("a", a, tuple(a_keys)))  # a's sketch: b probes it
    if sides in ("both", "a"):
        build.append(("b", b, tuple(b_keys)))  # b's sketch: a probes it
    if not build:
        return None
    bits = max(_sketch.sketch_bits_for(t.row_count, ctx.sketch_bits) for _, t, _k in build)
    wire = len(build) * _sketch.sketch_len(bits) * 4
    # per-shard basis on both sides: a shard ships rows / world of payload
    # but injects its whole local sketch
    prunable = 0
    if sides in ("both", "a"):
        prunable += a.row_count * _sh.exchange_row_bytes(a._flat_cols(a.ctx.local_shards[0]))
    if sides in ("both", "b"):
        prunable += b.row_count * _sh.exchange_row_bytes(b._flat_cols(b.ctx.local_shards[0]))
    prunable //= max(world, 1)
    if not force and prunable < SEMI_FILTER_MIN_PAYOFF * wire:
        _obsstore.note_semi(payoff_skip=True)
        return None
    with span("shuffle.semi_filter.sketch", rows=wire):
        hashes = {name: {s: _sketch.key_hashes(t._flat_cols(s, list(keys))) for s in ctx.local_shards}
                  for name, t, keys in build}
        local = [
            torch.stack([_sketch.build_local(t._flat_cols(s, list(keys)), bits, use_range,
                                             hashes[name][s])
                         for name, t, keys in build])
            for s in ctx.local_shards
        ]
        combined = _sketch.combine_pair(local, ctx.comm)
    bump("semi_filter.sketch_bytes", rows=wire)
    annotate_add(coll_bytes=int(wire), sketch_bytes=int(wire))
    row_of = {name: i for i, (name, _t, _k) in enumerate(build)}
    probe = {}
    if sides in ("both", "a"):
        probe["a"] = row_of["b"]
    if sides in ("both", "b"):
        probe["b"] = row_of["a"]
    return dict(sketch=dict(zip(ctx.local_shards, combined)), probe=probe, use_range=use_range,
                hashes=hashes)


def _shuffle_pair(
    a: Table, a_keys: Sequence[str], b: Table, b_keys: Sequence[str],
    byte_budget: Optional[int] = None, semi: Optional[str] = None,
) -> Tuple[Table, Table]:
    """Hash-shuffle the two sides of a join or set op in one engine call.

    ``semi`` ('both'/'a'/'b', ops/sketch.join_filter_sides) engages the
    semi-join sketch filter: the named sides' rows are probed against the
    other side's sketch in the count phase, and provably partnerless rows
    never enter the exchange. The output equals the unfiltered shuffle's
    (CYLON_TPU_TORCH_NO_SEMI_FILTER=1 turns it off)."""
    from .plan import feedback as _feedback

    sa = _ShuffleSpec(a, tuple(a_keys), byte_budget)
    sb = _ShuffleSpec(b, tuple(b_keys), byte_budget)
    # the re-coster's semi decision (None outside a plan execution or with
    # autotune off): "off" skips even the sketch, the observed selectivity
    # too high to repay its collective; "on" and "explore" build it past
    # the static size gate ("explore": measure, then decide)
    mode = _feedback.tuned_semi_mode()
    if semi is not None and a.world_size > 1 and mode == "off":
        bump("autotune.semi_skipped")
    if semi is not None and a.world_size > 1 and _sketch.enabled() and mode != "off":
        if mode in ("on", "explore"):
            bump("autotune.semi_forced")
        got = _pair_sketches(a, a_keys, b, b_keys, semi, force=mode in ("on", "explore"))
        if got is not None:
            if "a" in got["probe"]:
                sa = sa._replace(sketch=got["sketch"], probe_row=got["probe"]["a"],
                                 use_range=got["use_range"], key_hashes=got["hashes"].get("a"))
            if "b" in got["probe"]:
                sb = sb._replace(sketch=got["sketch"], probe_row=got["probe"]["b"],
                                 use_range=got["use_range"], key_hashes=got["hashes"].get("b"))
    out = _shuffle_many([sa, sb])
    return out[0], out[1]
