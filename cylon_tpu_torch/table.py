"""Table of the PyTorch port (counterpart of cylon_tpu/table.py): the
join -> groupby main path over W shards, with the chunked hash shuffle
between them.

A table is W shards of exact-length columns, shard s on the context's
``devices[s]``: no padding rows, no shard capacities. A column's dtype,
dictionary and whether it has a validity mask are the same in every
shard. Rows loaded from the host split into contiguous blocks
(``engine.shard_caps``), as in the JAX package, and every host read
concatenates the shards in order.
``join`` and ``groupby`` are per-shard local ops; ``distributed_join`` and
``distributed_groupby`` hash-shuffle first (``_shuffle_many``) and are the
local ops when the world is one device, as there.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .column import Column, unify_dictionaries
from .context import CylonContext
from .dtypes import DataType, numpy_dtype, promote_key_dtypes
from .engine import shard_caps
from .ops import cuda_codec as _codec
from .ops import groupby as _g
from .ops import join as _j
from .ops.gather import KeyCol, lane_plan, pack_cols, pack_gather
from .ops.hash import hash_dictionary_host
from .parallel import shuffle as _sh

Encoded = Tuple[np.ndarray, Optional[np.ndarray], Any, Optional[np.ndarray]]
Shard = "OrderedDict[str, Column]"


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md: {item})")


class Table:
    def __init__(self, ctx: CylonContext, shards: Sequence[Shard], counts: Sequence[int]):
        if len(shards) != ctx.world_size or len(counts) != ctx.world_size:
            raise ValueError(f"a table of this context has {ctx.world_size} shards")
        self.ctx = ctx
        self._shards: List[Shard] = list(shards)
        self._counts = np.asarray(counts, np.int64)

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    @classmethod
    def from_encoded(cls, ctx: CylonContext, encoded: Dict[str, Encoded]) -> "Table":
        """Build a table from host columns already encoded as
        ``Column.encode_host`` returns them, by this package or the JAX
        package: (physical data, valid | None, logical type, sorted
        dictionary | None) per column. Shard s takes the s-th contiguous
        block of rows."""
        n = len(next(iter(encoded.values()))[0]) if encoded else 0
        for phys, *_rest in encoded.values():
            if len(phys) != n:
                raise ValueError("all columns must have equal length")
        counts, _cap = shard_caps(n, ctx.world_size)
        offs = np.concatenate([[0], np.cumsum(counts)])
        shards = []
        for s, device in enumerate(ctx.devices):
            lo, hi = int(offs[s]), int(offs[s + 1])
            cols: Shard = OrderedDict()
            for name, (phys, valid, dtype, dictionary) in encoded.items():
                dt = DataType.of(dtype)
                # a private host copy: the table never aliases the caller's array
                data = torch.from_numpy(np.array(phys[lo:hi], dtype=dt.physical_dtype)).to(device)
                v = None
                if valid is not None:
                    v = torch.from_numpy(np.array(valid[lo:hi], dtype=bool)).to(device)
                cols[name] = Column(data, dt, v, dictionary)
            shards.append(cols)
        return cls(ctx, shards, counts)

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

    def _with_shards(self, shards: Sequence[Shard]) -> "Table":
        return Table(self.ctx, shards, self._counts)

    # ------------------------------------------------------------------
    # properties and host conversion
    # ------------------------------------------------------------------
    @property
    def world_size(self) -> int:
        return self.ctx.world_size

    @property
    def column_names(self) -> List[str]:
        return list(self._shards[0].keys())

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
        shard 0's device (a copy)."""
        if self.world_size == 1:
            return self._shards[0][name]
        parts = [sh[name] for sh in self._shards]
        dev = self.ctx.device
        data = torch.cat([c.data.to(dev) for c in parts])
        valid = None if parts[0].valid is None else torch.cat([c.valid.to(dev) for c in parts])
        return Column(data, parts[0].dtype, valid, parts[0].dictionary)

    def _host_physical_shard(self, name: str, shard: int):
        """One shard's rows in physical encoding: (data, valid | None)."""
        col = self._shards[shard][name]
        data = col.data.cpu().numpy()
        return data, None if col.valid is None else col.valid.cpu().numpy()

    def _host_column(self, name: str):
        parts = [self._host_physical_shard(name, s) for s in range(self.world_size)]
        data = np.concatenate([d for d, _v in parts])
        valid = None if parts[0][1] is None else np.concatenate([v for _d, v in parts])
        return self._shards[0][name].decode_host(data, valid)

    def to_pydict(self) -> Dict[str, np.ndarray]:
        return {name: self._host_column(name) for name in self.column_names}

    def to_pandas(self):
        import pandas as pd

        return pd.DataFrame(self.to_pydict())

    def rename(self, mapping: Union[Dict[str, str], Sequence[str]]) -> "Table":
        if isinstance(mapping, dict):
            new_names = [mapping.get(n, n) for n in self.column_names]
        else:
            new_names = list(mapping)
        return self._with_shards(
            [OrderedDict(zip(new_names, sh.values())) for sh in self._shards]
        )

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
        out: List[List[KeyCol]] = [[] for _ in self._shards]
        for n in key_names:
            c0 = self._shards[0][n]
            hh = None
            if c0.dtype.is_dictionary:
                hh = torch.from_numpy(hash_dictionary_host(c0.dictionary).astype(np.int64))
            for s, sh in enumerate(self._shards):
                c = sh[n]
                if hh is None:
                    out[s].append((c.data, c.valid))
                elif len(hh) == 0:
                    out[s].append((torch.zeros_like(c.data, dtype=torch.int64), c.valid))
                else:
                    h = hh.to(c.data.device)
                    out[s].append((h[c.data.clamp(0, len(hh) - 1).to(torch.int64)], c.valid))
        return out

    def _shuffle_impl(self, key_names: Sequence[str], byte_budget: Optional[int] = None) -> "Table":
        return _shuffle_many([_ShuffleSpec(self, tuple(key_names), byte_budget)])[0]

    # ------------------------------------------------------------------
    # join
    # ------------------------------------------------------------------
    def _resolve_cols(self, spec) -> List[str]:
        if isinstance(spec, (str, int)):
            spec = [spec]
        names = [self.column_names[s] if isinstance(s, int) else s for s in spec]
        missing = [n for n in names if n not in self._shards[0]]
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
        emit_order: str = "left",
    ) -> "Table":
        """Per-shard (local) equi-join, all four types; output rows in
        left-row order (pandas merge order), left columns then right
        columns, suffixes on name collisions."""
        _check_join_args(algorithm, emit_order)
        if other.ctx.devices != self.ctx.devices:
            raise ValueError("join of tables on different devices")
        howi = _j.join_type_id(how)
        l_names, r_names = self._resolve_join_keys(other, on, left_on, right_on)
        left, right = _unify_dict_pair(self, other, l_names, r_names)
        out_names = _suffix_names(left.column_names, right.column_names, suffixes)
        shards, counts = [], []
        for s in range(self.world_size):
            out, total = _j.spec_join(
                left._flat_cols(s, l_names), right._flat_cols(s, r_names),
                left._flat_cols(s), right._flat_cols(s), howi,
            )
            src = list(left._shards[s].values()) + list(right._shards[s].values())
            cols: Shard = OrderedDict()
            for name, c, (d, v) in zip(out_names, src, out):
                cols[name] = Column(d, c.dtype, v, c.dictionary)
            shards.append(cols)
            counts.append(total)
        return Table(self.ctx, shards, counts)

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
        the local join per shard. One device: the local join."""
        if mode == "fused":
            raise _not_ported("mode='fused'", "queue A, the fused shuffle->join program")
        if mode != "eager":
            raise ValueError(f"unknown join mode {mode!r}")
        if on is not None:
            kwargs["on"] = on
        kwargs.setdefault("how", how)
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
        ls, rs = _shuffle_pair(left, l_names, right, r_names)
        return ls.join(rs, **kwargs)

    # ------------------------------------------------------------------
    # groupby
    # ------------------------------------------------------------------
    def groupby(
        self,
        by: Union[str, int, Sequence[Union[str, int]]],
        agg: Dict[str, Union[str, int, Sequence[Union[str, int]]]],
    ) -> "Table":
        """Per-shard groupby-aggregate: the key columns in sorted key order,
        then one column ``<col>_<op>`` per (column, op), op in
        sum/count/min/max/mean."""
        key_names = self._resolve_cols(by)
        specs: List[Tuple[str, int, str]] = []
        for col, ops in agg.items():
            self._resolve_cols(col)
            for o in ops if isinstance(ops, (list, tuple)) else [ops]:
                oid = _g.agg_op_id(o)
                specs.append((col, oid, o if isinstance(o, str) else _agg_name(oid)))
        shards, counts = [], []
        for s, sh in enumerate(self._shards):
            keys = self._flat_cols(s, key_names)
            ids, ng = _g.group_ids(keys)
            rep = _g.group_representatives(ids, ng)
            key_out = pack_gather(keys, rep, all_valid=True)
            cols: Shard = OrderedDict()
            for n, (d, v) in zip(key_names, key_out):
                cols[n] = Column(d, sh[n].dtype, v, sh[n].dictionary)
            for col, oid, oname in specs:
                a, av = _g.aggregate_column(oid, sh[col].data, sh[col].valid, ids, ng)
                cols[f"{col}_{oname}"] = Column(
                    a, DataType.from_numpy_dtype(numpy_dtype(a.dtype)), av, None
                )
            shards.append(cols)
            counts.append(ng)
        return Table(self.ctx, shards, counts)

    def distributed_groupby(
        self,
        by: Union[str, int, Sequence[Union[str, int]]],
        agg: Dict[str, Union[str, Sequence[str]]],
        **kw,
    ) -> "Table":
        """Distributed groupby: a local pre-combine when every op is
        associative (sum/min/max), a hash shuffle on the keys, the final
        local groupby. One device: the local groupby."""
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

    def __repr__(self):
        return (
            f"Table(rows={self.row_count}, columns={self.column_names}, "
            f"world_size={self.world_size})"
        )


def _check_join_args(algorithm: str, emit_order: str) -> None:
    if algorithm == "pallas_pk":
        raise _not_ported("algorithm='pallas_pk'", "queue B, kernel B5")
    if algorithm not in ("sort", "hash"):
        raise ValueError(f"unknown join algorithm {algorithm!r}")
    if emit_order == "key":
        raise _not_ported("emit_order='key'", "queue A, key-order join emit")
    if emit_order != "left":
        raise ValueError(f"unknown emit_order {emit_order!r}")


def _suffix_names(lnames, rnames, suffixes):
    overlap = set(lnames) & set(rnames)
    out = [n + suffixes[0] if n in overlap else n for n in lnames]
    out += [n + suffixes[1] if n in overlap else n for n in rnames]
    return out


def _agg_name(oid: int) -> str:
    return {
        _g.SUM: "sum", _g.COUNT: "count", _g.MIN: "min", _g.MAX: "max",
        _g.MEAN: "mean",
    }[oid]


def _remap_codes(col: Column, mapping: np.ndarray, dictionary: np.ndarray) -> Column:
    if col.length == 0:
        return Column(col.data, col.dtype, col.valid, dictionary)
    m = torch.from_numpy(mapping).to(col.data.device)
    data = m.index_select(0, col.data.clamp(0, len(mapping) - 1))
    return Column(data, col.dtype, col.valid, dictionary)


def _unify_dict_pair(
    a: Table, b: Table, a_cols: Sequence[str], b_cols: Sequence[str]
) -> Tuple[Table, Table]:
    """Remap the dictionary codes of paired string key columns onto their
    union dictionary, so codes compare across the two tables."""
    new_a = [OrderedDict(sh) for sh in a._shards]
    new_b = [OrderedDict(sh) for sh in b._shards]
    changed = False
    for an, bn in zip(a_cols, b_cols):
        ca, cb = a._shards[0][an], b._shards[0][bn]
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
        for sh in new_a:
            sh[an] = _remap_codes(sh[an], map_a, union)
        for sh in new_b:
            sh[bn] = _remap_codes(sh[bn], map_b, union)
        changed = True
    if not changed:
        return a, b
    return a._with_shards(new_a), b._with_shards(new_b)


def _promote_key_pair(
    a: Table, b: Table, a_cols: Sequence[str], b_cols: Sequence[str]
) -> Tuple[Table, Table]:
    """Cast paired numeric key columns to their common promoted dtype (numpy
    rules) so both sides hash and compare identically."""
    new_a = [OrderedDict(sh) for sh in a._shards]
    new_b = [OrderedDict(sh) for sh in b._shards]
    changed = False
    for an, bn in zip(a_cols, b_cols):
        ca, cb = a._shards[0][an], b._shards[0][bn]
        if ca.dtype.is_dictionary or cb.dtype.is_dictionary:
            continue  # mixed string/numeric pairs are rejected by _unify_dict_pair
        if ca.data.dtype == cb.data.dtype:
            continue
        common = promote_key_dtypes(ca.data.dtype, cb.data.dtype)
        dt = DataType.from_numpy_dtype(numpy_dtype(common))
        for shards, name in ((new_a, an), (new_b, bn)):
            for sh in shards:
                c = sh[name]
                sh[name] = Column(c.data.to(common), dt, c.valid, None)
        changed = True
    if not changed:
        return a, b
    return a._with_shards(new_a), b._with_shards(new_b)


# ----------------------------------------------------------------------
# the chunked shuffle engine
# ----------------------------------------------------------------------

class _ShuffleSpec(NamedTuple):
    """One table of a shuffle: its hash keys and the per-round byte budget
    (None: the context's). The port has the hash kind only."""

    table: Table
    key_names: Tuple[str, ...]
    byte_budget: Optional[int] = None


def _shuffle_state(spec: _ShuffleSpec) -> dict:
    """Per-table state: the lane plan, and per source shard the row-major
    lanes, the partition-id lane of kernel B2a, each tile's first position
    within each bucket (the scan of B2a's histogram, for B2b) and the
    bucket totals (the send counts)."""
    t = spec.table
    world = t.world_size
    if not t.column_names:
        raise ValueError("cannot shuffle a table without columns")
    khash = t._key_hash_cols(spec.key_names)
    flat = [t._flat_cols(s) for s in range(world)]
    shards = []
    for s in range(world):
        words, valids, has_valid = _codec.key_words(khash[s])
        lane, hist = _codec.pack_hist(words, valids, has_valid, int(t._counts[s]), world)
        _plan, lanes = pack_cols(flat[s])
        shards.append({
            "packed": torch.stack(lanes, 1),  # [n, L] row-major
            "lane": lane, "base": _codec.scan_tiles(hist),
            "cnt": hist.sum(1, dtype=torch.int32),
        })
    return {
        "spec": spec, "t": t, "ctx": t.ctx, "world": world,
        "plan": lane_plan(flat[0]), "row_bytes": _sh.exchange_row_bytes(flat[0]),
        "shards": shards,
    }


def _shuffle_many(specs: Sequence[_ShuffleSpec]) -> List[Table]:
    """The chunked shuffle engine (every Distributed* op funnels through
    here), the JAX package's round structure with its two host syncs:

    1. COUNT: kernel B2a per source shard; ONE fetch per table of its
       [W, W] send-count matrix;
    2. PLAN: ``plan_rounds`` turns the counts, the row bytes and the byte
       budget into ``bucket_cap`` and K rounds;
    3. K ROUNDS of PACK (kernel B2b + the header-fused lane scatter),
       COLLECTIVE (one all_to_all), COMPACT (kernel B3), with no host sync;
       each round keeps its live rows, whose count the plan already knows;
    4. ONE deferred fetch per table of every round's received counts,
       checked against the plan (a mismatch is an internal routing bug),
       then each shard's rounds concatenated round-major.
    """
    states = [_shuffle_state(s) for s in specs]
    for st in states:
        w = st["world"]
        dev0 = st["ctx"].device
        st["send_counts"] = (
            torch.stack([sh["cnt"].to(dev0) for sh in st["shards"]]).cpu().numpy().astype(np.int64)
        )  # [src, dst]: the count phase's host sync
        budget = int(st["spec"].byte_budget or st["ctx"].shuffle_byte_budget)
        st["bucket_cap"], st["n_rounds"] = _sh.plan_rounds(
            st["send_counts"], st["row_bytes"], w, budget
        )
        st["rounds_out"] = [[] for _ in range(w)]
        st["recv"] = []

    for r in range(max(st["n_rounds"] for st in states)):
        for st in states:
            if r >= st["n_rounds"]:
                continue
            w, bc = st["world"], st["bucket_cap"]
            bufs = []
            for sh in st["shards"]:
                dest = _codec.pack_dest(sh["lane"], sh["base"], r, w, bc)
                rc = _sh.round_counts(sh["cnt"], bc, r)
                bufs.append(_sh.pack_lane_buffer(sh["packed"], dest, rc, w, bc))
            got = _sh.exchange_buffer(st["ctx"].comm, bufs)
            expect = _expected_received(st["send_counts"], bc, r)
            for d, g in enumerate(got):
                recv = _sh.header_counts(g, w)
                moved = _codec.compact_move(g, recv, w, bc, n_header=_sh.HEADER_ROWS)
                st["rounds_out"][d].append(moved[: int(expect[d])])
                st["recv"].append(recv.to(st["ctx"].device, copy=True))

    results = []
    for st in states:
        w, bc, k = st["world"], st["bucket_cap"], st["n_rounds"]
        got_all = torch.stack(st["recv"]).cpu().numpy().reshape(k, w, w)  # the deferred sync
        for r in range(k):
            got = got_all[r].sum(axis=1)
            expect = _expected_received(st["send_counts"], bc, r)
            if not (got == expect).all():
                raise RuntimeError(
                    f"shuffle round {r}: received row counts {got} != "
                    f"expected {expect}: internal routing bug"
                )
        t = st["t"]
        shards, counts = [], []
        for d in range(w):
            parts = st["rounds_out"][d]
            moved = parts[0] if len(parts) == 1 else torch.cat(parts)
            out = _sh.compact_received_lanes(st["plan"], moved)
            cols: Shard = OrderedDict()
            for (name, c), (data, valid) in zip(t._shards[d].items(), out):
                cols[name] = Column(data, c.dtype, valid, c.dictionary)
            shards.append(cols)
            counts.append(moved.shape[0])
        results.append(Table(st["ctx"], shards, counts))
    return results


def _expected_received(send_counts: np.ndarray, bucket_cap: int, round_idx: int) -> np.ndarray:
    """Rows each shard receives in a round, from the count phase's matrix."""
    return np.clip(send_counts - round_idx * bucket_cap, 0, bucket_cap).sum(axis=0)


def _shuffle_pair(
    a: Table, a_keys: Sequence[str], b: Table, b_keys: Sequence[str],
    byte_budget: Optional[int] = None,
) -> Tuple[Table, Table]:
    """Hash-shuffle the two sides of a join in one engine call."""
    out = _shuffle_many([
        _ShuffleSpec(a, tuple(a_keys), byte_budget),
        _ShuffleSpec(b, tuple(b_keys), byte_budget),
    ])
    return out[0], out[1]
