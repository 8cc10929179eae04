"""Logical-plan IR (counterpart of cylon_tpu/plan/nodes.py): immutable nodes
with schema, partitioning and ordering propagation.

Schema entries are ``(name, type_id, physical dtype name)``, enough for the
rewrite rules to gate on (is the summed column float32? is a key a string?)
and for the plan fingerprint, without holding any data.

Partitioning is derived, not stored: :meth:`Node.partitioning` returns the
column tuples whose equal values are guaranteed to share a shard, which is
what lets the rewriter prove a re-partition redundant. :meth:`Node.ordering`
derives the order property the same way (``ordering.py``), and
:meth:`Node.col_stats` the column range stats (``ops/stats.py``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from .. import ordering as _ord
from ..dtypes import Type, numpy_dtype
from ..ordering import Ordering

SchemaEntry = Tuple[str, int, str]  # (name, Type enum value, physical dtype)
# ORDERED key tuples: order is part of the placement function's identity
# (hashing ['a','b'] and ['b','a'] routes differently), so two-table
# consumers demand exact tuple equality while single-table co-location
# checks may relax to subsets (_covers).
Partitioning = List[Tuple[str, ...]]


def _suffix_names(lnames, rnames, suffixes):
    overlap = set(lnames) & set(rnames)
    out = [n + suffixes[0] if n in overlap else n for n in lnames]
    out += [n + suffixes[1] if n in overlap else n for n in rnames]
    return out


class Node:
    """Base plan node. ``children`` is a tuple; nodes are treated as
    immutable — rewrites build new nodes via :meth:`with_children`."""

    children: Tuple["Node", ...] = ()
    schema: Tuple[SchemaEntry, ...] = ()

    @property
    def names(self) -> List[str]:
        return [e[0] for e in self.schema]

    def dtype_of(self, name: str) -> Tuple[int, str]:
        for n, t, p in self.schema:
            if n == name:
                return t, p
        raise KeyError(name)

    def with_children(self, kids: Sequence["Node"]) -> "Node":
        raise NotImplementedError

    def partitioning(self) -> Partitioning:
        """Column sets whose equal tuples are co-located (see module doc)."""
        return []

    def ordering(self) -> Optional[Ordering]:
        """The node's output order property, derived like partitioning:
        what the eager op provably establishes/preserves (see
        ordering.py). None = no claim. The ``order_reuse`` rule
        consumes it, and ``.explain()`` prints it per node."""
        return None

    def col_stats(self) -> Dict[str, object]:
        """Known column range stats (ops/stats.ColStat) of this node's
        output, derived like partitioning and ordering: a Scan reads its
        table's measured bounds, row-subset and rename nodes carry them
        (bounds stay sound over any subset), value-rewriting nodes drop
        them. Advisory: the eager ops decide their own packing from live
        tables; ``.explain()`` prints the quantized widths per node."""
        return {}

    def _params(self) -> tuple:
        """Node-local fingerprint parameters (no children, no schema —
        schema is derived and scans carry theirs explicitly)."""
        return ()

    def fingerprint(self) -> tuple:
        return (
            type(self).__name__,
            self._params(),
            tuple(c.fingerprint() for c in self.children),
        )

    def label(self) -> str:
        """One-line description for ``.explain()``."""
        return type(self).__name__

    def line(self) -> str:
        """The node's single rendered line (label + derived order + the
        quantized widths of its column range stats)."""
        line = self.label()
        o = self.ordering()
        if o is not None:
            line += f"  -- order: {o.describe()}"
        stats = self.col_stats()
        if stats:
            from ..ops.stats import field_bits

            widths = ", ".join(f"{n}:{field_bits(v)}b" for n, v in sorted(stats.items()))
            line += f"  -- stats: {widths}"
        return line

    def render(self, indent: int = 0) -> str:
        lines = ["  " * indent + self.line()]
        for c in self.children:
            lines.append(c.render(indent + 1))
        return "\n".join(lines)


class Scan(Node):
    """A concrete bound Table. ``ordinal`` is assigned in original-plan DFS
    order at collect time and is how the cached executor finds its input."""

    def __init__(self, table):
        self.table = table
        self.ordinal: Optional[int] = None
        # a detached stub (lower.detach_scans) freezes the descriptor it
        # was compiled under; a live Scan reads the table's at use time, so
        # an in-place change that voided it is seen (no stale claim); range
        # stats follow the same live-read / frozen-stub rule
        self.table_ordering: Optional[Ordering] = None
        self.table_stats: Dict[str, object] = {}
        self.table_stream_gen = None
        self.schema = tuple(
            (n, int(table._ref[n].dtype.type), str(numpy_dtype(table._ref[n].data.dtype)))
            for n in table.column_names
        )

    def with_children(self, kids):
        assert not kids
        return self

    def ordering(self) -> Optional[Ordering]:
        if self.table is None:  # detached stub
            return self.table_ordering
        return self.table._ordering

    def col_stats(self) -> Dict[str, object]:
        if self.table is None:  # detached stub
            return dict(self.table_stats)
        return dict(self.table._stats)

    def stream_gen(self):
        """The bound table's streaming identity: ``(source_token,
        generation)`` on a snapshot, ``(source_token, since, current)`` on a
        delta (both stamped by ``stream/ingest.py``), None on an ordinary
        table. Read live (frozen on a detached stub), so the generation
        rides :func:`~cylon_tpu_torch.plan.lazy.gated_fingerprint`: a cached
        executor and its observation profile never alias across refreshes
        of a growing table."""
        if self.table is None:  # detached stub
            return self.table_stream_gen
        return getattr(self.table, "_stream_gen", None)

    def _params(self) -> tuple:
        # the descriptor is part of the plan identity: an executor whose
        # rewrites used (or ignored) the input's order must not serve an
        # input with another order property; the stream generation is read
        # the same way, at the same time
        return (self.ordinal, self.schema, self.table.world_size, self.ordering(),
                self.stream_gen())

    def label(self) -> str:
        return f"Scan [{', '.join(self.names)}]"


class Project(Node):
    def __init__(self, child: Node, cols: Sequence[str]):
        missing = [c for c in cols if c not in child.names]
        if missing:
            raise KeyError(f"project columns not in input: {missing}")
        self.children = (child,)
        self.cols = tuple(cols)
        by_name = {e[0]: e for e in child.schema}
        self.schema = tuple(by_name[c] for c in cols)

    def with_children(self, kids):
        return Project(kids[0], self.cols)

    def partitioning(self) -> Partitioning:
        kept = set(self.cols)
        return [s for s in self.children[0].partitioning() if set(s) <= kept]

    def ordering(self) -> Optional[Ordering]:
        return _ord.truncate_to(self.children[0].ordering(), self.cols)

    def col_stats(self) -> Dict[str, object]:
        kept = set(self.cols)
        return {n: v for n, v in self.children[0].col_stats().items() if n in kept}

    def _params(self) -> tuple:
        return (self.cols,)

    def label(self) -> str:
        return f"Project [{', '.join(self.cols)}]"


class Filter(Node):
    def __init__(self, child: Node, expr):
        missing = [c for c in sorted(expr.columns()) if c not in child.names]
        if missing:
            raise KeyError(f"filter references unknown columns: {missing}")
        self.children = (child,)
        self.expr = expr
        self.schema = child.schema

    def with_children(self, kids):
        return Filter(kids[0], self.expr)

    def partitioning(self) -> Partitioning:
        return self.children[0].partitioning()

    def ordering(self) -> Optional[Ordering]:
        return self.children[0].ordering()  # row subset keeps row order

    def col_stats(self) -> Dict[str, object]:
        # a row subset only shrinks ranges: the bounds stay sound
        return self.children[0].col_stats()

    def _params(self) -> tuple:
        return (self.expr.key(),)

    def label(self) -> str:
        return f"Filter {self.expr!r}"


class Join(Node):
    """Equi-join. Output names are fixed at BUILD time from the full child
    schemas (``_suffix_names``, the eager Table.join convention) and kept
    through rewrites: lowering renames each side to its out-names before
    joining, so later column pruning cannot change the naming."""

    def __init__(
        self,
        left: Node,
        right: Node,
        l_on: Sequence[str],
        r_on: Sequence[str],
        how: str = "inner",
        suffixes: Tuple[str, str] = ("_x", "_y"),
        _renames: Optional[Tuple[Dict[str, str], Dict[str, str]]] = None,
        emit_key_order: bool = False,
        semi_filter: Optional[str] = None,
    ):
        self.children = (left, right)
        self.l_on = tuple(l_on)
        self.r_on = tuple(r_on)
        self.how = how
        self.suffixes = tuple(suffixes)
        # set by the order_reuse rewrite: lower with emit_order='key' so the
        # join's probe kv-sort doubles as the downstream op's key sort
        self.emit_key_order = bool(emit_key_order)
        # set by the semi_filter rewrite: which input sides' shuffles may
        # prune against the other side's key sketch ('both'/'left'/'right';
        # None = ineligible or off), ops/sketch.join_filter_sides
        self.semi_filter = semi_filter
        if _renames is None:
            lnames, rnames = left.names, right.names
            out = _suffix_names(lnames, rnames, suffixes)
            self.l_rename = dict(zip(lnames, out[: len(lnames)]))
            self.r_rename = dict(zip(rnames, out[len(lnames):]))
        else:
            self.l_rename, self.r_rename = _renames
        self.schema = tuple(
            [(self.l_rename[n], t, p) for n, t, p in left.schema]
            + [(self.r_rename[n], t, p) for n, t, p in right.schema]
        )

    def with_children(self, kids):
        return Join(
            kids[0], kids[1], self.l_on, self.r_on, self.how, self.suffixes,
            _renames=(self.l_rename, self.r_rename),
            emit_key_order=self.emit_key_order,
            semi_filter=self.semi_filter,
        )

    @property
    def l_key_out(self) -> Tuple[str, ...]:
        return tuple(self.l_rename[n] for n in self.l_on)

    @property
    def r_key_out(self) -> Tuple[str, ...]:
        return tuple(self.r_rename[n] for n in self.r_on)

    def partitioning(self) -> Partitioning:
        left, right = self.children
        l_ok = _placed_by(left.partitioning(), self.l_on)
        r_ok = _placed_by(right.partitioning(), self.r_on)
        if not (l_ok and r_ok):
            return []
        out: Partitioning = []
        # matched rows carry equal key values on both sides; unmatched
        # OUTER rows have nulls on the other side, so only the side whose
        # keys are never null co-locates the output (full outer: neither).
        # The tuples keep the SHUFFLE order (l_on/r_on order): that order
        # is the placement function both inputs were routed by.
        if self.how in ("inner", "left"):
            out.append(self.l_key_out)
        if self.how in ("inner", "right"):
            out.append(self.r_key_out)
        return out

    def ordering(self) -> Optional[Ordering]:
        if self.emit_key_order and self.how in ("inner", "left"):
            return Ordering(
                keys=self.l_key_out,
                ascending=(True,) * len(self.l_on),
                nulls_last=True, scope="shard", canonical=True,
                lexsort_exact=False,
            )
        if self.how in ("inner", "left"):
            # the emit repeats left rows in left order: the left input's
            # descriptor survives, under the join's output names
            return _ord.rename(self.children[0].ordering(), self.l_rename)
        return None

    def col_stats(self) -> Dict[str, object]:
        # every output value comes from an input row (outer rows add nulls,
        # not values), so each side's bounds survive under the output names
        out: Dict[str, object] = {}
        for n, v in self.children[0].col_stats().items():
            out[self.l_rename.get(n, n)] = v
        for n, v in self.children[1].col_stats().items():
            out[self.r_rename.get(n, n)] = v
        return out

    def _params(self) -> tuple:
        # semi_filter is part of the plan identity: an executor that lowers
        # the filtered pair exchange must not serve an unannotated plan
        return (
            self.l_on, self.r_on, self.how, self.suffixes,
            tuple(sorted(self.l_rename.items())),
            tuple(sorted(self.r_rename.items())),
            self.emit_key_order, self.semi_filter,
        )

    def label(self) -> str:
        keys = ", ".join(f"{a}={b}" for a, b in zip(self.l_on, self.r_on))
        tail = " emit=key-order" if self.emit_key_order else ""
        if self.semi_filter:
            tail += f" semi-filter={self.semi_filter}"
        return f"Join how={self.how} on [{keys}]{tail}"


class GroupBy(Node):
    def __init__(
        self,
        child: Node,
        keys: Sequence[str],
        aggs: Sequence[Tuple[str, str]],
        sorted_input: bool = False,
    ):
        self.children = (child,)
        self.keys = tuple(keys)
        self.aggs = tuple(aggs)  # [(value column, op name)]
        # annotation set by the order_reuse rewrite: the child provably
        # emits key order, so lowering's eager groupby will run-detect
        # instead of lexsorting (the eager gate re-verifies — the plan
        # claim is advisory, the kernel choice is the table's)
        self.sorted_input = bool(sorted_input)
        by_name = {e[0]: e for e in child.schema}
        out = [by_name[k] for k in keys]
        for c, op in self.aggs:
            _, t, p = by_name[c]
            out.append((f"{c}_{op}",) + _agg_out_dtype(op, t, p))
        self.schema = tuple(out)

    def with_children(self, kids):
        return GroupBy(kids[0], self.keys, self.aggs, self.sorted_input)

    def partitioning(self) -> Partitioning:
        kept = set(self.keys)
        return [s for s in self.children[0].partitioning() if set(s) <= kept]

    def ordering(self) -> Optional[Ordering]:
        # groups emit in canonical key order (factorize id order)
        return Ordering(
            keys=self.keys, ascending=(True,) * len(self.keys),
            nulls_last=True, scope="shard", canonical=True,
            lexsort_exact=False,
        )

    def col_stats(self) -> Dict[str, object]:
        kept = set(self.keys)
        return {n: v for n, v in self.children[0].col_stats().items() if n in kept}

    def _params(self) -> tuple:
        return (self.keys, self.aggs, self.sorted_input)

    def label(self) -> str:
        spec = ", ".join(f"{op}({c})" for c, op in self.aggs)
        tail = (
            " [input key-ordered: groupby lexsort elided]"
            if self.sorted_input else ""
        )
        return f"GroupBy [{', '.join(self.keys)}] agg [{spec}]{tail}"


class Sort(Node):
    """Local (per-shard) sort; a preceding range Shuffle makes it global."""

    def __init__(self, child: Node, by: Sequence[str], ascending: Sequence[bool]):
        self.children = (child,)
        self.by = tuple(by)
        self.ascending = tuple(bool(a) for a in ascending)
        self.schema = child.schema

    def with_children(self, kids):
        return Sort(kids[0], self.by, self.ascending)

    def partitioning(self) -> Partitioning:
        return self.children[0].partitioning()

    def ordering(self) -> Optional[Ordering]:
        # canonical is a mask-dependent property the plan can't see; the
        # identity claim (lexsort_exact) is what the sort-elision rule needs
        child = self.children[0]
        scope = "shard"
        if (
            isinstance(child, Shuffle) and child.kind == "range"
            and child.keys == (self.by[0],)
            and child.asc0 == self.ascending[0]
        ):
            scope = "global"  # the sample-sort recipe
        return Ordering(
            keys=self.by, ascending=self.ascending, nulls_last=True,
            scope=scope, canonical=False, lexsort_exact=True,
        )

    def col_stats(self) -> Dict[str, object]:
        return self.children[0].col_stats()  # a permutation of the rows

    def _params(self) -> tuple:
        return (self.by, self.ascending)

    def label(self) -> str:
        return f"Sort by [{', '.join(self.by)}] asc={list(self.ascending)}"


class Shuffle(Node):
    """Physical re-partition over the mesh: hash (relational ops) or range
    (global sort). Inserted by the physicalizer; the redundant-shuffle rule
    removes it when the child already co-locates the keys."""

    def __init__(self, child: Node, keys: Sequence[str], kind: str = "hash",
                 asc0: bool = True):
        self.children = (child,)
        self.keys = tuple(keys)
        self.kind = kind
        self.asc0 = bool(asc0)
        self.schema = child.schema

    def with_children(self, kids):
        return Shuffle(kids[0], self.keys, self.kind, self.asc0)

    def partitioning(self) -> Partitioning:
        if self.kind == "hash":
            return [self.keys]
        return []  # range partitions co-locate ranges, not equal tuples

    def col_stats(self) -> Dict[str, object]:
        return self.children[0].col_stats()  # rows reroute, values don't

    def _params(self) -> tuple:
        return (self.keys, self.kind, self.asc0)

    def label(self) -> str:
        return f"Shuffle {self.kind} [{', '.join(self.keys)}]"


class Union(Node):
    """Distinct set-union (Table.union semantics)."""

    def __init__(self, left: Node, right: Node):
        if left.names != right.names:
            raise ValueError(
                f"union requires identical schemas: {left.names} vs {right.names}"
            )
        self.children = (left, right)
        self.schema = left.schema

    def with_children(self, kids):
        return Union(kids[0], kids[1])

    def partitioning(self) -> Partitioning:
        # local distinct-union keeps rows on their shard: co-location sets
        # holding on BOTH inputs survive
        l = self.children[0].partitioning()
        r = self.children[1].partitioning()
        return [s for s in l if s in r]

    def label(self) -> str:
        return "Union"


class Limit(Node):
    """First ``n`` rows in global row order (lowers to Table.take, which
    re-splits evenly across shards — so partitioning is lost)."""

    def __init__(self, child: Node, n: int):
        self.children = (child,)
        self.n = int(n)
        self.schema = child.schema

    def with_children(self, kids):
        return Limit(kids[0], self.n)

    def _params(self) -> tuple:
        return (self.n,)

    def label(self) -> str:
        return f"Limit {self.n}"


class FusedJoinGroupBySum(Node):
    """INNER join + groupby-SUM(left value) BY the join key, collapsed into
    ``ops.join.join_sum_by_key_pushdown`` (one merged kv-sort instead of the
    join emit + groupby sort chain; >3x by the roofline model). Produced by
    the ``fused_join_groupby`` rewrite; children are the join's children
    (including any planner-inserted Shuffles)."""

    def __init__(
        self,
        left: Node,
        right: Node,
        l_on: Sequence[str],
        r_on: Sequence[str],
        val_col: str,               # LEFT-side source column being summed
        out_keys: Sequence[str],    # output key names, groupby key order
        key_order: Sequence[int],   # join-key-pair index for each out key
        out_val: str,
        val_dtype: Tuple[int, str],
        semi_filter: Optional[str] = None,
    ):
        self.children = (left, right)
        self.l_on = tuple(l_on)
        self.r_on = tuple(r_on)
        self.val_col = val_col
        self.out_keys = tuple(out_keys)
        self.key_order = tuple(key_order)
        self.out_val = out_val
        # the fused node is an inner join: the semi_filter rewrite may mark
        # both input shuffles prunable, as for Join
        self.semi_filter = semi_filter
        lby = {e[0]: e for e in left.schema}
        entries = []
        for name, ki in zip(self.out_keys, self.key_order):
            _, t, p = lby[self.l_on[ki]]
            entries.append((name, t, p))
        entries.append((out_val,) + tuple(val_dtype))
        self.schema = tuple(entries)

    def with_children(self, kids):
        return FusedJoinGroupBySum(
            kids[0], kids[1], self.l_on, self.r_on, self.val_col,
            self.out_keys, self.key_order, self.out_val,
            self.schema[-1][1:], semi_filter=self.semi_filter,
        )

    def partitioning(self) -> Partitioning:
        left, right = self.children
        if _placed_by(left.partitioning(), self.l_on) and _placed_by(
            right.partitioning(), self.r_on
        ):
            # placement order is the join-pair order, not groupby order
            pair_names = [None] * len(self.l_on)
            for name, ki in zip(self.out_keys, self.key_order):
                pair_names[ki] = name
            return [tuple(pair_names)]
        return []

    def ordering(self) -> Optional[Ordering]:
        # join_sum_by_key_pushdown numbers groups over the merged kv-sort:
        # canonical key order, keys in join-pair order
        pair_names = [None] * len(self.l_on)
        for name, ki in zip(self.out_keys, self.key_order):
            pair_names[ki] = name
        return Ordering(
            keys=tuple(pair_names), ascending=(True,) * len(pair_names),
            nulls_last=True, scope="shard", canonical=True,
            lexsort_exact=False,
        )

    def _params(self) -> tuple:
        return (
            self.l_on, self.r_on, self.val_col, self.out_keys,
            self.key_order, self.out_val, self.semi_filter,
        )

    def label(self) -> str:
        keys = ", ".join(f"{a}={b}" for a, b in zip(self.l_on, self.r_on))
        tail = f" semi-filter={self.semi_filter}" if self.semi_filter else ""
        return (
            f"FusedJoinGroupBySum on [{keys}] sum({self.val_col}) "
            f"-> join_sum_by_key_pushdown{tail}"
        )


def _covers(partitioning: Partitioning, keys: set) -> bool:
    """Single-table co-location: some guaranteed co-location column set is
    a subset of ``keys`` — equal key tuples agree on that subset, hence
    share a shard. NOT sufficient for two-table consumers (see _placed_by:
    both sides must agree on the exact placement function)."""
    return any(set(s) <= keys for s in partitioning)


def _placed_by(partitioning: Partitioning, keys: Tuple[str, ...]) -> bool:
    """Two-table-consumer check: the input is already placed by EXACTLY the
    shuffle's ordered key tuple, i.e. the same hash placement the other
    side will be routed by. A subset placement (hash of fewer columns)
    co-locates rows but routes them to DIFFERENT shards than a fresh hash
    of the full tuple — eliding on a subset would silently drop matches."""
    return any(tuple(s) == tuple(keys) for s in partitioning)


def _agg_out_dtype(op: str, t: int, p: str) -> Tuple[int, str]:
    """Approximate output dtype of one aggregate (display + fingerprint
    only; lowering defers to the eager kernels' real promotion)."""
    if op in ("count", "nunique"):
        return int(Type.INT64), "int64"
    if op in ("mean", "var", "std", "quantile", "median"):
        return int(Type.DOUBLE), "float64"
    if op == "sum" and not p.startswith("float"):
        return int(Type.INT64), "int64"
    return t, p
