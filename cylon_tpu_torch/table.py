"""Table of the PyTorch port (counterpart of cylon_tpu/table.py): the
join -> groupby main path on one device.

A table is an ordered set of exact-length columns on the context's device:
no padding rows, no shard capacities. ``distributed_join`` and
``distributed_groupby`` are the JAX package's entry points; with one device
they are the local join and groupby, as there.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .column import Column, unify_dictionaries
from .context import CylonContext
from .dtypes import DataType, numpy_dtype
from .ops import groupby as _g
from .ops import join as _j
from .ops.gather import pack_gather

Encoded = Tuple[np.ndarray, Optional[np.ndarray], Any, Optional[np.ndarray]]


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md: {item})")


class Table:
    def __init__(self, ctx: CylonContext, columns: "OrderedDict[str, Column]", n_rows: int):
        self.ctx = ctx
        self._columns = columns
        self._n = int(n_rows)

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    @classmethod
    def from_encoded(cls, ctx: CylonContext, encoded: Dict[str, Encoded]) -> "Table":
        """Build a table from host columns already encoded as
        ``Column.encode_host`` returns them, by this package or the JAX
        package: (physical data, valid | None, logical type, sorted
        dictionary | None) per column."""
        n = len(next(iter(encoded.values()))[0]) if encoded else 0
        cols: "OrderedDict[str, Column]" = OrderedDict()
        for name, (phys, valid, dtype, dictionary) in encoded.items():
            if len(phys) != n:
                raise ValueError("all columns must have equal length")
            dt = DataType.of(dtype)
            # a private host copy: the table never aliases the caller's array
            data = torch.from_numpy(np.array(phys, dtype=dt.physical_dtype)).to(ctx.device)
            v = None
            if valid is not None:
                v = torch.from_numpy(np.array(valid, dtype=bool)).to(ctx.device)
            cols[name] = Column(data, dt, v, dictionary)
        return cls(ctx, cols, n)

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

    # ------------------------------------------------------------------
    # properties and host conversion
    # ------------------------------------------------------------------
    @property
    def column_names(self) -> List[str]:
        return list(self._columns.keys())

    @property
    def row_count(self) -> int:
        return self._n

    def __len__(self) -> int:
        return self._n

    def column(self, name: str) -> Column:
        return self._columns[name]

    def _host_column(self, name: str):
        col = self._columns[name]
        data = col.data.cpu().numpy()
        valid = None if col.valid is None else col.valid.cpu().numpy()
        return col.decode_host(data, valid)

    def to_pydict(self) -> Dict[str, np.ndarray]:
        return {name: self._host_column(name) for name in self.column_names}

    def to_pandas(self):
        import pandas as pd

        return pd.DataFrame(self.to_pydict())

    # ------------------------------------------------------------------
    # join
    # ------------------------------------------------------------------
    def _resolve_cols(self, spec) -> List[str]:
        if isinstance(spec, (str, int)):
            spec = [spec]
        names = [self.column_names[s] if isinstance(s, int) else s for s in spec]
        missing = [n for n in names if n not in self._columns]
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

    def _flat_cols(self, names: Optional[Sequence[str]] = None):
        names = self.column_names if names is None else names
        return [(self._columns[n].data, self._columns[n].valid) for n in names]

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
        """Local equi-join, all four types; output rows in left-row order
        (pandas merge order), left columns then right columns, suffixes on
        name collisions."""
        if algorithm == "pallas_pk":
            raise _not_ported("algorithm='pallas_pk'", "queue B, kernel B5")
        if algorithm not in ("sort", "hash"):
            raise ValueError(f"unknown join algorithm {algorithm!r}")
        if emit_order == "key":
            raise _not_ported("emit_order='key'", "queue A, key-order join emit")
        if emit_order != "left":
            raise ValueError(f"unknown emit_order {emit_order!r}")
        if other.ctx.device != self.ctx.device:
            raise ValueError("join of tables on different devices")
        howi = _j.join_type_id(how)
        l_names, r_names = self._resolve_join_keys(other, on, left_on, right_on)
        left, right = _unify_dict_pair(self, other, l_names, r_names)
        out, total = _j.spec_join(
            left._flat_cols(l_names), right._flat_cols(r_names),
            left._flat_cols(), right._flat_cols(), howi,
        )
        out_names = _suffix_names(left.column_names, right.column_names, suffixes)
        src = list(left._columns.values()) + list(right._columns.values())
        cols: "OrderedDict[str, Column]" = OrderedDict()
        for name, s, (d, v) in zip(out_names, src, out):
            cols[name] = Column(d, s.dtype, v, s.dictionary)
        return Table(self.ctx, cols, total)

    def distributed_join(
        self,
        other: "Table",
        on: Optional[Union[str, Sequence[str]]] = None,
        how: str = "inner",
        *,
        mode: str = "eager",
        **kwargs,
    ) -> "Table":
        """The flagship op. One device: the local join."""
        if mode == "fused":
            raise _not_ported("mode='fused'", "queue A, the fused shuffle->join program")
        if mode != "eager":
            raise ValueError(f"unknown join mode {mode!r}")
        if on is not None:
            kwargs["on"] = on
        kwargs.setdefault("how", how)
        return self.join(other, **kwargs)

    # ------------------------------------------------------------------
    # groupby
    # ------------------------------------------------------------------
    def groupby(
        self,
        by: Union[str, int, Sequence[Union[str, int]]],
        agg: Dict[str, Union[str, int, Sequence[Union[str, int]]]],
    ) -> "Table":
        """Groupby-aggregate: the key columns in sorted key order, then one
        column ``<col>_<op>`` per (column, op), op in sum/count/min/max/mean."""
        key_names = self._resolve_cols(by)
        specs: List[Tuple[str, int, str]] = []
        for col, ops in agg.items():
            self._resolve_cols(col)
            for o in ops if isinstance(ops, (list, tuple)) else [ops]:
                oid = _g.agg_op_id(o)
                specs.append((col, oid, o if isinstance(o, str) else _agg_name(oid)))
        keys = self._flat_cols(key_names)
        ids, ng = _g.group_ids(keys)
        rep = _g.group_representatives(ids, ng)
        key_out = pack_gather(keys, rep, all_valid=True)
        cols: "OrderedDict[str, Column]" = OrderedDict()
        for n, (d, v) in zip(key_names, key_out):
            src = self._columns[n]
            cols[n] = Column(d, src.dtype, v, src.dictionary)
        for col, oid, oname in specs:
            d, v = self._columns[col].data, self._columns[col].valid
            a, av = _g.aggregate_column(oid, d, v, ids, ng)
            cols[f"{col}_{oname}"] = Column(
                a, DataType.from_numpy_dtype(numpy_dtype(a.dtype)), av, None
            )
        return Table(self.ctx, cols, ng)

    def distributed_groupby(
        self,
        by: Union[str, int, Sequence[Union[str, int]]],
        agg: Dict[str, Union[str, Sequence[str]]],
        **kw,
    ) -> "Table":
        """Distributed groupby. One device: the local groupby."""
        return self.groupby(by, agg, **kw)

    def __repr__(self):
        return f"Table(rows={self._n}, columns={self.column_names}, device={self.ctx.device})"


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
    new_a = OrderedDict(a._columns)
    new_b = OrderedDict(b._columns)
    changed = False
    for an, bn in zip(a_cols, b_cols):
        ca, cb = a._columns[an], b._columns[bn]
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
        new_a[an] = _remap_codes(ca, map_a, union)
        new_b[bn] = _remap_codes(cb, map_b, union)
        changed = True
    if not changed:
        return a, b
    return Table(a.ctx, new_a, a._n), Table(b.ctx, new_b, b._n)

