"""``loc`` and ``iloc`` row addressing (counterpart of
cylon_tpu/indexing/indexer.py; the reference's LocIndexer/ILocIndexer).

Most forms build a bool row mask per shard on its device and go through
``Table.filter``, so the rows keep their shards and their order:

- ``loc``: by value against the index column (one label, an inclusive
  slice, a bool mask); a list of labels returns the rows in REQUEST order,
  each label's rows in index order, missing labels skipped (pandas raises
  KeyError there; the JAX package skips, and so does the port). Its
  positions come from a probe of the index column's sorted view on the
  device (a :class:`HashIndex`, the one ``build_index`` keeps or one made
  for the call) and its rows from ``Table.take``;
- ``iloc``: by global row number over the shards in order.
"""
from __future__ import annotations

import numpy as np
import torch

from ..dtypes import numpy_dtype
from .index import HashIndex, encode_lookup_values


def _global_positions(table):
    """Per shard this process owns, the global row number of each row."""
    offs = np.concatenate([[0], np.cumsum(table._counts)])
    return table._per_shard(lambda s: torch.arange(
        int(offs[s]), int(offs[s + 1]), dtype=torch.int64, device=table.ctx.devices[s]))


def _index_name(table) -> str:
    if table.index_name is None:
        raise ValueError("loc requires set_index() first (table has RangeIndex)")
    return table.index_name


def _np_dtype(col) -> np.dtype:
    return numpy_dtype(col.data.dtype)


def _encode_values(table, name, values) -> np.ndarray:
    col = table._ref[name]
    dictionary = col.dictionary if col.dtype.is_dictionary else None
    return encode_lookup_values(dictionary, _np_dtype(col), values)


def _encode_bound(col, value, side: str):
    """A slice bound: a missing string bound maps to its insertion point,
    so the range holds ('c' between 'b' and 'd'); a number converts to the
    column's type as numpy converts it."""
    if col.dtype.is_dictionary:
        if side == "lo":
            return int(np.searchsorted(col.dictionary, value, side="left"))
        return int(np.searchsorted(col.dictionary, value, side="right") - 1)
    return torch.tensor(np.asarray(value).astype(_np_dtype(col)), device=col.data.device)


def _is_bool_mask(rows) -> bool:
    """Bool-mask mode: a Table or Column of bools, a bool array, or a list
    of bools."""
    from ..column import Column
    from ..table import Table

    if isinstance(rows, (Table, Column)):
        c = next(iter(rows._ref.values())) if isinstance(rows, Table) else rows
        return c.data.dtype == torch.bool
    if isinstance(rows, (list, tuple)):
        return len(rows) > 0 and all(isinstance(b, (bool, np.bool_)) for b in rows)
    return isinstance(rows, np.ndarray) and rows.dtype == np.bool_


def _split_item(item):
    if isinstance(item, tuple) and len(item) == 2:
        rows, cols = item
        if isinstance(cols, (str, int)):
            cols = [cols]
        elif isinstance(cols, slice):
            cols = None if cols == slice(None) else cols
        return rows, cols
    return item, None


class LocIndexer:
    """``table.loc[rows]`` and ``table.loc[rows, cols]`` by index value."""

    def __init__(self, table):
        self._t = table

    def __getitem__(self, item):
        rows, cols = _split_item(item)
        src = self._t
        t = src if cols is None else src.project(cols)
        name = _index_name(src)
        if _is_bool_mask(rows):
            return t.filter(rows)
        if isinstance(rows, slice):
            if rows.step is not None:
                raise ValueError("loc slices do not support step")
            if rows.start is None and rows.stop is None:
                return t

            def mask(s):
                c = src._shards[s][name]
                m = c.valid_mask().clone()
                if rows.start is not None:
                    m &= c.data >= _encode_bound(c, rows.start, "lo")
                if rows.stop is not None:
                    m &= c.data <= _encode_bound(c, rows.stop, "hi")  # inclusive, as pandas
                return m

            return t.filter(src._per_shard(mask))
        if np.isscalar(rows) or isinstance(rows, str):
            enc = _encode_values(src, name, [rows])

            def match(s):
                c = src._shards[s][name]
                return (c.data == torch.tensor(enc[0], device=c.data.device)) & c.valid_mask()

            return t.filter(src._per_shard(match))
        vals = list(rows)
        if not vals:
            return t.filter(np.zeros(src.row_count, bool))
        built = src._built_index
        index = built[1] if built is not None and built[0][1] == name else HashIndex(src, name)
        return t.take(index.loc_positions(vals))


class ILocIndexer:
    """``table.iloc[rows]`` and ``table.iloc[rows, cols]`` by global row
    number."""

    def __init__(self, table):
        self._t = table

    def __getitem__(self, item):
        rows, cols = _split_item(item)
        src = self._t
        t = src if cols is None else src.project(cols)
        n = src.row_count
        if _is_bool_mask(rows):
            return t.filter(rows)
        gpos = _global_positions(src)
        if isinstance(rows, slice):
            start, stop, step = rows.indices(n)

            def in_slice(s):
                g = gpos[s]
                m = (g >= start) & (g < stop)
                return m if step == 1 else m & ((g - start) % step == 0)

            return t.filter(src._per_shard(in_slice))
        if np.isscalar(rows):
            p = int(rows)
            p = p + n if p < 0 else p
            return t.filter(src._per_shard(lambda s: gpos[s] == p))
        vals = np.asarray(list(rows), np.int64)
        vals = np.where(vals < 0, vals + n, vals)
        if len(vals) == 0:
            return t.filter(np.zeros(n, bool))
        if len(vals) > 1 and not (np.diff(vals) > 0).all():
            return t.take(vals)  # repeats or reordering: a gather by position
        want = torch.from_numpy(np.sort(vals))

        def member(s):
            w = want.to(gpos[s].device)
            pos = torch.searchsorted(w, gpos[s]).clamp(0, len(vals) - 1)
            return w.index_select(0, pos) == gpos[s]

        return t.filter(src._per_shard(member))
