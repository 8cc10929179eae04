"""Series: a named device-resident column with pandas-like operators
(counterpart of cylon_tpu/series.py; pycylon's Series).

A Series is backed by a one-column :class:`Table`, so comparisons,
arithmetic, filters and reductions reuse the table's per-shard ops
(``compute``) and stay on the devices.
"""
from __future__ import annotations

import operator
from typing import Optional

import numpy as np

from . import compute as _c
from .column import Column
from .context import CylonContext
from .table import Table


class Series:
    __slots__ = ("_table", "_name")

    def __init__(self, data=None, name: str = "0", ctx: Optional[CylonContext] = None,
                 _table: Optional[Table] = None):
        if _table is not None:
            self._table = _table
            self._name = _table.column_names[0]
            return
        from .frame import _local_ctx

        self._table = Table.from_pydict(ctx or _local_ctx(), {name: np.asarray(data)})
        self._name = name

    @property
    def id(self) -> str:
        return self._name

    @property
    def name(self) -> str:
        return self._name

    @property
    def data(self) -> Column:
        return self._table.column(self._name)

    @property
    def dtype(self):
        return self._table.dtype_of(self._name)

    @property
    def shape(self):
        return (self._table.row_count,)

    def __len__(self) -> int:
        return self._table.row_count

    def __getitem__(self, item):
        if isinstance(item, int):
            return self.to_numpy()[item]
        if isinstance(item, slice):
            return Series(_table=self._table.iloc[item])
        if isinstance(item, Series):
            return Series(_table=self._table.filter(item._table))
        raise TypeError(f"unsupported index {item!r}")

    def __repr__(self):
        return f"Series({self._name!r}, n={len(self)})"

    def to_numpy(self) -> np.ndarray:
        return self._table.to_pydict()[self._name]

    def to_pandas(self):
        import pandas as pd

        return pd.Series(self.to_numpy(), name=self._name)

    # -- elementwise ------------------------------------------------------
    def _cmp(self, other, op):
        if isinstance(other, Series):
            other = other._table
        return Series(_table=_c.table_compare_op(self._table, other, op))

    def __eq__(self, other):  # noqa: A003
        return self._cmp(other, operator.eq)

    def __ne__(self, other):
        return self._cmp(other, operator.ne)

    def __lt__(self, other):
        return self._cmp(other, operator.lt)

    def __le__(self, other):
        return self._cmp(other, operator.le)

    def __gt__(self, other):
        return self._cmp(other, operator.gt)

    def __ge__(self, other):
        return self._cmp(other, operator.ge)

    def _math(self, other, op):
        if isinstance(other, Series):
            other = other._table
        return Series(_table=_c.math_op(self._table, op, other))

    def __add__(self, other):
        return self._math(other, operator.add)

    def __sub__(self, other):
        return self._math(other, operator.sub)

    def __mul__(self, other):
        return self._math(other, operator.mul)

    def __truediv__(self, other):
        return self._math(other, operator.truediv)

    def __mod__(self, other):
        return self._math(other, operator.mod)

    def __pow__(self, other):
        return self._math(other, operator.pow)

    def __neg__(self):
        return Series(_table=_c.neg(self._table))

    def __invert__(self):
        return Series(_table=_c.invert(self._table))

    def __and__(self, other):
        return self._math(other, operator.and_)

    def __or__(self, other):
        return self._math(other, operator.or_)

    def abs(self) -> "Series":
        return Series(_table=_c.abs_(self._table))

    def isin(self, values) -> "Series":
        return Series(_table=_c.is_in(self._table, values))

    def isnull(self) -> "Series":
        return Series(_table=self._table.isnull())

    def notnull(self) -> "Series":
        return Series(_table=self._table.notnull())

    def fillna(self, value) -> "Series":
        return Series(_table=self._table.fillna(value))

    def astype(self, dtype) -> "Series":
        return Series(_table=self._table.astype(dtype))

    def unique(self) -> "Series":
        return Series(_table=self._table.unique())

    def nunique(self) -> int:
        return _c.nunique(self._table)[self._name]

    # -- reductions over every shard ---------------------------------------
    def sum(self):
        return self._table.sum(self._name)

    def min(self):
        return self._table.min(self._name)

    def max(self):
        return self._table.max(self._name)

    def count(self) -> int:
        return self._table.count(self._name)

    def mean(self):
        return self._table.mean(self._name)

    def sort_values(self, ascending: bool = True) -> "Series":
        return Series(_table=self._table.sort(self._name, ascending=ascending))
