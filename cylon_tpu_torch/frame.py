"""Pandas-like DataFrame facade and CylonEnv (counterpart of
cylon_tpu/frame.py).

Reference analog: python/pycylon/frame.py. ``CylonEnv`` names the devices
a computation runs on; a ``DataFrame`` wraps a :class:`Table`, and the
``env=`` argument of ``merge`` / ``join`` / ``groupby`` / ``sort_values`` /
``drop_duplicates`` / ``concat`` switches between the local ops and the
distributed ones. ``CylonEnv(config=GPUConfig())`` is the only change
against pycylon; with ``GPUConfig(coordinator_address=...,
num_processes=W, process_id=r)`` every rank runs the same program on its
own shard, as under ``mpirun``. Selection, the operators, null handling,
``set_index`` / ``loc`` / ``iloc``, ``concat`` and ``lazy`` are the JAX
package's, ``merge``/``join`` with ``mode="fused"`` under a distributed env
too, and ``collect_async`` submits the frame to the serving scheduler
(``serve/``).
"""
from __future__ import annotations

import operator as _op
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import compute as _c
from .column import Column
from .config import GPUConfig
from .context import CylonContext
from .dtypes import DataType, numpy_dtype
from .table import Table, _concat_tables


class CylonEnv:
    """Execution environment (reference frame.py:34-65). The rank is the
    context's: this process's rank under ``torch.distributed``, 0 when one
    process drives every shard."""

    def __init__(self, config: Optional[GPUConfig] = None, distributed: bool = True):
        config = config or GPUConfig()
        if not distributed:
            config = GPUConfig(devices=[config.device])
        self.context = CylonContext.init_distributed(config)
        self._distributed = distributed

    @property
    def rank(self) -> int:
        return self.context.rank

    @property
    def world_size(self) -> int:
        return self.context.world_size

    @property
    def is_distributed(self) -> bool:
        return self._distributed and self.world_size > 1

    def __repr__(self):
        return f"CylonEnv(rank={self.rank}, world_size={self.world_size})"


_default_local_ctx: Optional[CylonContext] = None


def _local_ctx() -> CylonContext:
    """The context of a DataFrame built without one: one shard on the card."""
    global _default_local_ctx
    if _default_local_ctx is None:
        _default_local_ctx = CylonContext.init_distributed(GPUConfig())
    return _default_local_ctx


def _check_mode(mode: str, env: Optional[CylonEnv]) -> None:
    """Reject an execution mode that would be ignored: 'fused' needs a
    distributed env, and an unknown mode errors here."""
    if mode == "eager":
        return
    if mode != "fused":
        raise ValueError(f"unknown join mode {mode!r}")
    if env is None or not env.is_distributed:
        raise ValueError("mode='fused' requires a distributed env= argument")


class DataFrame:
    """Pandas-flavored facade over :class:`Table` (reference frame.py)."""

    def __init__(self, data=None, columns: Optional[Sequence[str]] = None,
                 ctx: Optional[CylonContext] = None):
        if isinstance(data, Table):
            self._table = data
            return
        if isinstance(data, DataFrame):
            self._table = data._table
            return
        ctx = ctx or _local_ctx()
        if data is None:
            data = {}
        import pandas as pd

        if isinstance(data, pd.DataFrame):
            self._table = Table.from_pandas(ctx, data)
        elif isinstance(data, dict):
            self._table = Table.from_pydict(ctx, data)
        elif isinstance(data, (list, tuple)):
            # a list of columns (pycylon accepts list-of-lists)
            names = columns or [str(i) for i in range(len(data))]
            self._table = Table.from_pydict(ctx, dict(zip(names, data)))
        elif isinstance(data, np.ndarray):
            if data.ndim != 2:
                raise ValueError("2-D array required")
            names = columns or [str(i) for i in range(data.shape[1])]
            self._table = Table.from_pydict(ctx, {n: data[:, i] for i, n in enumerate(names)})
        else:
            raise TypeError(f"cannot build DataFrame from {type(data)}")

    # -- basic ---------------------------------------------------------
    @property
    def table(self) -> Table:
        return self._table

    def to_table(self) -> Table:
        return self._table

    @property
    def columns(self) -> List[str]:
        return self._table.column_names

    @property
    def shape(self) -> Tuple[int, int]:
        return (self._table.row_count, len(self._table.column_names))

    def __len__(self) -> int:
        return self._table.row_count

    def to_pandas(self):
        """The whole frame, on every rank."""
        return self._table.to_pandas()

    def to_dict(self):
        return self._table.to_pydict()

    def to_numpy(self):
        return self._table.to_numpy()

    def __repr__(self):
        return repr(self._table)

    def _wrap(self, t: Table) -> "DataFrame":
        return DataFrame(t)

    def lazy(self):
        """A lazy query plan over this frame's table (``plan/lazy.py``):
        ``df.lazy().filter(...).join(...).groupby(...).collect()``."""
        return self._table.lazy()

    def collect_async(self, block: bool = True):
        """Submit this frame's (identity) plan to the serving scheduler: a
        :class:`~cylon_tpu_torch.serve.QueryFuture` whose ``result()`` is a
        DataFrame (see ``LazyFrame.collect_async``)."""
        from .serve.scheduler import submit as _serve_submit

        return _serve_submit(self._table.lazy(), block=block, wrap=DataFrame)

    def to_arrow(self):
        """Typed pyarrow.Table (reference frame.py:217; Table.to_arrow)."""
        return self._table.to_arrow()

    def to_csv(self, path, csv_write_options=None) -> None:
        """Write CSV (reference frame.py:226; one file a shard given a list
        of world_size paths)."""
        from .io.csv import write_csv

        write_csv(self._table, path, csv_write_options)

    # -- device placement (the JAX package's: the columns already live on
    #    the context's devices; host copies come from to_pandas) ------------
    def to_cpu(self) -> "DataFrame":
        return self

    def to_device(self, device=None) -> "DataFrame":
        return self

    def is_cpu(self) -> bool:
        return all(d is None or d.type == "cpu" for d in self._table.ctx.devices)

    def is_device(self, device) -> bool:
        return any(d is not None and (d.type == device or d == device)
                   for d in self._table.ctx.devices)

    # -- selection ---------------------------------------------------------
    def __getitem__(self, key):
        """A column name or a list of them -> those columns; a bool frame
        (a comparison's result) -> the rows where it is True."""
        if isinstance(key, str):
            return self._wrap(self._table.project([key]))
        if isinstance(key, (list, tuple)) and all(isinstance(k, str) for k in key):
            return self._wrap(self._table.project(list(key)))
        if isinstance(key, DataFrame):
            return self._wrap(self._table.filter(key._table))
        raise TypeError(f"unsupported key {key!r}")

    def __setitem__(self, key, value):
        """``df['c'] = frame | Column | values | scalar`` adds or replaces a
        column (a one-column frame of the same rows keeps its shards);
        ``df[mask_frame] = value`` sets the masked rows' values."""
        if isinstance(key, DataFrame):
            self._table = self._table.mask(key._table, value)
            return
        t = self._table
        if isinstance(value, DataFrame):
            src = value._table
            if not (src._counts == t._counts).all():
                raise ValueError("the assigned frame's rows differ from this frame's")
            first = src.column_names[0]
            self._table = t.add_column(key, src._map_shards(lambda sh: sh[first]))
            return
        if isinstance(value, Column):
            self._table = t.add_column(key, value)
            return
        t = t._with_shards(t._shards)  # Table.__setitem__ changes the table it is given
        t[key] = value
        self._table = t

    def where(self, cond, other=None) -> "DataFrame":
        return self._wrap(self._table.where(cond._table if isinstance(cond, DataFrame) else cond,
                                            other))

    def mask(self, cond, other=None) -> "DataFrame":
        return self._wrap(self._table.mask(cond._table if isinstance(cond, DataFrame) else cond,
                                           other))

    def iterrows(self):
        return self._table.iterrows()

    def drop(self, columns: Sequence[str]) -> "DataFrame":
        return self._wrap(self._table.drop(columns))

    def rename(self, mapper: Union[Dict[str, str], Sequence[str]]) -> "DataFrame":
        return self._wrap(self._table.rename(mapper))

    def add_prefix(self, prefix: str) -> "DataFrame":
        return self._wrap(self._table.add_prefix(prefix))

    def add_suffix(self, suffix: str) -> "DataFrame":
        return self._wrap(self._table.add_suffix(suffix))

    # -- comparisons, arithmetic, logic: every column against a scalar or
    #    against the first column of another frame, on the raw physical
    #    values, as the JAX package's _binop (a string column's codes) -------
    def _binop(self, other, fn):
        """``fn`` (an ``operator`` function) of every column and ``other``,
        a scalar or a frame's first column; with ``other`` _UNARY, ``fn``
        of every column alone."""
        t = self._table
        oc = None
        if isinstance(other, DataFrame):
            if not (other._table._counts == t._counts).all():
                raise ValueError("the operand frame's rows differ from this frame's")
            first = other._table.column_names[0]
            oc = other._table._map_shards(lambda sh: sh[first])

        def col(s, c):
            if other is _UNARY:
                data, valid = fn(c.data), c.valid
            elif oc is None:
                data, valid = _c.binary_op(fn, c.data, other), c.valid
            else:
                o = oc[s]
                data = _c.binary_op(fn, c.data, o.data.to(c.data.device))
                valid = _and_valid(c.valid, o.valid)
            return Column(data, DataType.from_numpy_dtype(numpy_dtype(data.dtype)), valid, None)

        return self._wrap(t._with_shards(t._per_shard(lambda s: OrderedDict(
            (n, col(s, c)) for n, c in t._shards[s].items()))))

    def __eq__(self, other):  # noqa: A003 (pycylon's elementwise equality)
        return self._binop(other, _op.eq)

    def __ne__(self, other):
        return self._binop(other, _op.ne)

    def __lt__(self, other):
        return self._binop(other, _op.lt)

    def __le__(self, other):
        return self._binop(other, _op.le)

    def __gt__(self, other):
        return self._binop(other, _op.gt)

    def __ge__(self, other):
        return self._binop(other, _op.ge)

    def __add__(self, other):
        return self._binop(other, _op.add)

    def __sub__(self, other):
        return self._binop(other, _op.sub)

    def __mul__(self, other):
        return self._binop(other, _op.mul)

    def __truediv__(self, other):
        return self._binop(other, _op.truediv)

    def __and__(self, other):
        return self._binop(other, _op.and_)

    def __or__(self, other):
        return self._binop(other, _op.or_)

    def __invert__(self):
        return self._binop(_UNARY, _c.bit_invert)

    # -- null handling, types, membership -----------------------------------
    def isnull(self) -> "DataFrame":
        return self._wrap(self._table.isnull())

    def notnull(self) -> "DataFrame":
        return self._wrap(self._table.notnull())

    def isna(self) -> "DataFrame":
        return self.isnull()

    def notna(self) -> "DataFrame":
        return self.notnull()

    def fillna(self, value) -> "DataFrame":
        return self._wrap(self._table.fillna(value))

    def dropna(self, axis: int = 0, how: str = "any") -> "DataFrame":
        """pandas' dropna: ``axis=0`` drops the rows holding a null (with
        ``how='all'``: only nulls), ``axis=1`` the columns
        (:func:`compute.drop_na`; ``Table.dropna`` keeps the reference's
        flipped axis)."""
        return self._wrap(_c.drop_na(self._table, how=how, axis=axis))

    def astype(self, dtype) -> "DataFrame":
        return self._wrap(self._table.astype(dtype))

    def applymap(self, fn) -> "DataFrame":
        """A Python function over every value, on the host."""
        return self._wrap(self._table.applymap(fn))

    def isin(self, values: Sequence) -> "DataFrame":
        """Elementwise membership of the raw values in ``values``, compared
        in their promoted type (the JAX package's ``jnp.isin``; not
        ``Table.isin``'s probe in the column's own type). A null stays
        null."""
        probe = torch.from_numpy(np.ascontiguousarray(np.asarray(values)))

        def isin(a):
            dt = _c.promote(a.dtype, probe)
            return torch.isin(a.to(dt), probe.to(device=a.device, dtype=dt))

        return self._binop(_UNARY, isin)

    # -- relational (env switches local/distributed; reference
    #    frame.py:1115-1242) ------------------------------------------
    def join(
        self,
        other: "DataFrame",
        on=None,
        how: str = "left",
        lsuffix: str = "l",
        rsuffix: str = "r",
        algorithm: str = "sort",
        env: Optional[CylonEnv] = None,
        mode: str = "eager",
    ) -> "DataFrame":
        """pandas.DataFrame.join flavor: suffix-renames both sides'
        overlapping columns (reference frame.py:1115-1226). ``mode='fused'``
        runs the distributed join as the fused step (Table.distributed_join)."""
        _check_mode(mode, env)
        t = self._retarget(env)
        o = other._retarget(env)
        kwargs = dict(on=on, how=how, suffixes=(f"_{lsuffix}", f"_{rsuffix}"), algorithm=algorithm)
        if env is not None and env.is_distributed:
            return DataFrame(t.distributed_join(o, mode=mode, **kwargs))
        return DataFrame(t.join(o, **kwargs))

    def merge(
        self,
        right: "DataFrame",
        how: str = "inner",
        on=None,
        left_on=None,
        right_on=None,
        suffixes: Tuple[str, str] = ("_x", "_y"),
        algorithm: str = "sort",
        env: Optional[CylonEnv] = None,
        mode: str = "eager",
    ) -> "DataFrame":
        """pandas.merge semantics: with ``on=``, the output carries ONE key
        column (coalesced for outer joins). Reference frame.py:1244+.
        ``mode='fused'`` (a distributed env) runs the fused join."""
        _check_mode(mode, env)
        t = self._retarget(env)
        o = right._retarget(env)
        kwargs = dict(how=how, suffixes=suffixes, algorithm=algorithm)
        if env is not None and env.is_distributed and mode != "eager":
            kwargs["mode"] = mode
        if on is not None:
            kwargs["on"] = on
        else:
            kwargs["left_on"] = left_on
            kwargs["right_on"] = right_on
        if env is not None and env.is_distributed:
            joined = t.distributed_join(o, **kwargs)
        else:
            joined = t.join(o, **kwargs)
        if on is not None:
            keys = [on] if isinstance(on, str) else list(on)
            joined = _coalesce_keys(joined, keys, suffixes, how)
        return DataFrame(joined)

    def sort_values(
        self,
        by,
        ascending: Union[bool, Sequence[bool]] = True,
        env: Optional[CylonEnv] = None,
    ) -> "DataFrame":
        """The local sort, or ``distributed_sort`` under a distributed env."""
        t = self._retarget(env)
        if env is not None and env.is_distributed:
            return self._wrap(t.distributed_sort(by, ascending))
        return self._wrap(t.sort(by, ascending))

    def drop_duplicates(
        self,
        subset: Optional[Sequence[str]] = None,
        keep: str = "first",
        env: Optional[CylonEnv] = None,
    ) -> "DataFrame":
        """The local unique, or ``distributed_unique`` under a distributed
        env."""
        t = self._retarget(env)
        if env is not None and env.is_distributed:
            return self._wrap(t.distributed_unique(subset, keep))
        return self._wrap(t.unique(subset, keep))

    def groupby(self, by, env: Optional[CylonEnv] = None) -> "GroupByView":
        return GroupByView(self._retarget(env), by, env)

    @staticmethod
    def concat(
        objs: Sequence["DataFrame"],
        axis: int = 0,
        join: str = "outer",
        env: Optional[CylonEnv] = None,
    ) -> "DataFrame":
        """axis=0: :func:`concat`; axis=1: ``Table.concat(axis=1)``, aligned
        on the index (a distributed join under a distributed env)."""
        objs = [o for o in objs if o is not None]
        if axis == 0:
            return concat(objs, axis=0, env=env)
        if axis != 1:
            raise ValueError(f"invalid axis {axis}, must be 0 or 1")
        if join not in ("inner", "left", "right", "outer", "fullouter", "full_outer"):
            raise ValueError(f"unknown join {join!r}")
        tables = [d._retarget(env) for d in objs]
        return DataFrame(Table.concat(tables, axis=1, join=join,
                                      distributed=env is not None and env.world_size > 1))

    # -- indexing ----------------------------------------------------------
    def set_index(self, column) -> "DataFrame":
        return self._wrap(self._table.set_index(column))

    def reset_index(self) -> "DataFrame":
        return self._wrap(self._table.reset_index())

    @property
    def index(self):
        return self._table.index

    @property
    def loc(self):
        from .indexing import LocIndexer

        return _Wrapping(LocIndexer(self._table))

    @property
    def iloc(self):
        from .indexing import ILocIndexer

        return _Wrapping(ILocIndexer(self._table))

    # -- whole-frame reductions: {column: value} ---------------------------
    def sum(self):
        return {n: self._table.sum(n) for n in self.columns}

    def min(self):
        return {n: self._table.min(n) for n in self.columns}

    def max(self):
        return {n: self._table.max(n) for n in self.columns}

    def count(self):
        return {n: self._table.count(n) for n in self.columns}

    def mean(self):
        return {n: self._table.mean(n) for n in self.columns}

    def _retarget(self, env: Optional[CylonEnv]) -> Table:
        """The table on the env's context: moved through the host when it
        lives on another (as the reference frame converts local tables on
        distributed calls)."""
        t = self._table
        if env is None or t.ctx is env.context:
            return t
        return Table.from_pydict(env.context, t.to_pydict())


class GroupByView:
    """Deferred groupby: ``df.groupby('k').agg({'v': 'sum'})`` or
    ``.sum()/.min()/...`` like pycylon's groupby (data/groupby.pyx)."""

    def __init__(self, table: Table, by, env: Optional[CylonEnv]):
        self._table = table
        self._by = by
        self._env = env

    def agg(self, spec: Dict[str, Union[str, Sequence[str]]]) -> DataFrame:
        if self._env is not None and self._env.is_distributed:
            return DataFrame(self._table.distributed_groupby(self._by, spec))
        return DataFrame(self._table.groupby(self._by, spec))

    def _all_values(self, op: str) -> DataFrame:
        by = [self._by] if isinstance(self._by, (str, int)) else list(self._by)
        by_names = self._table._resolve_cols(by)
        vals = [n for n in self._table.column_names if n not in by_names]
        return self.agg({v: op for v in vals})

    def sum(self) -> DataFrame:
        return self._all_values("sum")

    def min(self) -> DataFrame:
        return self._all_values("min")

    def max(self) -> DataFrame:
        return self._all_values("max")

    def mean(self) -> DataFrame:
        return self._all_values("mean")

    def count(self) -> DataFrame:
        return self._all_values("count")

    def std(self) -> DataFrame:
        return self._all_values("std")

    def var(self) -> DataFrame:
        return self._all_values("var")

    def nunique(self) -> DataFrame:
        return self._all_values("nunique")


_UNARY = object()  # _binop's operand of a one-argument function


class _Wrapping:
    """A table indexer whose results come back as DataFrames."""

    def __init__(self, inner):
        self._inner = inner

    def __getitem__(self, item):
        return DataFrame(self._inner[item])


def _and_valid(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a & b.to(a.device)


def _coalesce_keys(t: Table, keys: Sequence[str], suffixes, how: str) -> Table:
    """After a same-name key join, collapse key_x / key_y into one column
    at key_x's place (pandas.merge semantics): the right key where a right
    join has it, else the left key where present, else the right one."""
    sx, sy = suffixes

    def coalesce(sh):
        new: "OrderedDict[str, Column]" = OrderedDict()
        for n, c in sh.items():
            base = n[: -len(sx)] if sx and n.endswith(sx) else None
            cy = sh.get(base + sy) if base in keys else None
            if cy is not None:
                first, second = (cy, c) if how == "right" else (c, cy)
                data = first.data
                if first.valid is not None:
                    data = torch.where(first.valid, first.data, second.data)
                valid = None
                if c.valid is not None and cy.valid is not None:
                    valid = c.valid | cy.valid
                new[base] = Column(data, c.dtype, valid, c.dictionary)
                continue
            if sy and n.endswith(sy) and n[: -len(sy)] in keys:
                continue  # coalesced above
            new[n] = c
        return new

    return t._with_shards(t._map_shards(coalesce))


def concat(dfs: Sequence[DataFrame], axis: int = 0, env: Optional[CylonEnv] = None) -> DataFrame:
    """Row-stack frames (the reference's frame concat), each moved to
    ``env``'s context first; as in the JAX package, axis=1 is
    :meth:`DataFrame.concat`'s alone."""
    if axis != 0:
        raise NotImplementedError("axis=1 concat not supported here; use DataFrame.concat")
    return DataFrame(_concat_tables([d._retarget(env) for d in dfs]))
