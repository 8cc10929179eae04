"""Pandas-like DataFrame facade and CylonEnv (counterpart of
cylon_tpu/frame.py), the part the join -> groupby flow of
``examples/join_groupby.py`` needs.

Reference analog: python/pycylon/frame.py. ``CylonEnv`` names the devices
a computation runs on; a ``DataFrame`` wraps a :class:`Table`, and the
``env=`` argument of ``merge`` / ``join`` / ``groupby`` switches between
the local ops and the distributed ones. ``CylonEnv(config=GPUConfig())`` is
the only change against pycylon; with
``GPUConfig(coordinator_address=..., num_processes=W, process_id=r)`` every
rank runs the same program on its own shard, as under ``mpirun``. The rest of the JAX package's DataFrame
(selection, arithmetic, sort, indexing, concat, ...) is ROADMAP.md A2.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from .column import Column
from .config import GPUConfig
from .context import CylonContext
from .table import Table, _not_ported


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


def _check_mode(mode: str) -> None:
    if mode == "fused":
        raise _not_ported("mode='fused'", "queue A6, the fused shuffle->join program")
    if mode != "eager":
        raise ValueError(f"unknown join mode {mode!r}")


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

    def __repr__(self):
        return repr(self._table)

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
        overlapping columns (reference frame.py:1115-1226)."""
        _check_mode(mode)
        t = self._retarget(env)
        o = other._retarget(env)
        kwargs = dict(on=on, how=how, suffixes=(f"_{lsuffix}", f"_{rsuffix}"), algorithm=algorithm)
        if env is not None and env.is_distributed:
            return DataFrame(t.distributed_join(o, **kwargs))
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
        column (coalesced for outer joins). Reference frame.py:1244+."""
        _check_mode(mode)
        t = self._retarget(env)
        o = right._retarget(env)
        kwargs = dict(how=how, suffixes=suffixes, algorithm=algorithm)
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

    def groupby(self, by, env: Optional[CylonEnv] = None) -> "GroupByView":
        return GroupByView(self._retarget(env), by, env)

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

    # not ported yet: each raises NotImplementedError naming ROADMAP A3
    def std(self) -> DataFrame:
        return self._all_values("std")

    def var(self) -> DataFrame:
        return self._all_values("var")

    def nunique(self) -> DataFrame:
        return self._all_values("nunique")


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
