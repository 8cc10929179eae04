"""Lazy logical plans with a rule-based optimizer (counterpart of
cylon_tpu/plan/).

- :mod:`nodes` — the plan IR (Scan/Project/Filter/Join/GroupBy/Sort/
  Shuffle/Union/Limit and the fused join-sum node) with schema,
  partitioning and ordering propagation;
- :mod:`expr` — the column expressions filters are written in;
- :mod:`rules` — filter pushdown, physicalize, shuffle elimination, the
  fused join -> groupby-sum pushdown, order reuse, projection pushdown;
- :mod:`lower` — the optimized plan onto the eager ``Table`` ops;
- :mod:`lazy` — ``LazyFrame`` (``Table.lazy()``) with ``.explain()`` and
  ``.collect()``, over the plan cache of ``engine.py``.
"""
from .expr import Expr, col, lit
from .lazy import LazyFrame

__all__ = ["Expr", "LazyFrame", "col", "lit"]
