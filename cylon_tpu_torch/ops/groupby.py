"""Sort/segment-based groupby-aggregate (counterpart of
cylon_tpu/ops/groupby.py).

Group ids come from :func:`factorize` (lexsort + run-detect, kernel K1):
dense and in sorted key order, so the groups come out key-sorted. The
aggregates are segment reductions into exact-length outputs.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from .factorize import factorize
from .sort import KeyCol, wide_float, wide_int

SUM, COUNT, MIN, MAX, MEAN, VAR, STDDEV, NUNIQUE, QUANTILE, COUNT_DISTINCT = range(10)

_AGG_NAMES = {
    "sum": SUM, "count": COUNT, "min": MIN, "max": MAX, "mean": MEAN,
    "avg": MEAN, "var": VAR, "std": STDDEV, "stddev": STDDEV,
    "nunique": NUNIQUE, "quantile": QUANTILE, "median": QUANTILE,
    "count_distinct": NUNIQUE, "size": COUNT,
}

#: the aggregations this slice ports
PORTED = frozenset({SUM, COUNT, MIN, MAX, MEAN})
#: ops a distributed groupby may pre-combine per shard before its shuffle
ASSOCIATIVE = frozenset({SUM, MIN, MAX})


def agg_op_id(name) -> int:
    if isinstance(name, int):
        op = name
    else:
        try:
            op = _AGG_NAMES[name.lower()]
        except KeyError:
            raise ValueError(f"unknown aggregation {name!r}") from None
    if op not in PORTED:
        raise NotImplementedError(
            f"aggregation {name!r} is not ported yet (ROADMAP.md queue A: "
            "the remaining groupby aggregations var/std/nunique/quantile)"
        )
    return op


def group_ids(key_cols: Sequence[KeyCol]) -> Tuple[torch.Tensor, int]:
    """(ids [n] int32, number of groups)."""
    return factorize(key_cols)


def group_representatives(ids: torch.Tensor, num_groups: int) -> torch.Tensor:
    """First row (int64) of each group id."""
    n = ids.shape[0]
    rows = torch.arange(n, dtype=torch.int64, device=ids.device)
    rep = torch.full((num_groups,), n, dtype=torch.int64, device=ids.device)
    return rep.scatter_reduce_(0, ids.to(torch.int64), rows, "amin")


def _seg(vals, ids, num_groups, reduce: str, init):
    """Segment reduction; id ``num_groups`` is a discard slot."""
    out = torch.full((num_groups + 1,), init, dtype=vals.dtype, device=vals.device)
    if reduce == "sum":
        out.index_add_(0, ids, vals)
    else:
        out.scatter_reduce_(0, ids, vals, reduce, include_self=True)
    return out[:num_groups]


_I64_MIN = -(2**63)


def _signed_work(data: torch.Tensor):
    """(order-preserving tensor torch can reduce, inverse map): torch's
    segment reductions skip uint16/32/64, so those go through int64."""
    dt = data.dtype
    if dt in (torch.uint16, torch.uint32):
        return data.to(torch.int64), lambda x: x.to(dt)
    if dt == torch.uint64:
        return data.view(torch.int64) ^ _I64_MIN, lambda x: (x ^ _I64_MIN).view(dt)
    return data, lambda x: x


def _type_extrema(dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("inf"), float("-inf")
    info = torch.iinfo(dtype)
    return info.max, info.min


def aggregate_column(
    op: int,
    data: torch.Tensor,
    valid: Optional[torch.Tensor],
    ids: torch.Tensor,
    num_groups: int,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Aggregate one value column over group ids; nulls are skipped (count
    counts non-null). Returns (out [num_groups], valid-or-None)."""
    ids = ids.to(torch.int64)
    live_ids = ids if valid is None else torch.where(valid, ids, num_groups)
    ones = torch.ones_like(live_ids, dtype=wide_int())
    cnt = _seg(ones, live_ids, num_groups, "sum", 0)
    if op == COUNT:
        return cnt, None
    if op == SUM:
        acc = data.to(wide_int()) if not (data.dtype.is_floating_point or data.dtype == torch.bool) else data
        s = _seg(acc, live_ids, num_groups, "sum", 0)
        return s, (cnt > 0) if valid is not None else None
    if op in (MIN, MAX):
        work, back = _signed_work(data)
        hi, lo = _type_extrema(work.dtype)
        if op == MIN:
            out = _seg(work, live_ids, num_groups, "amin", hi)
        else:
            out = _seg(work, live_ids, num_groups, "amax", lo)
        return back(out), (cnt > 0) if valid is not None else None
    if op == MEAN:
        s = _seg(data.to(wide_float()), live_ids, num_groups, "sum", 0.0)
        return s / cnt.clamp(min=1), cnt > 0
    raise NotImplementedError(f"aggregation op {op} is not ported yet")
