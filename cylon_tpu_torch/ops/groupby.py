"""Sort/segment-based groupby-aggregate (counterpart of
cylon_tpu/ops/groupby.py).

Group ids come from :func:`factorize` (lexsort + run-detect, kernel K1):
dense and in sorted key order, so the groups come out key-sorted; over
input already sorted by its keys, :func:`sorted_group_ids` run-detects
without the lexsort (the pipeline groupby). The aggregates are segment
reductions into exact-length outputs; nunique and quantile first lexsort
(group id, value) through K1, as the JAX package does.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from . import radix as _radix
from .factorize import factorize
from .sort import KeyCol, lexsort_indices, orderable_key, rows_differ, wide_float, wide_int

SUM, COUNT, MIN, MAX, MEAN, VAR, STDDEV, NUNIQUE, QUANTILE, COUNT_DISTINCT = range(10)

_AGG_NAMES = {
    "sum": SUM, "count": COUNT, "min": MIN, "max": MAX, "mean": MEAN,
    "avg": MEAN, "var": VAR, "std": STDDEV, "stddev": STDDEV,
    "nunique": NUNIQUE, "quantile": QUANTILE, "median": QUANTILE,
    "count_distinct": NUNIQUE, "size": COUNT,
}

#: the aggregations the port runs (COUNT_DISTINCT is a name of NUNIQUE)
PORTED = frozenset({SUM, COUNT, MIN, MAX, MEAN, VAR, STDDEV, NUNIQUE, QUANTILE})
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
        raise ValueError(f"unsupported aggregation op {name!r}")
    return op


def group_ids(key_cols: Sequence[KeyCol], fuse=None) -> Tuple[torch.Tensor, int]:
    """(ids [n] int32, number of groups). ``fuse``: the canonical lanes'
    sort-word fusion plan (ops/sort.FusePlan), the same ids."""
    return factorize(key_cols, fuse=fuse)


def sorted_group_ids(key_cols: Sequence[KeyCol]) -> Tuple[torch.Tensor, int]:
    """Group ids of input ALREADY sorted by its key columns: one
    run-detection pass, no lexsort (the JAX package's ``sorted_group_ids``,
    the reference's PipelineGroupBy). A row starts a group where any key
    differs from the row before; null == null, and a null differs from a
    value. Same contract as :func:`group_ids`; the ids follow the input's
    run order."""
    n = key_cols[0][0].shape[0]
    device = key_cols[0][0].device
    if n == 0:
        return torch.zeros(0, dtype=torch.int32, device=device), 0
    diff = rows_differ(key_cols)
    ids = torch.cumsum(diff.to(torch.int32), 0, dtype=torch.int32) - 1
    return ids, int(ids[-1].item()) + 1


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


def _sorted_by_group(data: torch.Tensor, live_ids: torch.Tensor, num_groups: int):
    """Stable lexsort of the rows by (group id, value), the id most
    significant (one K1 lexsort; a float64 value lane declines to
    ``torch.sort``, as in the JAX package): the permutation. Nulls carry
    the discard id ``num_groups`` and sort behind every group."""
    lanes = [orderable_key(data), live_ids.to(torch.int32)]
    return lexsort_indices(lanes, data.shape[0], [None, _radix.bound_hint(num_groups)])


def aggregate_column(
    op: int,
    data: torch.Tensor,
    valid: Optional[torch.Tensor],
    ids: torch.Tensor,
    num_groups: int,
    ddof: int = 1,
    quantile: float = 0.5,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Aggregate one value column over group ids; nulls are skipped (count
    counts non-null). Returns (out [num_groups], valid-or-None). The
    arithmetic of var/std/nunique/quantile is the JAX package's, step for
    step (cylon_tpu/ops/groupby.py:157-196)."""
    ids = ids.to(torch.int64)
    live_ids = ids if valid is None else torch.where(valid, ids, num_groups)
    ones = torch.ones_like(live_ids, dtype=wide_int())
    cnt = _seg(ones, live_ids, num_groups, "sum", 0)
    if op == COUNT:
        return cnt, None
    if data.dtype == torch.bool and op in (SUM, MIN, MAX):
        # the JAX package's segment reductions refuse a bool column: its sum
        # raises TypeError, its min/max ValueError (no integer extrema of b)
        if op == SUM:
            raise TypeError("sum does not accept a bool column; cast it to an integer type")
        raise ValueError("min/max do not accept a bool column; cast it to an integer type")
    if op == SUM:
        acc = data if data.dtype.is_floating_point else data.to(wide_int())
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
    if op in (VAR, STDDEV):
        # one pass: (sum of squares - sum * mean) / max(count - ddof, 1),
        # clamped at 0; valid only where count > ddof
        x = data.to(wide_float())
        if valid is not None:
            x = torch.where(valid, x, torch.zeros_like(x))
        s = _seg(x, live_ids, num_groups, "sum", 0.0)
        ss = _seg(x * x, live_ids, num_groups, "sum", 0.0)
        mean = s / cnt.clamp(min=1)
        # ss - s * mean as one fused multiply-add, as XLA contracts it: the
        # variance of a one-valued group is then the product's rounding
        # residue, not 0, in both packages
        var = (torch.addcmul(ss, s, mean, value=-1.0) / (cnt - ddof).clamp(min=1)).clamp(min=0.0)
        return (var.sqrt() if op == STDDEV else var), cnt > ddof
    if op == NUNIQUE:
        # distinct (group, value) pairs: lexsort, then count the pair
        # starts of each group. A NaN value counts as 0.0 (a NaN and a 0.0
        # of one group are one value), as in the JAX package: a quirk
        # reproduced, not pandas' nunique
        d = data
        if d.dtype.is_floating_point:
            d = torch.where(torch.isnan(d), torch.zeros_like(d), d)
        order = _sorted_by_group(d, live_ids, num_groups).to(torch.int64)
        sid, sval = live_ids.index_select(0, order), d.index_select(0, order)
        newpair = torch.ones_like(sid, dtype=torch.bool)
        newpair[1:] = (sid[1:] != sid[:-1]) | (sval[1:] != sval[:-1])
        return _seg(newpair.to(wide_int()), sid, num_groups, "sum", 0), None
    if op == QUANTILE:
        # linear interpolation from the group's start in (group, value)
        # order: position start + q * max(count - 1, 0)
        n = data.shape[0]
        order = _sorted_by_group(data, live_ids, num_groups).to(torch.int64)
        sid = live_ids.index_select(0, order)
        sval = data.index_select(0, order).to(wide_float())
        groups = torch.arange(num_groups, dtype=sid.dtype, device=sid.device)
        starts = torch.searchsorted(sid, groups)
        pos = starts.to(wide_float()) + quantile * (cnt - 1).clamp(min=0).to(wide_float())
        lo_i = torch.floor(pos).to(torch.int64).clamp(0, max(n - 1, 0))
        hi_i = torch.ceil(pos).to(torch.int64).clamp(0, max(n - 1, 0))
        frac = pos - torch.floor(pos)
        if n == 0:
            out = torch.zeros_like(pos)
        else:
            out = sval.index_select(0, lo_i) * (1 - frac) + sval.index_select(0, hi_i) * frac
        has = cnt > 0
        return torch.where(has, out, torch.zeros_like(out)), has
    raise ValueError(f"unsupported aggregation op {op}")
