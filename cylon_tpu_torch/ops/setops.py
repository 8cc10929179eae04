"""Set operations over whole rows: unique / union / intersect / subtract
(counterpart of cylon_tpu/ops/setops.py).

The set algebra runs in sorted space, as in the JAX package: one stable
lexsort (kernel K1) orders the rows of one table, or of both tables
concatenated left first, by their canonical key lanes (ops/sort.py); run
boundaries and run counts decide which rows are kept. The kept rows come
back in ascending original-row order, which is first-occurrence order
(pandas' and the reference's keep-first): the keep mask is scattered back
to row order once and front-packed (:func:`compact_mask`), where the JAX
package sorts by a sentinel key. Each emit returns (idx [n] int64 with -1
padding, count as a device scalar), so a caller reads every shard's count
in one host sync.

Over input already sorted by its keys (an ordering descriptor proves it,
``Table.unique`` / ``Table.union`` and the rest decide), the ``*_sorted``
emits run-detect, and probe the other side with a binary search, in place
of the shared sort: the same rows in the same order.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..dtypes import promote_key_dtypes
from .sort import (
    KeyCol,
    _sortable,
    canonical_row_lanes,
    lane_runs_differ,
    lanes_differ,
    lexsort_indices,
    orderable_key,
    rows_differ,
    run_count_from,
    sorted_runs,
)


def compact_mask(mask: torch.Tensor, cap_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Front-pack the indices of True entries, with no host sync.

    Returns (idx [cap_out] int64 with -1 padding, count as a device int64
    scalar). The surviving indices are in ascending order: the result is
    the JAX package's stable argsort of ``~mask``, built here as one
    scatter to distinct destinations (True entries to their rank, False
    entries behind them)."""
    n = mask.shape[0]
    m = mask.to(torch.int64)
    rank = torch.cumsum(m, 0) - m  # True entries before me
    total = m.sum()
    idx = torch.arange(n, dtype=torch.int64, device=mask.device)
    dest = torch.where(mask, rank, total + idx - rank)  # a permutation of [0, n)
    order = torch.empty_like(idx).scatter_(0, dest, idx)
    if cap_out <= n:
        order = order[:cap_out]
    else:
        order = torch.cat([order, order.new_full((cap_out - n,), -1)])
    keep = torch.arange(cap_out, dtype=torch.int64, device=mask.device) < total
    return torch.where(keep, order, -1), total


def _emit_by_pay(keep: torch.Tensor, spay: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kept rows of sorted space back in ascending original-row order:
    ``keep`` scattered to row order through ``spay`` (the sorted position's
    original row), then front-packed."""
    rows = torch.zeros_like(keep).scatter_(0, spay.to(torch.int64), keep)
    return compact_mask(rows, rows.shape[0])


def _unique_keep(
    key_cols: Sequence[KeyCol], keep: str, order_lane: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(keep mask in sorted space, spay) for single-table dedup.

    ``order_lane``: an optional least-significant ordering lane (a global
    row id carried through a shuffle) that decides which duplicate is
    "first"/"last" in place of the row position; runs are still detected
    from the key lanes alone."""
    lanes = canonical_row_lanes(key_cols)  # msb first
    if order_lane is None:
        spay, new_run = sorted_runs(lanes)
    else:
        n = order_lane.shape[0]
        spay = lexsort_indices(list(reversed(lanes + [order_lane])), n)
        new_run = lane_runs_differ([lane.index_select(0, spay) for lane in lanes])
    if keep == "last":
        # within a run rows are in (order lane, row) order: keep its last,
        # the row before the next run's start (new_run[0] is True)
        return torch.roll(new_run, -1), spay
    return new_run, spay


def unique_emit(
    key_cols: Sequence[KeyCol], keep: str = "first", order_lane: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row indices of the deduplicated table, in row order."""
    return _emit_by_pay(*_unique_keep(key_cols, keep, order_lane))


def concat_two_tables(l_cols: Sequence[KeyCol], r_cols: Sequence[KeyCol]) -> List[KeyCol]:
    """Column-wise [left ++ right] with key-dtype promotion (numpy rules)
    and merged validity: row i < n_l is left row i, row n_l + j right row j."""
    out: List[KeyCol] = []
    for (ld, lv), (rd, rv) in zip(l_cols, r_cols):
        if ld.dtype != rd.dtype:
            common = promote_key_dtypes(ld.dtype, rd.dtype)
            ld, rd = ld.to(common), rd.to(common)
        valid = None
        if lv is not None or rv is not None:
            lv = torch.ones_like(ld, dtype=torch.bool) if lv is None else lv
            rv = torch.ones_like(rd, dtype=torch.bool) if rv is None else rv
            valid = torch.cat([lv, rv])
        out.append((torch.cat([ld, rd]), valid))
    return out


def _two_table_sorted(l_cols: Sequence[KeyCol], r_cols: Sequence[KeyCol]):
    """One stable sort of both tables' rows by canonical key lanes:
    (spay, new_run, whether the sorted row is a left row, the
    concatenation). Lefts precede rights within a run, so a run's first
    row is a left whenever it has one."""
    n_l = l_cols[0][0].shape[0]
    cat_cols = concat_two_tables(l_cols, r_cols)
    spay, new_run = sorted_runs(canonical_row_lanes(cat_cols))
    return spay, new_run, spay < n_l, cat_cols


def union_emit(l_cols: Sequence[KeyCol], r_cols: Sequence[KeyCol]):
    """Distinct union: the first row of every run of the shared sort, which
    is its first occurrence in [left ++ right]. Returns (idx, count, the
    concatenation ``idx`` indexes)."""
    spay, new_run, _is_l, cat_cols = _two_table_sorted(l_cols, r_cols)
    idx, total = _emit_by_pay(new_run, spay)
    return idx, total, cat_cols


def setop_emit(l_cols: Sequence[KeyCol], r_cols: Sequence[KeyCol], want_in_r: bool):
    """Subtract (``want_in_r`` False) or intersect (True): the first left
    row of each run that does not / does hold a right row. Returns (idx
    into the left rows, count)."""
    spay, new_run, is_l, _cat = _two_table_sorted(l_cols, r_cols)
    # read at run starts only, where count-from is the run's total
    r_in_run = run_count_from(new_run, ~is_l)
    hit = r_in_run > 0 if want_in_r else r_in_run == 0
    return _emit_by_pay(new_run & is_l & hit, spay)


# ---------------------------------------------------------------------------
# sorted-input fast paths (the JAX package's *_emit_sorted): the caller
# proves the order through the table's ordering descriptor
# ---------------------------------------------------------------------------
def unique_emit_sorted(key_cols: Sequence[KeyCol], keep: str = "first"):
    """:func:`unique_emit` over rows already canonically ordered by the
    key columns: run starts (keep "first") or run ends ("last") in row
    order, with no sort."""
    n = key_cols[0][0].shape[0]
    diff = rows_differ(key_cols)
    if keep == "last" and n:
        diff = torch.cat([diff[1:], diff.new_ones(1)])
    return compact_mask(diff, n)


def _promoted_lanes(ld: torch.Tensor, rd: torch.Tensor):
    """Orderable lanes of a mask-free column pair in one dtype, as
    tensors whose signed order is the lanes' order (for searchsorted)."""
    if ld.dtype != rd.dtype:
        common = promote_key_dtypes(ld.dtype, rd.dtype)
        ld, rd = ld.to(common), rd.to(common)
    return _sortable(orderable_key(ld)), _sortable(orderable_key(rd))


def _member_sorted(lane_q: torch.Tensor, lane_s: torch.Tensor) -> torch.Tensor:
    """Whether each query value is in the SORTED ``lane_s``."""
    if lane_s.shape[0] == 0:
        return torch.zeros_like(lane_q, dtype=torch.bool)
    pos = torch.searchsorted(lane_s, lane_q)
    hit = lane_s.index_select(0, pos.clamp(max=lane_s.shape[0] - 1))
    return (pos < lane_s.shape[0]) & ~lanes_differ(hit, lane_q)


def _first_occurrence(lane: torch.Tensor) -> torch.Tensor:
    first = torch.ones_like(lane, dtype=torch.bool)
    first[1:] = lanes_differ(lane[1:], lane[:-1])
    return first


def setop_emit_sorted(l_cols: Sequence[KeyCol], r_cols: Sequence[KeyCol], want_in_r: bool):
    """:func:`setop_emit` for one mask-free column, both sides sorted
    ascending: the left's run starts, kept where a binary search finds
    (intersect) or misses (subtract) them in the right."""
    llane, rlane = _promoted_lanes(l_cols[0][0], r_cols[0][0])
    found = _member_sorted(llane, rlane)
    hit = found if want_in_r else ~found
    return compact_mask(_first_occurrence(llane) & hit, llane.shape[0])


def union_emit_sorted(l_cols: Sequence[KeyCol], r_cols: Sequence[KeyCol]):
    """:func:`union_emit` for one mask-free column, both sides sorted
    ascending: every left run start, and the right run starts the left
    lacks: first occurrences in [left ++ right]."""
    llane, rlane = _promoted_lanes(l_cols[0][0], r_cols[0][0])
    keep = torch.cat([_first_occurrence(llane), _first_occurrence(rlane) & ~_member_sorted(rlane, llane)])
    idx, total = compact_mask(keep, keep.shape[0])
    return idx, total, concat_two_tables(l_cols, r_cols)
