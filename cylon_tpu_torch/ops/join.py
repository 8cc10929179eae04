"""Sort-based equi-join (counterpart of cylon_tpu/ops/join.py).

The algorithm is the JAX package's:

  1. canonical ids: one orderable uint32 lane for a single null-free key of
     <= 32 bits, else a joint factorization of both sides' keys;
  2. the right rows in key order (radix argsort, kernel K1);
  3. the probe: ONE merged stable kv-sort of [right ids ++ left ids] (K1)
     plus run scans gives each left row its match window (lo, cnt), and
     each right row its match count for RIGHT / FULL OUTER joins;
  4. the exact output size (:func:`spec_probe` ends here), read with one
     host sync for every shard and checked before any shard emits;
  5. the emit into exact-length outputs. INNER / LEFT compact the emitting
     left rows to the front and expand them with the windowed expand
     (kernel K2); RIGHT / FULL OUTER build (left, right) index pairs with
     -1 on the null side and gather.

Tables carry no padding, so the JAX package's speculative single-dispatch
join and its exact two-phase join are one path here: probe, read the
total, allocate, emit.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..dtypes import promote_key_dtypes
from . import cuda_gather as _cg
from . import radix as _radix
from .factorize import factorize_two
from .gather import gather_rows, pack_cols, pack_gather, unpack_cols
from .sort import (
    KeyCol,
    orderable_key,
    run_count_from,
    run_count_upto,
    run_start_broadcast,
    sentinel_compact,
)

INNER, LEFT, RIGHT, FULL_OUTER = 0, 1, 2, 3
_JOIN_TYPES = {"inner": INNER, "left": LEFT, "right": RIGHT, "fullouter": FULL_OUTER,
               "outer": FULL_OUTER, "full_outer": FULL_OUTER}

#: output rows addressable by the int32 row ids of the kernels
MAX_ROWS = 2**31 - 1


def join_type_id(how: str) -> int:
    try:
        return _JOIN_TYPES[how.replace("-", "_").lower()]
    except KeyError:
        raise ValueError(f"unknown join type {how!r}") from None


def _fast_path_ok(cols: Sequence[KeyCol]) -> bool:
    """Single null-free key of <= 32 bits (not float64): its orderable lane
    is one uint32, no factorize needed."""
    if len(cols) != 1:
        return False
    data, valid = cols[0]
    if valid is not None:
        return False
    return data.element_size() <= 4


def _canonical_ids(
    l_key_cols: Sequence[KeyCol], r_key_cols: Sequence[KeyCol]
) -> Tuple[torch.Tensor, torch.Tensor, Optional[_radix.Hint]]:
    """Comparable key ids of one integer dtype for both tables, plus the
    radix hint of the id lane: the uint32 fast path keeps its full 32-bit
    span, factorized ids are dense and bounded by nl + nr."""
    if (
        len(l_key_cols) == 1
        and len(r_key_cols) == 1
        and l_key_cols[0][0].dtype != r_key_cols[0][0].dtype
    ):
        common = promote_key_dtypes(l_key_cols[0][0].dtype, r_key_cols[0][0].dtype)
        l_key_cols = [(l_key_cols[0][0].to(common), l_key_cols[0][1])]
        r_key_cols = [(r_key_cols[0][0].to(common), r_key_cols[0][1])]
    if _fast_path_ok(l_key_cols) and _fast_path_ok(r_key_cols):
        return orderable_key(l_key_cols[0][0]), orderable_key(r_key_cols[0][0]), None
    l_ids, r_ids = factorize_two(l_key_cols, r_key_cols)
    n = l_ids.shape[0] + r_ids.shape[0]
    return l_ids, r_ids, _radix.bound_hint(n)


def _merged_counts(
    l_ids: torch.Tensor, r_ids: torch.Tensor, hint, need_rcnt: bool
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(lo, cnt, r_cnt) of the equi-join probe from ONE merged kv-sort.

    Stable sort of [r_ids ++ l_ids]: inside an equal-key run the rights
    precede the lefts, so for a left at sorted position p,
      lo[p]  = rights before p's run (run-start broadcast of a prefix sum),
      cnt[p] = rights inside the run (rights in the run up to p).
    Both return to row order by one scatter through the sort's payload.
    r_cnt mirrors it: counting lefts at/after a right position sees the
    run's lefts."""
    nl, nr = l_ids.shape[0], r_ids.shape[0]
    device = l_ids.device
    keys = torch.cat([r_ids, l_ids])
    pay = torch.arange(nr + nl, dtype=torch.int32, device=device)
    skey, spay = _radix.kv_sort(keys, pay, hint)
    is_r = spay < nr
    rl = is_r.to(torch.int64)
    r_excl = torch.cumsum(rl, 0) - rl
    new_run = torch.ones(nr + nl, dtype=torch.bool, device=device)
    new_run[1:] = skey[1:] != skey[:-1]
    lo_run = run_start_broadcast(new_run, r_excl)
    cnt_p = run_count_upto(new_run, is_r)
    # back to [right rows ++ left rows] order; the left part is the probe
    lo, cnt = (x[nr:] for x in sentinel_compact(spay, [lo_run, cnt_p]))
    if not need_rcnt:
        return lo, cnt, None
    (r_cnt,) = sentinel_compact(spay, [run_count_from(new_run, ~is_r)])
    return lo, cnt, r_cnt[:nr]


def count_from_probe(cnt, r_cnt, how: int) -> torch.Tensor:
    """Exact output row count (device int64 scalar)."""
    total = cnt.sum()
    if how in (LEFT, FULL_OUTER):
        total = total + (cnt == 0).sum()
    if how in (RIGHT, FULL_OUTER):
        total = total + (r_cnt == 0).sum()
    return total


def count_overflow_check(total: int) -> None:
    """Reject outputs the kernels' int32 row ids cannot address."""
    if total > MAX_ROWS:
        raise ValueError(
            f"join output of {total} rows on one shard exceeds {MAX_ROWS} rows (int32 row "
            "ids); repartition the inputs or reduce the skew"
        )


def _repeat_ss(ends: torch.Tensor, cap_out: int) -> torch.Tensor:
    """``repeat(arange(n), counts)`` into ``cap_out`` rows (int32), counts
    given by their inclusive cumsum ``ends``: output k belongs to the first
    row whose end is past k, ``#(ends <= k)`` — the JAX package's argsort
    variant, as a binary search. Positions past the last end get ``n``
    (callers mask them)."""
    pos = torch.arange(cap_out, dtype=ends.dtype, device=ends.device)
    return torch.searchsorted(ends, pos, right=True, out_int32=True)


def emit_from_probe(lo, cnt, r_order, r_cnt, how: int, total: int):
    """(left idx, right idx) int64 pairs of every output row, -1 on the
    null side of an outer join."""
    device = lo.device
    nl, nr = lo.shape[0], r_order.shape[0]
    cnt_adj = torch.where(cnt == 0, torch.ones_like(cnt), cnt) if how in (LEFT, FULL_OUTER) else cnt
    ends = torch.cumsum(cnt_adj, 0)
    offs = ends - cnt_adj
    total_l = ends[-1] if nl else torch.zeros((), dtype=torch.int64, device=device)
    li = _repeat_ss(ends, total).to(torch.int64)
    out_pos = torch.arange(total, dtype=torch.int64, device=device)
    base = lo - offs
    has_match = gather_rows(cnt, li) > 0
    rpos = gather_rows(base, li) + out_pos
    ri = torch.where(has_match, gather_rows(r_order, rpos).to(torch.int64), -1)
    in_left = out_pos < total_l
    li = torch.where(in_left, li, -1)
    ri = torch.where(in_left, ri, -1)
    if how in (RIGHT, FULL_OUTER):
        # unmatched right rows append after the left part; the others land
        # in distinct slots past the output, sliced off
        r_un = r_cnt == 0
        rank = torch.cumsum(r_un.to(torch.int64), 0) - 1
        idx_r = torch.arange(nr, dtype=torch.int64, device=device)
        dest = torch.where(r_un, total_l + rank, total + idx_r)
        li = torch.cat([li, li.new_full((nr,), -1)])
        ri = torch.cat([ri, ri.new_full((nr,), -1)])
        ri.scatter_(0, dest, idx_r)
        li.scatter_(0, dest, torch.full_like(idx_r, -1))
        li, ri = li[:total], ri[:total]
    return li, ri


def emit_gather(lo, cnt, r_order, r_cnt, l_cols, r_cols, how: int, total: int):
    """RIGHT / FULL OUTER emit: index pairs, then one packed gather a side."""
    li, ri = emit_from_probe(lo, cnt, r_order, r_cnt, how, total)
    return pack_gather(l_cols, li) + pack_gather(r_cols, ri)


def _emit_inner_left(
    lo, cnt, l_cols: Sequence[KeyCol], r_sorted_cols: Sequence[KeyCol],
    how: int, total: int,
) -> List[KeyCol]:
    """INNER / LEFT emit against the key-sorted right payload.

    The left rows that emit are compacted to the front (a stable
    partition, order-preserving), so the output's left row ids
    ``repeat(arange(m), counts)`` step by at most one, and the left columns
    plus the bookkeeping lanes (lo, cnt, output offset) are
    expanded in one launch of K2. The right columns are gathered at
    ``lo - offset + output position`` (not monotone: a plain gather)."""
    device = lo.device
    nl = lo.shape[0]
    cnt_adj = torch.where(cnt == 0, torch.ones_like(cnt), cnt) if how == LEFT else cnt
    emitting = cnt_adj > 0
    em = emitting.to(torch.int64)
    slot = torch.cumsum(em, 0) - em  # emitting rows before me
    idx_l = torch.arange(nl, dtype=torch.int64, device=device)
    n_emit = slot[-1:] + em[-1:] if nl else slot
    dest = torch.where(emitting, slot, n_emit + idx_l - slot)  # a permutation

    plan, lanes = pack_cols(l_cols)
    n_payload = len(lanes)
    lanes = lanes + [lo.to(torch.int32), cnt.to(torch.int32), cnt_adj.to(torch.int32)]
    stacked = torch.stack(lanes, 0)
    packed_c = torch.empty_like(stacked).index_copy_(1, dest, stacked)
    cnt_adj_c = packed_c[-1].to(torch.int64)
    ends_c = torch.cumsum(cnt_adj_c, 0)
    li_c = _repeat_ss(ends_c, total)
    packed_c[-1] = (ends_c - cnt_adj_c).to(torch.int32)  # output offset lane
    outT = _cg.expand_rows(packed_c, li_c)
    lo_g = outT[n_payload].to(torch.int64)
    cnt_g = outT[n_payload + 1]
    offs_g = outT[n_payload + 2].to(torch.int64)

    out_l, _ = unpack_cols(
        plan, list(outT[:n_payload].unbind(0)),
        lambda lane: None if lane is None else lane.to(torch.bool),
    )
    out_pos = torch.arange(total, dtype=torch.int64, device=device)
    rpos = torch.where(cnt_g > 0, lo_g - offs_g + out_pos, -1)
    return out_l + pack_gather(r_sorted_cols, rpos)


def spec_probe(
    l_key_cols: Sequence[KeyCol],
    r_key_cols: Sequence[KeyCol],
    r_cols: Sequence[KeyCol],
    how: int,
) -> dict:
    """Probe + count of one shard, with no host sync: the state
    :func:`spec_emit` takes, ``"total"`` the output row count as a device
    scalar. A caller reads every shard's count (every rank's, under
    torch.distributed), checks them all with :func:`count_overflow_check`,
    so that every rank raises alike, then emits."""
    l_ids, r_ids, hint = _canonical_ids(l_key_cols, r_key_cols)
    if how in (INNER, LEFT):
        # id lanes are integers, so the radix engine never declines them
        r_sorted = pack_gather(r_cols, _radix.argsort_perm(r_ids, hint), all_valid=True)
        lo, cnt, r_cnt = _merged_counts(l_ids, r_ids, hint, need_rcnt=False)
        return {"lo": lo, "cnt": cnt, "r_sorted": r_sorted,
                "total": count_from_probe(cnt, r_cnt, how)}
    lo, cnt, r_cnt = _merged_counts(l_ids, r_ids, hint, need_rcnt=True)
    return {"lo": lo, "cnt": cnt, "r_cnt": r_cnt, "r_order": _radix.argsort_perm(r_ids, hint),
            "total": count_from_probe(cnt, r_cnt, how)}


def spec_emit(
    probe: dict, l_cols: Sequence[KeyCol], r_cols: Sequence[KeyCol], how: int, total: int
) -> List[KeyCol]:
    """The output columns (left ++ right) of a :func:`spec_probe` whose
    row count ``total`` the caller has read and checked."""
    if how in (INNER, LEFT):
        return _emit_inner_left(probe["lo"], probe["cnt"], l_cols, probe["r_sorted"], how, total)
    return emit_gather(probe["lo"], probe["cnt"], probe["r_order"], probe["r_cnt"],
                       l_cols, r_cols, how, total)
