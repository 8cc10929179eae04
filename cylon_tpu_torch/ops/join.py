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

Two order-aware forms (ROADMAP.md A4): a right side whose ordering
descriptor proves it key-sorted skips step 2 (``r_presorted``), and the
key-order emit (the JAX package's ``_key_order_emit``: :func:`spec_probe`
with ``emit_key_order``, then :func:`spec_emit`) emits INNER / LEFT rows
grouped by key straight out of the merged sort. :func:`join_sum_by_key_pushdown` fuses
an inner join with a sum of a left column by the join key into that one
merged sort.
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

#: slots behind a padded segment sum that take its dead rows, spread so
#: that their atomic adds do not serialize on one address
DISCARD_SLOTS = 4096


def discard_targets(tgt: torch.Tensor, drop: Optional[torch.Tensor], cap: int) -> torch.Tensor:
    """Segment-sum slots for :func:`padded_seg_add`: ``tgt`` where it is
    below ``cap`` and the row is not dropped; else one of the
    DISCARD_SLOTS slots behind the ``cap`` live ones, spread by row.
    Without ``drop`` (an unpadded input, whose targets stay below an exact
    ``cap``) a target past ``cap`` clamps to the first discard slot."""
    if drop is None:
        return tgt.clamp(max=cap)
    spill = cap + torch.arange(tgt.shape[0], device=tgt.device) % DISCARD_SLOTS
    return torch.where(drop | (tgt >= cap), spill, tgt)


def padded_seg_add(x: torch.Tensor, tgt: torch.Tensor, cap: int) -> torch.Tensor:
    """Segment sum of ``x`` into ``cap`` slots at ``tgt`` (from
    :func:`discard_targets`); the discard slots are cut off."""
    out = torch.zeros(cap + DISCARD_SLOTS, dtype=x.dtype, device=x.device)
    return out.index_add_(0, tgt, x)[:cap]


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
    l_key_cols: Sequence[KeyCol], r_key_cols: Sequence[KeyCol], fuse=None
) -> Tuple[torch.Tensor, torch.Tensor, Optional[_radix.Hint]]:
    """Comparable key ids of one integer dtype for both tables, plus the
    radix hint of the id lane: the uint32 fast path keeps its full 32-bit
    span, factorized ids are dense and bounded by nl + nr. ``fuse``: the
    factorize lanes' sort-word fusion plan (the fast path ignores it)."""
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
    l_ids, r_ids = factorize_two(l_key_cols, r_key_cols, fuse=fuse)
    n = l_ids.shape[0] + r_ids.shape[0]
    return l_ids, r_ids, _radix.bound_hint(n)


def _merged_counts(
    l_ids: torch.Tensor, r_ids: torch.Tensor, hint, need_rcnt: bool, n_live=None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(lo, cnt, r_cnt) of the equi-join probe from ONE merged kv-sort.

    Stable sort of [r_ids ++ l_ids]: inside an equal-key run the rights
    precede the lefts, so for a left at sorted position p,
      lo[p]  = rights before p's run (run-start broadcast of a prefix sum),
      cnt[p] = rights inside the run (rights in the run up to p).
    Both return to row order by one scatter through the sort's payload.
    r_cnt mirrors it: counting lefts at/after a right position sees the
    run's lefts. ``n_live``: (left, right) live row counts of padded
    inputs (device scalars), whose dead rows hold the largest id: only
    live rows count (a live row with that id sorts before them)."""
    nl, nr = l_ids.shape[0], r_ids.shape[0]
    device = l_ids.device
    keys = torch.cat([r_ids, l_ids])
    pay = torch.arange(nr + nl, dtype=torch.int32, device=device)
    skey, spay = _radix.kv_sort(keys, pay, hint)
    is_r = spay < (nr if n_live is None else n_live[1])
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
    is_l = spay >= nr if n_live is None else (spay >= nr) & (spay - nr < n_live[0])
    (r_cnt,) = sentinel_compact(spay, [run_count_from(new_run, is_l)])
    return lo, cnt, r_cnt[:nr]


def count_from_probe(cnt, r_cnt, how: int, l_live=None, r_live=None) -> torch.Tensor:
    """Exact output row count (device int64 scalar); ``l_live``/``r_live``
    mask the live rows of padded inputs."""
    total = cnt.sum()
    if how in (LEFT, FULL_OUTER):
        un = cnt == 0
        total = total + (un if l_live is None else un & l_live).sum()
    if how in (RIGHT, FULL_OUTER):
        un = r_cnt == 0
        total = total + (un if r_live is None else un & r_live).sum()
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


def emit_from_probe(lo, cnt, r_order, r_cnt, how: int, total: int, l_live=None, r_live=None):
    """(left idx, right idx) int64 pairs of every output row, -1 on the
    null side of an outer join. ``total`` sizes the output; with padded
    inputs (``l_live``/``r_live``) it is a static capacity, and rows past
    the real count hold -1 on both sides."""
    device = lo.device
    nl, nr = lo.shape[0], r_order.shape[0]
    un_l = cnt == 0 if l_live is None else (cnt == 0) & l_live
    cnt_adj = torch.where(un_l, torch.ones_like(cnt), cnt) if how in (LEFT, FULL_OUTER) else cnt
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
        r_un = r_cnt == 0 if r_live is None else (r_cnt == 0) & r_live
        rank = torch.cumsum(r_un.to(torch.int64), 0) - 1
        idx_r = torch.arange(nr, dtype=torch.int64, device=device)
        # past the output (a capacity the real count overflows): own slots
        dest = torch.where(r_un & (total_l + rank < total), total_l + rank, total + idx_r)
        li = torch.cat([li, li.new_full((nr,), -1)])
        ri = torch.cat([ri, ri.new_full((nr,), -1)])
        ri.scatter_(0, dest, idx_r)
        li.scatter_(0, dest, torch.full_like(idx_r, -1))
        li, ri = li[:total], ri[:total]
    return li, ri


def emit_gather(lo, cnt, r_order, r_cnt, l_cols, r_cols, how: int, total: int,
                l_live=None, r_live=None):
    """RIGHT / FULL OUTER emit: index pairs, then one packed gather a side."""
    li, ri = emit_from_probe(lo, cnt, r_order, r_cnt, how, total, l_live, r_live)
    return pack_gather(l_cols, li) + pack_gather(r_cols, ri)


def _emit_inner_left(
    lo, cnt, l_cols: Sequence[KeyCol], r_sorted_cols: Sequence[KeyCol],
    how: int, total: int, l_live=None,
) -> List[KeyCol]:
    """INNER / LEFT emit against the key-sorted right payload.

    The left rows that emit are compacted to the front (a stable
    partition, order-preserving), so the output's left row ids
    ``repeat(arange(m), counts)`` step by at most one, and the left columns
    plus the bookkeeping lanes (lo, cnt, output offset) are
    expanded in one launch of K2. The right columns are gathered at
    ``lo - offset + output position`` (not monotone: a plain gather).
    With padded inputs (``l_live``) ``total`` is a static capacity: the
    rows past the real count are garbage the caller's count leaves out."""
    device = lo.device
    nl = lo.shape[0]
    un_l = cnt == 0 if l_live is None else (cnt == 0) & l_live
    cnt_adj = torch.where(un_l, torch.ones_like(cnt), cnt) if how == LEFT else cnt
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

    # every left column gets a validity mask, all-true where it had none,
    # as the JAX package's left-order emit gives it (its in-output mask):
    # a later shuffle or groupby then plans the same lanes
    all_true = torch.ones(total, dtype=torch.bool, device=device)
    out_l, _ = unpack_cols(
        plan, list(outT[:n_payload].unbind(0)),
        lambda lane: all_true if lane is None else lane.to(torch.bool),
    )
    out_pos = torch.arange(total, dtype=torch.int64, device=device)
    rpos = torch.where(cnt_g > 0, lo_g - offs_g + out_pos, -1)
    return out_l + pack_gather(r_sorted_cols, rpos)


def _key_order_probe(l_ids, r_ids, hint, how: int) -> dict:
    """The key-order emit's probe (the first half of the JAX package's
    ``_key_order_emit``): ONE merged kv-sort of [right ids ++ left ids]
    (K1) and run scans. At a left position p the run's rights
    all precede p, so the rights in the run up to p are its match count
    and the run start's right prefix sum its window base. ``"total"`` is
    the output row count as a device scalar."""
    nl, nr = l_ids.shape[0], r_ids.shape[0]
    device = l_ids.device
    keys = torch.cat([r_ids, l_ids])  # rights FIRST (tie order matters)
    pay = torch.arange(nr + nl, dtype=torch.int32, device=device)
    skey, spay = _radix.kv_sort(keys, pay, hint)
    is_l = spay >= nr
    rl = (~is_l).to(torch.int64)
    r_excl = torch.cumsum(rl, 0) - rl
    new_run = torch.ones(nr + nl, dtype=torch.bool, device=device)
    new_run[1:] = skey[1:] != skey[:-1]
    lo_run = run_start_broadcast(new_run, r_excl)
    cnt = torch.where(is_l, run_count_upto(new_run, ~is_l), 0)
    cnt_adj = torch.where(is_l & (cnt == 0), 1, cnt) if how == LEFT else cnt
    ends = torch.cumsum(cnt_adj, 0)
    total = ends[-1] if nl + nr else torch.zeros((), dtype=torch.int64, device=device)
    return {"ends": ends, "base": lo_run - (ends - cnt_adj), "cnt": cnt,
            "orig": spay - nr, "total": total}


def _key_order_gather(
    state: dict, l_cols: Sequence[KeyCol], r_sorted_cols: Sequence[KeyCol], total: int
) -> List[KeyCol]:
    """The key-order emit's output (left ++ right columns) of ``total``
    rows, GROUPED BY KEY: within a key, left rows in row order, each with
    its matches in the right's key-sorted order; a LEFT join's unmatched
    rows at their key's place. The repeat runs over sorted space, and each
    output row's (window base, match count, original left row) comes back
    in ONE narrow [total, 3] gather."""
    li = _repeat_ss(state["ends"], total).to(torch.int64)  # sorted-space position
    book = gather_rows(torch.stack([state["base"], state["cnt"], state["orig"].to(torch.int64)], 1), li)
    out_pos = torch.arange(total, dtype=torch.int64, device=li.device)
    out_l = pack_gather(l_cols, book[:, 2], all_valid=True)
    rpos = torch.where(book[:, 1] > 0, book[:, 0] + out_pos, -1)
    return out_l + pack_gather(r_sorted_cols, rpos)


def spec_probe(
    l_key_cols: Sequence[KeyCol],
    r_key_cols: Sequence[KeyCol],
    r_cols: Sequence[KeyCol],
    how: int,
    r_presorted: bool = False,
    emit_key_order: bool = False,
    key_fuse=None,
) -> dict:
    """Probe + count of one shard, with no host sync: the state
    :func:`spec_emit` takes, ``"total"`` the output row count as a device
    scalar. A caller reads every shard's count (every rank's, under
    torch.distributed), checks them all with :func:`count_overflow_check`,
    so that every rank raises alike, then emits.

    ``r_presorted``: the right rows are already in key order (the caller's
    ordering descriptor proves it), so the right sort is the identity and
    is skipped. ``emit_key_order`` (INNER / LEFT): the key-order emit.
    ``key_fuse``: the multi-key / masked probe's factorize fusion plan
    (``Table.join`` sizes it from both sides' merged stats)."""
    l_ids, r_ids, hint = _canonical_ids(l_key_cols, r_key_cols, key_fuse)
    nr = r_ids.shape[0]
    if how in (INNER, LEFT):
        if r_presorted:
            r_sorted = list(r_cols)
        else:
            # id lanes are integers, so the radix engine never declines them
            r_sorted = pack_gather(r_cols, _radix.argsort_perm(r_ids, hint), all_valid=True)
        if emit_key_order:
            state = _key_order_probe(l_ids, r_ids, hint, how)
            return {"key_order": state, "r_sorted": r_sorted, "total": state["total"]}
        lo, cnt, r_cnt = _merged_counts(l_ids, r_ids, hint, need_rcnt=False)
        return {"lo": lo, "cnt": cnt, "r_sorted": r_sorted,
                "total": count_from_probe(cnt, r_cnt, how)}
    lo, cnt, r_cnt = _merged_counts(l_ids, r_ids, hint, need_rcnt=True)
    if r_presorted:
        r_order = torch.arange(nr, dtype=torch.int32, device=r_ids.device)
    else:
        r_order = _radix.argsort_perm(r_ids, hint)
    return {"lo": lo, "cnt": cnt, "r_cnt": r_cnt, "r_order": r_order,
            "total": count_from_probe(cnt, r_cnt, how)}


def spec_emit(
    probe: dict, l_cols: Sequence[KeyCol], r_cols: Sequence[KeyCol], how: int, total: int
) -> List[KeyCol]:
    """The output columns (left ++ right) of a :func:`spec_probe` whose
    row count ``total`` the caller has read and checked."""
    if "key_order" in probe:
        return _key_order_gather(probe["key_order"], l_cols, probe["r_sorted"], total)
    if how in (INNER, LEFT):
        return _emit_inner_left(probe["lo"], probe["cnt"], l_cols, probe["r_sorted"], how, total)
    return emit_gather(probe["lo"], probe["cnt"], probe["r_order"], probe["r_cnt"],
                       l_cols, r_cols, how, total)


def spec_join(
    l_key_cols: Sequence[KeyCol],
    r_key_cols: Sequence[KeyCol],
    l_cols: Sequence[KeyCol],
    r_cols: Sequence[KeyCol],
    nl,
    nr,
    how: int,
    join_cap: int,
) -> Tuple[List[KeyCol], torch.Tensor, torch.Tensor]:
    """The static-capacity join of the fused mode (the JAX package's
    ``spec_join``): probe, count, emit and gather of padded inputs (their
    first ``nl`` / ``nr`` rows live, device scalars) into ``join_cap``
    output rows, with no host read. INNER / LEFT emit in left-row order
    through the windowed expand (K2) against the key-sorted right rows;
    RIGHT / FULL OUTER through index pairs. Every sort is K1's.

    Dead rows take the largest id (all ones of the uint32 fast path, or
    one past the factorized ids), so that they sort after every live row
    of an equal key, and only live rows count.

    Returns (columns of ``join_cap`` rows, the exact output count wrapped
    to int32 as the JAX package's int32 count wraps, the float32 shadow of
    the inner count that exposes such a wrap)."""
    device = l_key_cols[0][0].device
    cap_l, cap_r = l_key_cols[0][0].shape[0], r_key_cols[0][0].shape[0]
    l_live = torch.arange(cap_l, device=device) < nl
    r_live = torch.arange(cap_r, device=device) < nr
    l_ids, r_ids, hint = _canonical_ids(l_key_cols, r_key_cols)
    if hint is None:
        sent = -1  # the uint32 pattern 0xFFFFFFFF
    else:
        sent = cap_l + cap_r
        hint = _radix.bound_hint(cap_l + cap_r + 1)
    l_ids = torch.where(l_live, l_ids, torch.full_like(l_ids, sent))
    r_ids = torch.where(r_live, r_ids, torch.full_like(r_ids, sent))
    n_live = (nl, nr)
    lo, cnt, r_cnt = _merged_counts(l_ids, r_ids, hint, how in (RIGHT, FULL_OUTER), n_live)
    cnt = torch.where(l_live, cnt, torch.zeros_like(cnt))
    total = count_from_probe(cnt, r_cnt, how, l_live, r_live)
    shadow = cnt.to(torch.float32).sum()
    if how in (INNER, LEFT):
        r_sorted = pack_gather(r_cols, _radix.argsort_perm(r_ids, hint), all_valid=True)
        out = _emit_inner_left(lo, cnt, l_cols, r_sorted, how, join_cap, l_live)
    else:
        r_order = _radix.argsort_perm(r_ids, hint)
        out = emit_gather(lo, cnt, r_order, r_cnt, l_cols, r_cols, how, join_cap, l_live, r_live)
    return out, _wrap_i32(total).to(torch.int32), shadow


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 two's-complement wrap of its value (int64)."""
    return ((x + 2**31) % 2**32) - 2**31


def join_sum_by_key_pushdown(
    l_key_cols: Sequence[KeyCol],
    r_key_cols: Sequence[KeyCol],
    l_val: KeyCol,
    n_live=None,
    group_cap: Optional[int] = None,
):
    """INNER join + groupby-SUM(a left column) BY the join key, fused into
    the probe's merged sort (the JAX package's function with
    ``return_reps``): no join emit, no groupby sort.

    In one key run of the merged sort every left row pairs with every
    right row, so the group's sum over the join result is ``count(rights)
    * sum(left values)``, and its join-row count ``c_l * c_r``. ONE K1
    argsort of [right ids ++ left ids]; the value rides by one gather of
    that order; run counts; one segment sum of the values into group slots
    (a group is a run with rows of both sides, numbered in key order). The
    rest is read at each group's start, where the run counts hold the
    run's totals and the run's rights precede its lefts.

    Returns (sums, ng, n_join, reps, vcnt) as device tensors over
    min(n_l, n_r) group slots, an exact bound (a group needs a row on each
    side), of which the first ``ng`` are live: the sums in the value's
    float type, the join-row count ``n_join`` (saturating at 2^31 - 1
    where its int32 count wraps, as the JAX package computes it), the
    first left row of each group and its count of valid left values (an
    all-null group sums to null). Null values add 0.

    ``n_live``: (left, right) live row counts of padded inputs (device
    scalars; the fused q3 step's shuffled shards), whose dead rows take
    the largest id and count on neither side. ``group_cap``: the group
    slots (default the exact bound); groups past it are dropped, as the
    JAX package's fixed-capacity segment sums drop them."""
    nl = l_key_cols[0][0].shape[0]
    nr = r_key_cols[0][0].shape[0]
    n = nl + nr
    device = l_key_cols[0][0].device
    cap = min(nl, nr) if group_cap is None else group_cap
    l_ids, r_ids, hint = _canonical_ids(l_key_cols, r_key_cols)
    if n_live is not None:
        sent = -1 if hint is None else n
        hint = hint if hint is None else _radix.bound_hint(n + 1)
        l_ids = torch.where(torch.arange(nl, device=device) < n_live[0], l_ids,
                            torch.full_like(l_ids, sent))
        r_ids = torch.where(torch.arange(nr, device=device) < n_live[1], r_ids,
                            torch.full_like(r_ids, sent))
    vd, vv = l_val
    acc = vd if vd.dtype.is_floating_point else vd.to(torch.float32)
    vsafe = acc if vv is None else torch.where(vv, acc, torch.zeros_like(acc))

    keys = torch.cat([r_ids, l_ids])  # rights FIRST (matches the probe)
    skey, spay = _radix.sort_lane(keys, hint)  # id lanes are integers: K1
    spay = spay.to(torch.int64)
    if skey is None:
        skey = keys.index_select(0, spay)
    sval = torch.cat([vsafe.new_zeros(nr), vsafe]).index_select(0, spay)
    is_l = spay >= nr
    is_r = ~is_l
    if n_live is not None:
        is_l = is_l & (spay - nr < n_live[0])
        is_r = spay < n_live[1]
    new_run = torch.ones(n, dtype=torch.bool, device=device)
    new_run[1:] = skey[1:] != skey[:-1]

    # run-start totals decide which runs are groups (rows of both sides)
    c_r = run_count_from(new_run, is_r)
    c_l = run_count_from(new_run, is_l)
    group_start = new_run & (c_l > 0) & (c_r > 0)
    in_l = run_start_broadcast(new_run, group_start) & is_l
    gid = torch.cumsum(group_start.to(torch.int64), 0) - 1  # constant per run
    ng = group_start.sum()
    # gid never decreases over sorted space: a row of a run that is no group
    # adds zero to the group before it (the JAX package's "sorted" segment
    # sums), never to one shared discard slot, whose atomics would serialize
    # on the card; rows ahead of the first group add zero to slot 0. In
    # padded inputs the dead rows (the tail of sorted space) and groups past
    # ``cap`` spread over DISCARD_SLOTS slots behind the groups, for the
    # same reason
    tgt = discard_targets(gid.clamp(min=0), None if n_live is None else ~(is_l | is_r), cap)
    sums = padded_seg_add(torch.where(in_l, sval, torch.zeros_like(sval)), tgt, cap)
    # each group's start position: starts to their slots, every other row
    # to a distinct slot past them (no two writes meet)
    pos = torch.arange(n, dtype=torch.int64, device=device)
    gpos = torch.empty(cap + n, dtype=torch.int64, device=device).scatter_(
        0, torch.where(group_start & (gid < cap), gid, cap + pos), pos)[:cap]
    live = torch.arange(cap, device=device) < ng
    gpos = torch.where(live, gpos, 0)
    cntr = torch.where(live, c_r.index_select(0, gpos), 0)
    cntl = torch.where(live, c_l.index_select(0, gpos), 0)
    s = sums * cntr.to(sums.dtype)

    nj = _wrap_i32((cntl * cntr).sum())
    nj_f = (cntl.to(torch.float32) * cntr.to(torch.float32)).sum()
    wrapped = (nj < 0) | (nj_f > 2.0**31)
    n_join = torch.where(wrapped, torch.full_like(nj, 2**31 - 1), nj).to(torch.int32)
    # the group's first left row follows its rights (dead ones too) in
    # sorted space
    c_rall = cntr if n_live is None else torch.where(
        live, run_count_from(new_run, spay < nr).index_select(0, gpos), 0)
    reps = torch.where(live, spay.index_select(0, gpos + c_rall) - nr, nl)
    if vv is None:
        vcnt = cntl.to(torch.int32)
    else:
        lrow = (spay - nr).clamp(0, max(nl - 1, 0))
        vok = in_l & vv.index_select(0, lrow) if nl else in_l
        vcnt = padded_seg_add(vok.to(torch.int32), tgt, cap)
    return s, ng, n_join, reps, vcnt
