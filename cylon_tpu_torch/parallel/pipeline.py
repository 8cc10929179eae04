"""The fused mode: the shuffle -> join chain at static capacities with no
host read inside (counterpart of cylon_tpu/parallel/pipeline.py).

The eager ops size every buffer exactly, which costs host syncs: a
count fetch and a deferred received-count fetch per shuffled table, one
count read per join. The fused mode is the JAX package's second
execution mode, where the whole partition -> all_to_all -> join (->
aggregate) chain is one compiled program on user-supplied capacities.
The port's form of that program is a step function over every local
shard: it issues the rounds' all_to_alls and the overflow all_reduces
and reads nothing on the host, so the card runs it back to back. Its
intermediate buffers are padded to the static capacities (``bucket_cap``
rows per destination chunk and round, ``join_cap`` join rows per shard
and slice, ``group_cap`` groups), the one place where the port's
no-padding rule yields, because the capacities are the mode's semantics:
each step returns overflow counts, and the caller (``Table._fused_join``)
reads counts and overflow in ONE host fetch per attempt, doubles the
capacities on overflow and retries, and trims the outputs to exact
length.

Every kernel of the eager path runs here: B2a/B2b build each round's
send slots (a hash slice's slots come from one combined K1 sort,
``shuffle.build_slice_plan``), B3 compacts every round's received rows
in one launch, the join sorts through K1 and emits INNER / LEFT rows
through K2. The wire plan is the static one (``gather.static_wire_plan``):
a fused program has no host stats step, so only validity masks, bools,
16-bit floats and, under ``quant``, the lossy fields narrow; the q8
block scales ride the header rows. Under a 2-D ``topo`` each round's
exchange is the structured two-hop (``topo.exchange_buffer_structured``),
whose bytes :func:`fused_axis_bytes` splits by axis.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..ops import cuda_codec as _codec
from ..ops import join as _j
from ..ops.gather import KeyCol, pack_cols, static_wire_plan, unpack_cols
from ..ops.hash import hash_columns
from ..ops.partition import partition_of_hash
from . import shuffle as _sh
from . import topo as _topo

#: slice bits live at hash bits 24..31 (the JAX package's
#: SLICE_HASH_SHIFT): shard pids use the low bits, and its out-of-core
#: bucket split bits 16..23; 8 bits cap num_slices at 256
SLICE_HASH_SHIFT = 24
MAX_SLICES = 256


class ShardTable(NamedTuple):
    """One shard's columns and its live-row count (a host int for an
    exact-length input, a device scalar for a padded step buffer)."""

    cols: Tuple[KeyCol, ...]
    n: object


def fused_exchange_bytes(
    world: int, bucket_cap: int, respill: int, row_bytes_l: int, row_bytes_r: int,
    num_slices: int = 1,
) -> int:
    """Global padded exchange bytes of one fused join or q3 step: each side
    ships ``num_slices x (1 + respill)`` header-augmented all_to_all
    buffers of ``world x (bucket_cap + 1)`` rows a shard (the JAX
    package's formula, beside the eager ``shuffle.exchanged_bytes``)."""
    rows = world * world * (bucket_cap + _sh.HEADER_ROWS)
    return num_slices * (1 + respill) * rows * (row_bytes_l + row_bytes_r)


def fused_axis_bytes(world: int, bucket_cap: int, respill: int, row_bytes: int,
                     topo: Optional[_topo.Topology], num_slices: int = 1) -> Tuple[int, int]:
    """(intra, inter) collective bytes of one side's fused shuffles, the
    fused twin of ``topo.axis_coll_bytes`` behind the same
    ``shuffle.coll_bytes.{intra,inter}`` counters. The structured two-hop
    keeps cap-sized chunks, so its cross-outer bytes equal the flat
    exchange's (it trades message count, not bytes), and the inner hop
    ships every chunk across the fast links once more. No topology counts
    everything inter (the JAX package's formula)."""
    k = max(num_slices * (1 + respill), 1)
    rows_chunk = bucket_cap + _sh.HEADER_ROWS
    if topo is None:
        return 0, k * world * (world - 1) * rows_chunk * row_bytes
    o, i = topo
    return (k * world * (i - 1) * o * rows_chunk * row_bytes,
            k * world * (o - 1) * i * rows_chunk * row_bytes)


def _shuffle_rounds(comm, sts: Sequence[ShardTable], cnts, dest_fns, world: int,
                    bucket_cap: int, respill: int, quant=None, topo=None):
    """The shared respill-round loop: ``dest_fns[i](r) -> (dest,
    leftover)`` gives local shard i's round-r send slots (the hash
    shuffle's B2b, or one hash slice of a SlicePlan). Returns (shuffled
    ShardTables of ``(1 + respill) * world * bucket_cap`` rows, the rows
    still unsent after the last round, summed over every shard by one
    all_reduce)."""
    wire = static_wire_plan(sts[0].cols, quant=quant)
    outs, totals, lefts = _sh.exchange_rounds_fused(
        comm, [st.cols for st in sts], dest_fns, cnts, world, bucket_cap, 1 + respill, wire,
        topo=topo,
    )
    overflow = comm.all_reduce(lefts, "sum")
    return [ShardTable(tuple(o), t) for o, t in zip(outs, totals)], overflow


def _leftover(cnt: torch.Tensor, bucket_cap: int, round_idx: int) -> torch.Tensor:
    """Rows of a shard still unsent after round ``round_idx``."""
    return (cnt.to(torch.int32) - (round_idx + 1) * bucket_cap).clamp(min=0).sum().to(torch.int32)


def shuffle_shard(comm, sts: Sequence[ShardTable], key_idx: Sequence[int], world: int,
                  bucket_cap: int, respill: int = 1, quant=None, topo=None):
    """Static-capacity hash shuffle of one table's local shards (exact
    length, ``st.n`` their host row counts). Kernel B2a hashes the keys
    into each row's pid and its tile histogram; B2b gives round r's
    slots, so that round r moves each bucket's rows ``[r * cap, (r + 1) *
    cap)`` and the overflow counts the rows past ``(1 + respill) * cap``."""
    dest_fns, cnts = [], []
    for st in sts:
        keys = [st.cols[i] for i in key_idx]
        lane, hist = _codec.pack_hist(*_codec.key_words(keys), int(st.n), world)
        base, cnt = _codec.scan_tiles(hist), hist.sum(1, dtype=torch.int32)
        dest_fns.append(lambda r, lane=lane, base=base, cnt=cnt: (
            _codec.pack_dest(lane, base, r, world, bucket_cap), _leftover(cnt, bucket_cap, r)))
        cnts.append(cnt)
    return _shuffle_rounds(comm, sts, cnts, dest_fns, world, bucket_cap, respill, quant, topo)


def slice_plans(sts: Sequence[ShardTable], key_idx: Sequence[int], world: int,
                num_slices: int) -> List["_sh.SlicePlan"]:
    """Per local shard the combined (slice, pid) plan: the pid lane from
    B2a, the slice from hash bits 24 and up, one K1 sort."""
    plans = []
    for st in sts:
        keys = [st.cols[i] for i in key_idx]
        pid, _hist = _codec.pack_hist(*_codec.key_words(keys), int(st.n), world)
        sid = partition_of_hash(hash_columns(keys) >> SLICE_HASH_SHIFT, num_slices)
        plans.append(_sh.build_slice_plan(pid, sid, world, num_slices))
    return plans


def sliced_shuffle_shard(comm, sts: Sequence[ShardTable], plans, slice_idx: int, world: int,
                         bucket_cap: int, respill: int = 1, quant=None, topo=None):
    """One hash slice's shuffle, driven by the precomputed plans (only
    elementwise slot math and the exchanges per slice)."""
    cnts = [_sh.slice_counts(p, slice_idx) for p in plans]
    dest_fns = [lambda r, p=p: _sh.slice_round_dest(p, slice_idx, bucket_cap, r) for p in plans]
    return _shuffle_rounds(comm, sts, cnts, dest_fns, world, bucket_cap, respill, quant, topo)


def join_shard(left: ShardTable, right: ShardTable, l_key_idx: Sequence[int],
               r_key_idx: Sequence[int], how: int, join_cap: int):
    """Static-capacity local join of one shard: (joined ShardTable of
    ``join_cap`` rows, left columns then right, and its overflow: the
    exact shortfall past ``join_cap``, or 2^31 - 1 where the int32 count
    wrapped, which the float32 shadow count exposes)."""
    out, needed, shadow = _j.spec_join(
        [left.cols[i] for i in l_key_idx], [right.cols[i] for i in r_key_idx],
        list(left.cols), list(right.cols), left.n, right.n, how, join_cap,
    )
    wrapped = (needed < 0) | (shadow > 2.0**31)
    overflow = torch.where(wrapped, torch.full_like(needed, 2**31 - 1),
                           (needed - join_cap).clamp(min=0))
    n_out = torch.where(wrapped, torch.zeros_like(needed), needed.clamp(max=join_cap))
    return ShardTable(tuple(out), n_out), overflow


def _check_slices(world: int, num_slices: int) -> None:
    if num_slices > 1 and world <= 1:
        raise ValueError("num_slices > 1 requires world > 1 (slice selection rides the shuffle)")
    if num_slices > MAX_SLICES:
        raise ValueError(f"num_slices is capped at {MAX_SLICES} (8 slice hash bits)")


def _compact_slices(jts: Sequence[ShardTable], join_cap: int):
    """The K slice outputs of one shard as ONE live prefix: their lanes
    stacked as K chunks of ``join_cap`` rows and front-packed by B3."""
    plan, _ = pack_cols(jts[0].cols)
    move = torch.cat([torch.stack(pack_cols(jt.cols)[1], 1) for jt in jts])
    counts = torch.stack([jt.n for jt in jts]).to(torch.int32)
    moved = _codec.compact_move(move, counts, len(jts), join_cap, n_header=0)
    cols, _ = unpack_cols(plan, list(moved.unbind(1)),
                          lambda lane: None if lane is None else lane.to(torch.bool))
    return tuple(cols), counts.sum()


def make_distributed_join_step(
    ctx, l_key_idx: Sequence[int], r_key_idx: Sequence[int], how: int, bucket_cap: int,
    join_cap: int, respill: int = 1, num_slices: int = 1, quant_l=None, quant_r=None, topo=None,
):
    """The fused distributed join as one step over this process's shards.

    ``step(l_cols, r_cols)`` takes each local shard's exact-length
    columns (lists in ``ctx.local_shards`` order) and returns per local
    shard (output columns of ``num_slices * join_cap`` rows, left then
    right, the live ones first; the live count, a device scalar; the
    overflow, a device int32 [2]: rows the shuffle could not send, summed
    over every shard, and join rows past one slice's ``join_cap``, the
    exact shortfall). ``quant_l``/``quant_r`` thread the lossy wire tier
    through each side's shuffle; ``topo`` (``topo.effective``) routes every
    exchange as the structured two-hop. One device: the local join."""
    world = ctx.world_size
    comm = ctx.comm
    _check_slices(world, num_slices)

    def step(l_cols, r_cols):
        lts = [ShardTable(tuple(c), c[0][0].shape[0]) for c in l_cols]
        rts = [ShardTable(tuple(c), c[0][0].shape[0]) for c in r_cols]
        if world == 1:
            jt, ovj = join_shard(lts[0], rts[0], l_key_idx, r_key_idx, how, join_cap)
            return [list(jt.cols)], [jt.n], [torch.stack([torch.zeros_like(ovj), ovj])]
        if num_slices == 1:
            ls, ovl = shuffle_shard(comm, lts, l_key_idx, world, bucket_cap, respill, quant_l, topo)
            rs, ovr = shuffle_shard(comm, rts, r_key_idx, world, bucket_cap, respill, quant_r, topo)
            outs, counts, ovs = [], [], []
            for i in range(len(lts)):
                jt, ovj = join_shard(ls[i], rs[i], l_key_idx, r_key_idx, how, join_cap)
                outs.append(list(jt.cols))
                counts.append(jt.n)
                ovs.append(torch.stack([ovl[i] + ovr[i], ovj]))
            return outs, counts, ovs
        plans_l = slice_plans(lts, l_key_idx, world, num_slices)
        plans_r = slice_plans(rts, r_key_idx, world, num_slices)
        per_slice = [[] for _ in lts]
        ov_sh = [torch.zeros((), dtype=torch.int32, device=c[0][0].device) for c in l_cols]
        ov_j = [torch.zeros((), dtype=torch.int32, device=c[0][0].device) for c in l_cols]
        for s in range(num_slices):
            ls, ovl = sliced_shuffle_shard(comm, lts, plans_l, s, world, bucket_cap, respill,
                                           quant_l, topo)
            rs, ovr = sliced_shuffle_shard(comm, rts, plans_r, s, world, bucket_cap, respill,
                                           quant_r, topo)
            for i in range(len(lts)):
                jt, ovj = join_shard(ls[i], rs[i], l_key_idx, r_key_idx, how, join_cap)
                per_slice[i].append(jt)
                ov_sh[i] = ov_sh[i] + ovl[i] + ovr[i]
                ov_j[i] = torch.maximum(ov_j[i], ovj)
        outs, counts = [], []
        for i in range(len(lts)):
            cols, n = _compact_slices(per_slice[i], join_cap)
            outs.append(list(cols))
            counts.append(n)
        return outs, counts, [torch.stack([a, b]) for a, b in zip(ov_sh, ov_j)]

    return step


def _group_sum_padded(keys: Sequence[KeyCol], val: KeyCol, n, group_cap: int):
    """Groupby-SUM of the first ``n`` rows of padded columns (device
    count), groups in canonical key order: (sums [group_cap], number of
    groups). A leading dead-row flag sorts the dead rows into the last
    group, which the count leaves out."""
    from ..ops.sort import canonical_row_lanes, sentinel_compact, sorted_runs

    device = val[0].device
    cap = val[0].shape[0]
    dead = (torch.arange(cap, device=device) >= n).to(torch.int32)
    order, diff = sorted_runs(canonical_row_lanes([(dead, None)] + list(keys)), None)
    ids_sorted = torch.cumsum(diff.to(torch.int64), 0) - 1
    last = ids_sorted.index_select(0, (torch.as_tensor(n, device=device) - 1).clamp(min=0).reshape(1))[0]
    ng = torch.where(torch.as_tensor(n, device=device) > 0, last + 1, torch.zeros_like(last))
    (ids,) = sentinel_compact(order, [ids_sorted])
    d, v = val
    acc = d if d.dtype.is_floating_point else d.to(torch.float64 if d.element_size() == 8 else torch.float32)
    ok = dead == 0 if v is None else (dead == 0) & v
    x = torch.where(ok, acc, torch.zeros_like(acc))
    # dead rows, null values and groups past the capacity go to the
    # discard slots
    return _j.padded_seg_add(x, _j.discard_targets(ids, ~ok, group_cap), group_cap), ng


def make_join_groupby_step(
    ctx, l_key_idx: Sequence[int], r_key_idx: Sequence[int], agg_col_idx: int, how: int,
    bucket_cap: int, join_cap: int, group_cap: int, respill: int = 1, quant_l=None,
    quant_r=None, quant_tol: float = 0.0, topo=None,
):
    """The fused q3 step: distributed join, a groupby-SUM on the (left)
    join key, and the global total of the sums.

    ``step(l_cols, r_cols)`` returns per local shard (sums [group_cap],
    number of groups, join rows, the global total, replicated). An INNER
    join summing a left float column of <= 4 bytes collapses into the
    probe's merged sort (``ops.join.join_sum_by_key_pushdown``); any other
    emits the join and groups it. ``quant_tol >= QB16_TOL`` rounds each
    shard's partial total to bfloat16 before the exact all_reduce (one
    rounding a partial, as the JAX package's quantized psum)."""
    from ..ops.quant import QB16_TOL

    world = ctx.world_size
    comm = ctx.comm

    def step(l_cols, r_cols):
        lts = [ShardTable(tuple(c), c[0][0].shape[0]) for c in l_cols]
        rts = [ShardTable(tuple(c), c[0][0].shape[0]) for c in r_cols]
        if world > 1:
            lts, _ = shuffle_shard(comm, lts, l_key_idx, world, bucket_cap, respill, quant_l, topo)
            rts, _ = shuffle_shard(comm, rts, r_key_idx, world, bucket_cap, respill, quant_r, topo)
        n_left = len(lts[0].cols)
        agg_is_left = agg_col_idx < n_left
        agg = (lts[0].cols[agg_col_idx] if agg_is_left else rts[0].cols[agg_col_idx - n_left])[0]
        pushdown = (how == _j.INNER and agg_is_left and agg.dtype.is_floating_point
                    and agg.element_size() <= 4)
        sums, ngs, njs = [], [], []
        for lt, rt in zip(lts, rts):
            if pushdown:
                s, ng, n_join, _reps, _vcnt = _j.join_sum_by_key_pushdown(
                    [lt.cols[i] for i in l_key_idx], [rt.cols[i] for i in r_key_idx],
                    lt.cols[agg_col_idx], n_live=(lt.n, rt.n), group_cap=group_cap,
                )
            else:
                jt, _ov = join_shard(lt, rt, l_key_idx, r_key_idx, how, join_cap)
                s, ng = _group_sum_padded([jt.cols[i] for i in l_key_idx],
                                          jt.cols[agg_col_idx], jt.n, group_cap)
                n_join = jt.n
            sums.append(s)
            ngs.append(ng)
            njs.append(n_join)
        totals = [s.sum() for s in sums]
        if world > 1:
            if quant_tol >= QB16_TOL and totals[0].dtype.is_floating_point:
                totals = [t.to(torch.bfloat16).to(t.dtype) for t in totals]
            totals = comm.all_reduce(totals, "sum")
        return sums, ngs, njs, totals

    return step
