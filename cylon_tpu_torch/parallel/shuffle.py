"""The chunked all-to-all shuffle's per-shard pieces (counterpart of
cylon_tpu/parallel/shuffle.py).

A hash shuffle moves every row to the shard its key hashes to, in K
bounded rounds. The host sizes ``bucket_cap`` from a per-round byte budget
(:func:`plan_rounds`); round r ships the rows whose position within their
bucket lies in ``[r * bc, (r + 1) * bc)``. Each round:

* PACK: send slots (kernel B2, ops/cuda_codec.py, whose plain twin is
  :func:`build_send_slots_round`) and one scatter of the row-major int32
  lanes into the header-augmented buffer ``[P * (bc + 1), L]``
  (:func:`pack_lane_buffer`); the header row of each chunk carries that
  chunk's round count;
* COLLECTIVE: one all_to_all of the buffer (:func:`exchange_buffer`);
* COMPACT: the live rows front-packed in (source chunk, slot) order
  (kernel B3), then unpacked to columns (:func:`compact_received_lanes`).

The buffers are row-major so that a chunk is contiguous for the exchange;
the unpack after the compact is the one transpose back to columns.

Under the quantized wire tier (ops/quant.py) each destination chunk of a
round also carries one float32 max-abs scale per 'q8' field, bitcast into
its header rows (:func:`wire_header_rows`); the receive side appends each
row's source-chunk scales as extra lanes before the compact, so that B3
moves them with the row (:func:`with_scale_lanes`).

The fused mode (parallel/pipeline.py) composes the same pieces with
static capacities: :func:`exchange_rounds_fused` runs a table's rounds and
one B3 compact over every round's received buffers, and a hash-sliced
join builds its send slots from one combined sort (:func:`build_slice_plan`).

Under a 2-D topology (parallel/topo.py) the eager rounds exchange through
``topo.two_hop_exchange`` and the fused ones through
``topo.exchange_buffer_structured``; the pack and compact are unchanged.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..engine import round_cap
from ..ops.gather import (
    KeyCol, _from_lanes, _to_lanes, lane_plan, pack_cols, unpack_cols, wire_pack_cols,
    wire_pt_order, wire_q8_cols, wire_unpack_cols,
)

#: header rows per (src, dst) chunk: lane 0 carries the round's send count
HEADER_ROWS = 1

#: past this many rounds plan_rounds raises bucket_cap over the budget
DEFAULT_MAX_ROUNDS = 16

#: spare rows behind a send buffer that take the rows of other rounds
#: (distinct rows, so the dropped writes do not all hit one address)
DROP_ROWS = 1024


def bucket_counts(pid: torch.Tensor, num_partitions: int) -> torch.Tensor:
    """Rows per target partition -> [P] int32 (the sentinel P is dropped)."""
    P = num_partitions
    ids = torch.where((pid >= 0) & (pid < P), pid, P).to(torch.int64)
    return torch.bincount(ids, minlength=P + 1)[:P].to(torch.int32)


def build_send_slots_round(
    pid: torch.Tensor,
    counts: torch.Tensor,
    num_partitions: int,
    bucket_cap: int,
    round_idx: int,
) -> torch.Tensor:
    """int32 slot in the ``[P * bucket_cap]`` send buffer of every row whose
    stable position within its bucket falls in round ``round_idx``'s window;
    other rows (and dead rows, pid == P) get ``P * bucket_cap``."""
    n = pid.shape[0]
    P = num_partitions
    order = torch.sort(pid, stable=True).indices
    spid = pid[order].to(torch.int64)
    c = counts.to(torch.int64)
    starts = torch.cumsum(c, 0) - c
    safe = spid.clamp(0, P - 1)
    pos = torch.arange(n, device=pid.device) - starts[safe]
    slot = pos - round_idx * bucket_cap
    live = spid < P
    ok = live & (slot >= 0) & (slot < bucket_cap)
    dest_sorted = torch.where(ok, safe * bucket_cap + slot, P * bucket_cap)
    dest = torch.empty(n, dtype=torch.int32, device=pid.device)
    dest[order] = dest_sorted.to(torch.int32)
    return dest


def round_counts(counts: torch.Tensor, bucket_cap: int, round_idx: int) -> torch.Tensor:
    """Per-bucket send counts of one round: clip(counts - r*cap, 0, cap)."""
    return (counts - round_idx * bucket_cap).clamp(0, bucket_cap)


def relay_send_slots(
    lane: torch.Tensor,
    base: torch.Tensor,
    relay_row: np.ndarray,
    quota: int,
    relay_cap: int,
) -> torch.Tensor:
    """int32 slot in the relay buffer of every row whose stable position
    within its bucket is at or past the collective quota (the skew split's
    tail, parallel/spill.plan_schedule); other rows (and dead rows, pid ==
    P) get ``relay_cap``. Slots are destination-major, each bucket's rows
    in their stable order, so the host splits a source's buffer into
    per-destination runs with the planner's own relay counts.

    ``lane`` is kernel B2a's pid lane and ``base`` ``[P, n_tiles]`` the
    per-tile bucket starts of kernel B2b (``cuda_codec.scan_tiles``): a
    row's position is its tile's start in its bucket plus its rank among
    the tile's rows of that bucket. Only the buckets with relay rows
    (``relay_row``: this source's [P] relay counts) are ranked."""
    from ..ops.cuda_codec import TILE

    n = lane.shape[0]
    nt = base.shape[1]
    dest = torch.full((n,), relay_cap, dtype=torch.int32, device=lane.device)
    offs = np.concatenate([[0], np.cumsum(relay_row)])
    for d in np.flatnonzero(relay_row):
        hit = (lane == int(d)).to(torch.int32)
        tiles = torch.nn.functional.pad(hit, (0, nt * TILE - n)).view(nt, TILE)
        rank = torch.cumsum(tiles, 1, dtype=torch.int32) - tiles
        pos = (rank + base[int(d)].view(nt, 1)).view(-1)[:n]
        ok = (hit != 0) & (pos >= quota)
        dest = torch.where(ok, pos - quota + int(offs[d]), dest)
    return dest


# ----------------------------------------------------------------------
# round planning (the byte budget, config.py)
# ----------------------------------------------------------------------

def exchange_row_bytes(cols: Sequence[KeyCol]) -> int:
    """Bytes one row occupies in the exchange buffers: 4 per int32 lane
    (validity lanes included, 64-bit values as two lanes). The JAX package
    counts a float64 column as an 8-byte passthrough; the port moves it as
    two lanes, also 8 bytes, so both packages plan the same rounds."""
    total = 0
    for _dt, n_lanes, has_valid in lane_plan(cols):
        total += 4 * n_lanes + (4 if has_valid else 0)
    return max(total, 1)


def budget_bucket_cap(
    row_bytes: int, num_partitions: int, byte_budget: int, max_cap: int
) -> int:
    """Largest power-of-two bucket_cap (<= max_cap, floor 8) whose per-round
    send buffer ``P * cap * row_bytes`` fits the budget."""
    cap = 8
    while 2 * cap <= max_cap and num_partitions * 2 * cap * row_bytes <= byte_budget:
        cap *= 2
    return cap


def plan_rounds(
    send_counts: np.ndarray,
    row_bytes: int,
    num_partitions: int,
    byte_budget: int,
    max_rounds: int = DEFAULT_MAX_ROUNDS,
) -> Tuple[int, int]:
    """(bucket_cap, n_rounds): the tightest of the hot-bucket cap (one
    round), the skew-balancing cap (4x the mean bucket) and the byte-budget
    cap; n_rounds = ceil(hottest bucket / cap). Past ``max_rounds`` the cap
    grows over the budget instead."""
    send_counts = np.asarray(send_counts)
    max_cnt = int(send_counts.max()) if send_counts.size else 0
    mean_bucket = -(-int(send_counts.sum()) // max(send_counts.size, 1))
    c_full = round_cap(max_cnt)
    cap = c_full
    c_balanced = round_cap(4 * max(mean_bucket, 1))
    if c_balanced < cap:
        cap = c_balanced
    c_budget = budget_bucket_cap(row_bytes, num_partitions, byte_budget, c_full)
    if c_budget < cap:
        cap = c_budget
    n_rounds = max(-(-max_cnt // cap), 1)
    if n_rounds > max_rounds:
        cap = round_cap(-(-max_cnt // max_rounds))
        n_rounds = max(-(-max_cnt // cap), 1)
    return cap, n_rounds


# ----------------------------------------------------------------------
# pack / collective / header split
# ----------------------------------------------------------------------

def header_slots(
    dest: torch.Tensor, num_partitions: int, bucket_cap: int, n_header: int = HEADER_ROWS
) -> torch.Tensor:
    """Plain send slots -> rows of the header-augmented buffer
    ``[P * (bucket_cap + n_header)]``; the sentinel maps to one past it."""
    d = dest.to(torch.int64)
    P = num_partitions
    return torch.where(
        d >= P * bucket_cap,
        P * (bucket_cap + n_header),
        d + (d // bucket_cap + 1) * n_header,
    )


def wire_header_rows(wplan) -> int:
    """Header rows one chunk of a wire-narrowed exchange needs: the round
    send count plus one float32 block scale per 'q8' field, wrapped over
    the plan's word lanes. A plan with no q8 field keeps one header row."""
    nq8 = len(wire_q8_cols(wplan))
    if nq8 == 0:
        return HEADER_ROWS
    return max(1, -(-(1 + nq8) // wplan.n_words))


def pack_lane_buffer(
    packed: torch.Tensor,
    dest: torch.Tensor,
    counts_round: torch.Tensor,
    num_partitions: int,
    bucket_cap: int,
    header_extra: Optional[torch.Tensor] = None,
    n_header: int = HEADER_ROWS,
) -> torch.Tensor:
    """Scatter the row-major lanes ``packed [n, L]`` into the send buffer
    ``[P * (bucket_cap + n_header), L]``. The header rows of each chunk
    carry this round's send count for its destination in their first
    lane, then ``header_extra`` ([P, E] int32 per chunk: the bitcast q8
    block scales) wrapped over the ``n_header`` rows; the rest is zeros."""
    P = num_partitions
    rows = bucket_cap + n_header
    n, L = packed.shape
    body = P * rows
    buf = torch.zeros((body + DROP_ROWS, L), dtype=torch.int32, device=packed.device)
    if header_extra is None and n_header == 1:
        buf[:body].view(P, rows, L)[:, 0, 0] = counts_round.to(torch.int32)
    else:
        hv = torch.zeros((P, n_header * L), dtype=torch.int32, device=packed.device)
        hv[:, 0] = counts_round.to(torch.int32)
        if header_extra is not None:
            hv[:, 1:1 + header_extra.shape[1]] = header_extra
        buf[:body].view(P, rows, L)[:, :n_header] = hv.view(P, n_header, L)
    hs = header_slots(dest, P, bucket_cap, n_header)
    spare = body + torch.arange(n, device=packed.device) % DROP_ROWS
    buf.index_copy_(0, torch.where(hs >= body, spare, hs), packed)
    return buf[:body]


def exchange_buffer(comm, bufs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The round's one collective: chunk s of output d is what shard s sent
    to shard d."""
    return comm.all_to_all(bufs)


def header_counts(got: torch.Tensor, num_partitions: int) -> torch.Tensor:
    """The [P] counts in lane 0 of a received buffer's header rows, as a
    strided view: entry s is what source shard s sent this round."""
    rows = got.shape[0] // num_partitions
    return got.view(num_partitions, rows, got.shape[1])[:, 0, 0]


def split_header(
    got: torch.Tensor, num_partitions: int, n_header: int = HEADER_ROWS
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(data rows [P * bucket_cap, L], recv_counts [P] int32) of a received
    buffer (the data rows copied out of the header-interleaved layout)."""
    rows = got.shape[0] // num_partitions
    g = got.view(num_partitions, rows, got.shape[1])
    data = g[:, n_header:].reshape(num_partitions * (rows - n_header), got.shape[1])
    return data, header_counts(got, num_partitions).clone()


def received_row_mask(
    recv_counts: torch.Tensor, num_partitions: int, bucket_cap: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(live mask [P * bucket_cap], total received)."""
    idx = torch.arange(num_partitions * bucket_cap, device=recv_counts.device)
    mask = (idx % bucket_cap) < recv_counts.to(torch.int64)[idx // bucket_cap]
    return mask, recv_counts.sum()


def compact_received_lanes(plan, live: torch.Tensor) -> List[KeyCol]:
    """Columns of the received live rows, a front-packed ``[rows, L]`` lane
    matrix (the compact itself is ops/cuda_codec.compact_move)."""
    out, _ = unpack_cols(
        plan, list(live.unbind(1)),
        lambda lane: None if lane is None else lane.to(torch.bool),
    )
    return out


# ----------------------------------------------------------------------
# the quantized tier's block scales (ops/quant.py): one float32 max-abs
# scale per (destination chunk, q8 field), computed at pack, shipped in
# the header rows, carried per received row through the compact
# ----------------------------------------------------------------------

def quant_chunk_scales(cols: Sequence[KeyCol], wplan, dest: torch.Tensor, num_partitions: int,
                       bucket_cap: int) -> torch.Tensor:
    """[P, nq8] strictly positive float32 scales: the finite max-abs of
    every q8 column over this round's rows bound for each destination
    chunk (rows outside the round carry the sentinel and never count)."""
    from ..ops import quant as _q

    P = num_partitions
    chunk = (dest.to(torch.int64) // bucket_cap).clamp(max=P)
    scales = []
    for ci, _dt in wire_q8_cols(wplan):
        mag = _q.finite_magnitude(cols[ci][0])
        bm = torch.zeros(P + 1, dtype=torch.float32, device=mag.device).scatter_reduce_(
            0, chunk, mag, "amax")[:P]
        scales.append(_q.safe_scale(bm))
    return torch.stack(scales, 1)


def send_row_scales(scales: torch.Tensor, dest: torch.Tensor, bucket_cap: int) -> torch.Tensor:
    """[n, nq8] per-row scales for the pack: each row its destination
    chunk's (a dropped row clamps to the last chunk; it never ships)."""
    chunk = (dest.to(torch.int64) // bucket_cap).clamp(0, scales.shape[0] - 1)
    return scales.index_select(0, chunk)


def split_header_scales(got: torch.Tensor, num_partitions: int, n_header: int,
                        nq8: int) -> torch.Tensor:
    """[P, nq8] float32 per-source-chunk scales from a received buffer's
    header rows (positions 1..nq8 of each chunk's flattened header)."""
    rows = got.shape[0] // num_partitions
    L = got.shape[1]
    flat = got.view(num_partitions, rows, L)[:, :n_header].reshape(num_partitions, n_header * L)
    return flat[:, 1:1 + nq8].contiguous().view(torch.float32)


def recv_row_scales(scales_recv: torch.Tensor, num_partitions: int, rows: int) -> torch.Tensor:
    """[P * rows, nq8] per-row scales of a received buffer of ``rows`` rows
    a chunk: row i came from source chunk i // rows."""
    return scales_recv.repeat_interleave(rows, 0)


def with_scale_lanes(got: torch.Tensor, wplan, num_partitions: int, n_header: int) -> torch.Tensor:
    """A received buffer with each row's source-chunk q8 scales appended as
    bitcast int32 lanes (header rows too, which B3 skips), so that the
    compact (B3) moves every row's scales with it. Unchanged without q8
    fields."""
    nq8 = len(wire_q8_cols(wplan))
    if not nq8:
        return got
    sc = split_header_scales(got, num_partitions, n_header, nq8).view(torch.int32)
    rows = got.shape[0] // num_partitions
    return torch.cat([got, recv_row_scales(sc, num_partitions, rows)], 1)


def send_lanes(cols: Sequence[KeyCol], wplan, bases, qscales=None) -> torch.Tensor:
    """The row-major ``[n, L]`` send matrix of a column set: the plain
    lanes, or the wire plan's packed words with each float64 passthrough
    column as two lanes behind them."""
    if wplan is None:
        _plan, lanes = pack_cols(cols)
    else:
        words, passthrough = wire_pack_cols(cols, wplan, bases, qscales=qscales)
        lanes = words + [x for ci in sorted(passthrough) for x in _to_lanes(passthrough[ci])]
    return torch.stack(lanes, 1)


def round_send(cols: Sequence[KeyCol], wplan, bases, dest: torch.Tensor, num_partitions: int,
               bucket_cap: int) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(send matrix, header_extra) of one round whose plan holds q8
    fields: the chunk scales of this round's destinations, the words
    encoded under them, the scales bitcast for the header rows."""
    scales = quant_chunk_scales(cols, wplan, dest, num_partitions, bucket_cap)
    packed = send_lanes(cols, wplan, bases, send_row_scales(scales, dest, bucket_cap))
    return packed, scales.view(torch.int32)


def received_cols(ref: Sequence[KeyCol], wplan, bases, moved: torch.Tensor) -> List[KeyCol]:
    """The columns of front-packed received rows ``moved [rows, LM]`` of
    :func:`send_lanes`' layout (plus :func:`with_scale_lanes`' scale lanes
    under a q8 plan); ``ref`` gives the plain layout's schema."""
    def make_valid(lane):
        return None if lane is None else lane.to(torch.bool)

    if wplan is None:
        return compact_received_lanes(lane_plan(ref), moved)
    nw = wplan.n_words
    lanes = list(moved.unbind(1))
    pt_cols = wire_pt_order(wplan, [ci for ci, (tag, _nl, _hv) in enumerate(wplan.plan) if tag is None])
    pos = {ci: nw + 2 * i for i, ci in enumerate(pt_cols)}
    n_lanes = nw + 2 * len(pt_cols)
    nq8 = len(wire_q8_cols(wplan))
    qsc = moved[:, n_lanes:n_lanes + nq8].contiguous().view(torch.float32) if nq8 else None
    return wire_unpack_cols(
        lanes[:nw], wplan, bases,
        lambda ci: _from_lanes(lanes[pos[ci]:pos[ci] + 2], torch.float64), make_valid,
        qscales=qsc,
    )


# ----------------------------------------------------------------------
# hash-sliced send slots (the fused mode's num_slices): ONE stable sort by
# the combined (slice, pid) id serves every slice and round
# ----------------------------------------------------------------------

class SlicePlan(NamedTuple):
    order: torch.Tensor   # [n] stable argsort of comb
    scomb: torch.Tensor   # [n] comb[order]
    bounds: torch.Tensor  # [K * (world + 1) + 1] per-(slice, pid) starts
    world: int
    num_slices: int


def build_slice_plan(pid: torch.Tensor, sid: torch.Tensor, world: int, num_slices: int) -> SlicePlan:
    """pid: [n] target shard (dead rows: world); sid: [n] hash slice (dead
    rows: num_slices). comb = sid * (world + 1) + pid sorts dead rows last;
    its stable argsort is kernel K1's (bounded by the comb's range)."""
    from ..ops import radix as _radix

    comb = (sid.to(torch.int32) * (world + 1) + pid.to(torch.int32)).to(torch.int32)
    order = _radix.argsort_perm(comb, _radix.bound_hint(num_slices * (world + 1) + world + 1))
    scomb = comb.index_select(0, order.to(torch.int64))
    qs = torch.arange(num_slices * (world + 1) + 1, dtype=torch.int32, device=pid.device)
    bounds = torch.searchsorted(scomb, qs, out_int32=True)
    return SlicePlan(order.to(torch.int64), scomb, bounds, world, num_slices)


def slice_counts(plan: SlicePlan, slice_idx: int) -> torch.Tensor:
    """Per-target counts [world] of slice ``slice_idx``."""
    base = slice_idx * (plan.world + 1)
    return plan.bounds[base + 1:base + 1 + plan.world] - plan.bounds[base:base + plan.world]


def slice_round_dest(plan: SlicePlan, slice_idx: int, bucket_cap: int,
                     round_idx: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dest [n] int32, leftover) of one slice and round: the
    :func:`build_send_slots_round` formula inside the slice's contiguous
    span of the sorted space; other slices' rows and dead rows get the
    sentinel ``world * bucket_cap``."""
    world = plan.world
    n = plan.order.shape[0]
    base = slice_idx * (world + 1)
    starts = plan.bounds[base:base + world].to(torch.int64)
    idx = torch.arange(n, dtype=torch.int64, device=plan.order.device)
    in_slice = (idx >= starts[0]) & (idx < plan.bounds[base + world].to(torch.int64))
    spid = (plan.scomb.to(torch.int64) - base).clamp(0, world - 1)
    pos = idx - starts.index_select(0, spid)
    slot = pos - round_idx * bucket_cap
    ok = in_slice & (slot >= 0) & (slot < bucket_cap)
    dest_sorted = torch.where(ok, spid * bucket_cap + slot, world * bucket_cap).to(torch.int32)
    dest = torch.empty(n, dtype=torch.int32, device=plan.order.device)
    dest[plan.order] = dest_sorted
    leftover = (in_slice & (pos >= (round_idx + 1) * bucket_cap)).sum().to(torch.int32)
    return dest, leftover


def exchange_rounds_fused(
    comm,
    shard_cols: Sequence[Sequence[KeyCol]],
    dest_fns,
    counts: Sequence[torch.Tensor],
    num_partitions: int,
    bucket_cap: int,
    n_rounds: int,
    wplan=None,
    topo=None,
) -> Tuple[List[List[KeyCol]], List[torch.Tensor], List[torch.Tensor]]:
    """A table's static-capacity shuffle rounds over every local shard,
    with no host read: per round, each shard's send slots
    (``dest_fns[i](r) -> (dest, leftover)``), its pack into the
    header-fused buffer (the round's counts, and the q8 scales of a
    quantized ``wplan``, ride the header rows), one all_to_all; then ONE
    B3 compact per shard over the concatenated round buffers (R x P
    chunks), the JAX package's compact_received over the concatenated
    round masks. Returns per local shard (columns of ``n_rounds * P *
    bucket_cap`` rows, live rows first; received rows, a device scalar;
    the last round's leftover). Under a 2-D ``topo`` every round's
    exchange is the structured two-hop (``topo.exchange_buffer_structured``):
    the same received layout, routed inner hop first."""
    from ..ops import cuda_codec as _codec

    if topo is not None:
        from . import topo as _topo

        def xchg(bufs):
            return _topo.exchange_buffer_structured(comm, bufs, topo)
    else:
        xchg = comm.all_to_all

    P, bc = num_partitions, bucket_cap
    nh = wire_header_rows(wplan) if wplan is not None else HEADER_ROWS
    q8 = bool(wire_q8_cols(wplan))
    plain = [None if q8 else send_lanes(cols, wplan, None) for cols in shard_cols]
    got_rounds: List[List[torch.Tensor]] = [[] for _ in shard_cols]
    leftovers = [None] * len(shard_cols)
    for r in range(n_rounds):
        bufs = []
        for i, cols in enumerate(shard_cols):
            dest, leftovers[i] = dest_fns[i](r)
            packed, hx = round_send(cols, wplan, None, dest, P, bc) if q8 else (plain[i], None)
            bufs.append(pack_lane_buffer(packed, dest, round_counts(counts[i], bc, r), P, bc,
                                         header_extra=hx, n_header=nh))
        for i, g in enumerate(xchg(bufs)):
            got_rounds[i].append(with_scale_lanes(g, wplan, P, nh))
    out, totals = [], []
    for i, cols in enumerate(shard_cols):
        move = got_rounds[i][0] if n_rounds == 1 else torch.cat(got_rounds[i])
        recv = header_counts(move, n_rounds * P)
        moved = _codec.compact_move(move, recv, n_rounds * P, bc, n_header=nh)
        totals.append(recv.sum())
        out.append(received_cols(cols, wplan, None, moved))
    return out, totals, leftovers
