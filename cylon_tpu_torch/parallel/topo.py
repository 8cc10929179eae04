"""The two-hop topology exchange (counterpart of cylon_tpu/parallel/topo.py):
the (outer x inner) decomposition of the flat W-way all_to_all.

A GPU cluster is not a crossbar either: the cards of one node share
NVLink, and the link between nodes is slower. A context declared with
``mesh_shape="OxI"`` (``GPUConfig``, or ``CYLON_TPU_TORCH_MESH``) reads its
W shards as a LOGICAL 2-D grid: shard ``p`` has outer group ``p // inner``
and inner index ``p % inner`` (outer-major, so an inner group is a
contiguous shard range: the ranks of one node under ``torchrun``, where
inner is the GPUs per node). Every eager shuffle round then runs as two
grouped collectives instead of one flat all_to_all:

  hop 1 (inner axis): an all_to_all inside each inner group routes every
    row to the group-mate whose inner index is the row's destination inner
    index; the chunk headers ride along, so afterwards shard ``(o_s, i_d)``
    holds, for every outer group ``o_d``, the rows its group-mates send to
    ``(o_d, i_d)``, with exact per-(source, o_d) counts in the headers;
  hop 2 (outer axis): same-group rows (``o_d == o_s``) are final after hop
    1. Cross-outer rows are densely repacked (exclusive cumsums of the
    header counts, no sort) into one combined chunk per remote outer group,
    sized ``cap_o`` (the host-planned largest cross-outer aggregate), and
    cross one all_to_all along each outer comb.

The flat exchange pads each of the ``W - inner`` remote chunks a shard
ships across the slow link to ``bucket_cap``; the two-hop exchange pads
``outer - 1`` combined chunks to ``cap_o``, and group-local traffic never
crosses the outer link. The skew tail takes the same decomposition:
same-outer-group relay rows ride a device ``ppermute`` ring
(:func:`ring_relay`) instead of the host relay, and only cross-outer tails
still cross the host (parallel/spill.fetch_relay).

The host half is numpy and equals the JAX package's function for
function. The device half takes torch tensors and a communicator
(context.py): ``all_to_all_grouped`` and ``ppermute`` are its two
collectives. ``CYLON_TPU_TORCH_NO_TOPO=1`` (and any 1-D or degenerate
1xN / Nx1 shape) keeps every shuffle on the flat path.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..engine import round_cap
from ..utils import envgate as _envgate
from . import shuffle as _sh

# kill switch: CYLON_TPU_TORCH_NO_TOPO=1 forces the flat 1-hop exchange on
# any mesh, the flat oracle of the tests
enabled, disabled = _envgate.env_gate(
    "CYLON_TPU_TORCH_NO_TOPO",
    keyed_via="the effective topology is read per shuffle (table._shuffle_state) "
    "and per fused join, whose step it builds; the plan fingerprint carries "
    "the gate (plan/lazy.gated_fingerprint via topo.gate_state)",
    note="=1 forces the flat 1-hop all_to_all on 2-D meshes (flat-oracle "
    "differential); 1-D meshes are always flat",
)

MESH_ENV = _envgate.MESH
OUTER_BUDGET = _envgate.OUTER_BUDGET


class Topology(NamedTuple):
    """The logical 2-D factorization of the shards: ``world == outer *
    inner``; shard ``p`` = (outer group ``p // inner``, inner index
    ``p % inner``)."""

    outer: int
    inner: int


def parse_mesh(spec: str, world: int) -> Optional[Topology]:
    """'OxI' -> Topology, validated against the world size. None for ''
    (flat). Degenerate factors (outer or inner == 1) parse, and collapse to
    flat in :func:`effective`."""
    s = spec.strip().lower()
    if not s:
        return None
    parts = s.split("x")
    if len(parts) != 2:
        raise ValueError(f"CYLON_TPU_TORCH_MESH/mesh_shape {spec!r}: expected 'OxI' (e.g. 4x2)")
    try:
        o, i = int(parts[0]), int(parts[1])
    except ValueError:
        raise ValueError(f"CYLON_TPU_TORCH_MESH/mesh_shape {spec!r}: non-integer factors") from None
    if o < 1 or i < 1:
        raise ValueError(f"mesh_shape {spec!r}: factors must be >= 1")
    if o * i != world:
        raise ValueError(f"mesh_shape {spec!r}: {o}x{i} != world size {world}")
    return Topology(o, i)


def effective(ctx) -> Optional[Topology]:
    """The topology a shuffle decomposes over: the context's declared 2-D
    shape, unless the kill switch is set or an axis is degenerate (1xN and
    Nx1 ARE the flat exchange)."""
    topo = getattr(ctx, "topology", None)
    if topo is None or not enabled():
        return None
    if topo.outer <= 1 or topo.inner <= 1:
        return None
    return topo


def gate_state() -> tuple:
    """The topology component of the plan fingerprint
    (plan/lazy.gated_fingerprint): the kill switch and the raw mesh
    request, so a flip of either re-optimizes instead of reusing a plan
    built under the other state."""
    return (enabled(), MESH_ENV.get())


def inner_groups(topo: Topology) -> Tuple[Tuple[int, ...], ...]:
    """The groups of the inner-axis collectives: one per outer group,
    contiguous shard ranges (the cards of one node)."""
    o, i = topo
    return tuple(tuple(g * i + j for j in range(i)) for g in range(o))


def outer_groups(topo: Topology) -> Tuple[Tuple[int, ...], ...]:
    """The groups of the outer-axis collectives: one per inner index,
    stride-``inner`` shard combs."""
    o, i = topo
    return tuple(tuple(g * i + j for g in range(o)) for j in range(i))


def ring_perm(topo: Topology) -> Tuple[Tuple[int, int], ...]:
    """The inner-axis neighbour ring of :func:`ring_relay`: every shard
    forwards to its next group-mate (wrapping), so after t hops a shard
    holds the buffer its group-mate ``(i - t) mod inner`` extracted."""
    o, i = topo
    return tuple((g * i + j, g * i + (j + 1) % i) for g in range(o) for j in range(i))


# ----------------------------------------------------------------------
# host planning: the outer-hop capacity and the per-axis byte ledger
# ----------------------------------------------------------------------

class TwoHopPlan(NamedTuple):
    """The host-planned state of one two-hop shuffle."""

    outer: int
    inner: int
    cap_o: int        # outer-hop combined-chunk capacity (pow2)
    n_header: int     # header rows per chunk (1: q8 plans stay flat)


def hop2_window_counts(
    send_counts: np.ndarray, topo: Topology, bucket_cap: int, n_rounds: int
) -> np.ndarray:
    """[rounds, world, outer] cross-outer aggregates: entry (r, p, o_d) =
    rows shard ``p = (o_s, i_d)`` ships to outer group ``o_d`` in round r's
    hop 2 = the sum over group-mates i_s of the round window of
    ``send_counts[(o_s, i_s), (o_d, i_d)]``. Same-group entries (o_d ==
    o_s) are zero: those rows are final after hop 1."""
    o, i = topo
    world = o * i
    m = np.asarray(send_counts, np.int64).reshape(world, world)
    out = np.zeros((max(n_rounds, 1), world, o), np.int64)
    for r in range(max(n_rounds, 1)):
        w = np.clip(m - r * bucket_cap, 0, bucket_cap)
        agg = w.reshape(o, i, o, i).sum(axis=1)  # [o_s, o_d, i_d]
        for g in range(o):
            agg[g, g, :] = 0
        out[r] = agg.transpose(0, 2, 1).reshape(world, o)
    return out


def plan_two_hop(
    send_counts: np.ndarray, topo: Topology, bucket_cap: int, n_rounds: int, n_header: int,
) -> TwoHopPlan:
    """Size the outer hop from the fetched count matrix: ``cap_o`` =
    round_cap of the largest per-(shard, remote outer group, round)
    aggregate, exact, so the dense hop-2 repack never overflows."""
    agg = hop2_window_counts(send_counts, topo, bucket_cap, n_rounds)
    cap_o = round_cap(int(agg.max()) if agg.size else 0)
    return TwoHopPlan(topo.outer, topo.inner, cap_o, n_header)


def outer_budget() -> int:
    """The configured outer-hop byte budget; 0 = unset (the shared
    budget). With the shared budget the outer hop always fits: cap_o <=
    inner * bucket_cap, so outer * cap_o <= W * bucket_cap. A tighter one
    makes the planner halve the global budget (more, smaller rounds) until
    the combined buffer fits (table._plan_state)."""
    v = OUTER_BUDGET.get()
    return int(v) if v else 0


def axis_coll_bytes(
    topo: Optional[Topology], world: int, bucket_cap: int, n_rounds: int, row_bytes: int,
    n_header: int, cap_o: Optional[int] = None,
) -> Tuple[int, int]:
    """(intra, inter) collective bytes of one shuffle, the per-axis ledger
    behind ``shuffle.coll_bytes.{intra,inter}``. A chunk a shard keeps
    never leaves it and counts in neither axis.

    flat (``cap_o`` None): every round ships W - 1 remote chunks of
    ``bucket_cap + n_header`` rows a shard, inner - 1 of them to group-mates
    (intra) and W - inner across groups (inter). two-hop: hop 1 ships
    inner - 1 chunks of ``outer * (bucket_cap + n_header)`` rows (intra),
    hop 2 outer - 1 combined chunks of ``cap_o + n_header`` rows (inter).
    No topology: everything is inter by convention."""
    k = max(int(n_rounds), 1)
    rows_chunk = int(bucket_cap) + int(n_header)
    if topo is None:
        return 0, k * world * (world - 1) * rows_chunk * int(row_bytes)
    o, i = topo
    if cap_o is None:
        intra = k * world * (i - 1) * rows_chunk * int(row_bytes)
        inter = k * world * (world - i) * rows_chunk * int(row_bytes)
        return intra, inter
    intra = k * world * (i - 1) * o * rows_chunk * int(row_bytes)
    inter = k * world * (o - 1) * (int(cap_o) + int(n_header)) * int(row_bytes)
    return intra, inter


def split_relay(
    relay: Optional[np.ndarray], topo: Topology
) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """(intra, inter) split of the skew relay's [src, dst] count matrix:
    same-outer-group tails ride the device ring, cross-outer tails keep the
    host relay. An empty part is None."""
    if relay is None:
        return None, None
    o, i = topo
    world = o * i
    m = np.asarray(relay, np.int64).reshape(world, world)
    same = np.equal.outer(np.arange(world) // i, np.arange(world) // i)
    intra = np.where(same, m, 0)
    inter = np.where(same, 0, m)
    return (intra if intra.sum() else None, inter if inter.sum() else None)


def ring_cap(relay_intra: np.ndarray) -> int:
    """Pow2 ring buffer rows a source: the largest intra-group tail any
    one shard extracts."""
    return round_cap(int(np.asarray(relay_intra).sum(axis=1).max()))


def ring_bytes(topo: Topology, cap_ri: int, row_bytes: int) -> int:
    """Bytes the relay ring ships a shard: inner - 1 ppermute steps of the
    ring buffer (payload rows and the int32 pid lane)."""
    return (topo.inner - 1) * int(cap_ri) * (int(row_bytes) + 4)


def round_split(send_counts: np.ndarray, topo: Topology, bucket_cap: int,
                round_idx: int) -> Tuple[np.ndarray, np.ndarray]:
    """([W] self rows, [W] hop-2 rows) each shard receives in one round: the
    rows its own outer group sends it (final after hop 1), and the rest."""
    o, i = topo
    world = o * i
    w = np.clip(np.asarray(send_counts, np.int64) - round_idx * bucket_cap, 0, bucket_cap)
    same = np.equal.outer(np.arange(world) // i, np.arange(world) // i)
    self_rows = np.where(same, w, 0).sum(axis=0)
    return self_rows, w.sum(axis=0) - self_rows


# ----------------------------------------------------------------------
# device half: torch tensors of the shards this process owns
# ----------------------------------------------------------------------

def chunks_to_inner_major(buf: torch.Tensor, topo: Topology, rows: int) -> torch.Tensor:
    """Permute a ``[W * rows, ...]`` chunked buffer from global-pid order
    (o_d, i_d) to inner-destination-major (i_d, o_d) order, the hop-1
    layout where chunk j gathers everything bound for inner index j: a
    view, then one contiguous copy. Headers ride inside their chunks."""
    o, i = topo
    t = buf.shape[1:]
    return buf.view(o, i, rows, *t).transpose(0, 1).contiguous().view(o * i * rows, *t)


def exchange_buffer_structured(comm, bufs: Sequence[torch.Tensor],
                               topo: Topology) -> List[torch.Tensor]:
    """The structured two-hop drop-in for ``shuffle.exchange_buffer``: the
    same input (send chunks in global-pid order) and the SAME output
    layout (chunk p = what shard p sent), routed as an inner hop then an
    outer hop. Chunks keep their size, so it ships the flat exchange's
    cross-outer bytes in outer - 1 larger messages, and same-group rows
    never cross the outer link. The fused mode rides it; the eager engine
    takes the count-informed dense :func:`two_hop_exchange`."""
    o, i = topo
    rows = bufs[0].shape[0] // (o * i)
    got1 = comm.all_to_all_grouped(
        [chunks_to_inner_major(b, topo, rows) for b in bufs], inner_groups(topo))
    # each member holds [i_s, o_d, rows]: outer-destination-major for hop 2
    b2 = [chunks_to_inner_major(g, Topology(i, o), rows) for g in got1]
    return comm.all_to_all_grouped(b2, outer_groups(topo))


def hop2_slots(cnt: torch.Tensor, topo: Topology, bucket_cap: int, cap_o: int, n_header: int,
               o_self: int) -> torch.Tensor:
    """Dense hop-2 destinations of every row of a hop-1 received buffer
    ``[inner * outer * (bucket_cap + n_header)]`` (headers included): row
    ``pos`` of chunk (i_s, o_d) is live iff ``pos < cnt[i_s, o_d]`` and
    ``o_d != o_self``, and front-packs combined chunk o_d after its header
    rows at the exclusive cumsum of ``cnt`` over i_s. int64; header and
    dead rows get a spare row past the ``outer * (cap_o + n_header)``
    buffer (the JAX package's scatter drops them; spread over
    ``shuffle.DROP_ROWS`` rows, so their writes do not all hit one
    address)."""
    o, i = topo
    rows1, rows2 = bucket_cap + n_header, cap_o + n_header
    dev = cnt.device
    idx = torch.arange(i * o * rows1, device=dev)
    i_s = idx // (o * rows1)
    o_d = (idx // rows1) % o
    pos = idx % rows1 - n_header
    c = cnt.to(torch.int64)
    off = torch.cumsum(c, 0) - c  # exclusive over i_s per o_d
    flat = i_s * o + o_d
    live = (pos >= 0) & (pos < c.reshape(-1)[flat]) & (o_d != o_self)
    return torch.where(live, o_d * rows2 + n_header + off.reshape(-1)[flat] + pos,
                       o * rows2 + idx % _sh.DROP_ROWS)


def self_chunk(got1: torch.Tensor, topo: Topology, rows: int, o_self: int,
               n_header: int = 0) -> torch.Tensor:
    """The same-outer-group sub-chunks of a hop-1 received buffer
    ``[inner * outer * rows, ...]`` without their ``n_header`` header rows,
    ``[inner * (rows - n_header), ...]`` in one copy: these rows are final,
    their destination is this shard."""
    o, i = topo
    t = got1.shape[1:]
    return got1.view(i, o, rows, *t)[:, o_self, n_header:].reshape(i * (rows - n_header), *t)


def two_hop_exchange(comm, heads: Sequence[torch.Tensor], shards: Sequence[int], topo: Topology,
                     bucket_cap: int, cap_o: int, n_header: int):
    """One eager round's two-hop exchange (in place of the flat
    ``exchange_buffer``). ``heads[k]`` is local shard ``shards[k]``'s
    header-augmented send buffer ``[W * (bucket_cap + n_header), L]``, the
    pack's output unchanged. Returns per local shard ``(got2, self_rows,
    self_cnt)``: ``self_rows [inner * bucket_cap, L]`` the same-group rows
    (final after hop 1) with per-source counts ``self_cnt [inner]`` (a
    strided int32 view into the hop-1 headers), and ``got2 [outer * (cap_o
    + n_header), L]`` the combined cross-outer chunks after hop 2, whose
    headers carry the combined counts. Kernel B3 front-packs each part."""
    o, i = topo
    rows1, rows2 = bucket_cap + n_header, cap_o + n_header
    got1 = comm.all_to_all_grouped(
        [chunks_to_inner_major(h, topo, rows1) for h in heads], inner_groups(topo))
    bufs2, selfs = [], []
    for d, g in zip(shards, got1):
        o_self = d // i
        lanes = g.shape[1]
        g1 = g.view(i, o, rows1, lanes)
        cnt = g1[:, :, 0, 0]  # [i_s, o_d] exact counts
        selfs.append((self_chunk(g, topo, rows1, o_self, n_header), g1[:, o_self, 0, 0]))
        # hop 2: the cross-outer rows densely repacked behind combined headers
        buf2 = torch.zeros((o * rows2 + _sh.DROP_ROWS, lanes), dtype=g.dtype, device=g.device)
        tot = cnt.sum(0, dtype=torch.int32)
        tot[o_self] = 0
        buf2[:o * rows2].view(o, rows2, lanes)[:, 0, 0] = tot
        buf2.index_copy_(0, hop2_slots(cnt, topo, bucket_cap, cap_o, n_header, o_self), g)
        bufs2.append(buf2[:o * rows2])
    got2 = comm.all_to_all_grouped(bufs2, outer_groups(topo))
    return [(g2, sr, sc) for g2, (sr, sc) in zip(got2, selfs)]


def two_hop_received(got2: torch.Tensor, self_rows: torch.Tensor, self_cnt: torch.Tensor,
                     topo: Topology, bucket_cap: int, cap_o: int, n_header: int):
    """The JAX package's receive side of a two-hop round as one (rows,
    mask, total) triple: the same-group rows first (live by the hop-1
    counts), then the hop-2 combined chunks (live by their header counts).
    The engine front-packs the two parts with kernel B3 instead, which
    gives ``rows[argsort(~mask, stable=True)][:total]``; this form is its
    plain reference."""
    o, i = topo
    data2, recv2 = _sh.split_header(got2, o, n_header)
    mask2, tot2 = _sh.received_row_mask(recv2, o, cap_o)
    mask1, tot1 = _sh.received_row_mask(self_cnt, i, bucket_cap)
    return (torch.cat([self_rows, data2]), torch.cat([mask1, mask2]),
            (tot1 + tot2).to(torch.int32))


def ring_extract(cols, lane: torch.Tensor, base: torch.Tensor, intra_row: np.ndarray, quota: int,
                 cap_ri: int) -> torch.Tensor:
    """One source's ring buffer ``[cap_ri, L + 1]`` int32: its
    same-outer-group relay rows (``intra_row``: this source's row of the
    split relay matrix) as plain lanes in slot order, destination-major,
    and last the pid lane (B2a's destination; -1 on the dead slots
    behind)."""
    from ..ops.gather import pack_cols
    from .spill import relay_rows

    idx, sel = relay_rows(cols, lane, base, intra_row, quota)
    n = idx.shape[0]
    _plan, lanes = pack_cols(sel)
    buf = torch.zeros((cap_ri, len(lanes) + 1), dtype=torch.int32, device=lane.device)
    buf[:n, :-1] = torch.stack(lanes, 1)
    buf[:, -1] = -1
    buf[:n, -1] = lane.index_select(0, idx).to(torch.int32)
    return buf


def ring_relay(comm, bufs: Sequence[torch.Tensor], shards: Sequence[int], topo: Topology,
               expect: np.ndarray):
    """The device-direct intra-group skew relay: rotate every local shard's
    ring buffer (:func:`ring_extract`) around the inner-axis neighbour
    ring (inner - 1 ``ppermute`` steps, never a host crossing), stack the
    steps (step t holds group-mate ``(i_self - t) mod inner``'s buffer)
    and front-pack, in step order, the rows whose pid lane names this
    shard. Returns per local shard (its ``expect[d]`` absorbed rows as
    ``[rows, L]`` plain lanes, the absorbed count: a device scalar for the
    deferred check)."""
    steps = [[b] for b in bufs]
    cur = list(bufs)
    for _t in range(1, topo.inner):
        cur = comm.ppermute(cur, ring_perm(topo))
        for k, c in enumerate(cur):
            steps[k].append(c)
    out = []
    for d, st in zip(shards, steps):
        stacked = torch.cat(st)
        mask = stacked[:, -1] == d
        order = torch.argsort(~mask, stable=True)[: int(expect[d])]
        out.append((stacked.index_select(0, order)[:, :-1], mask.sum()))
    return out
