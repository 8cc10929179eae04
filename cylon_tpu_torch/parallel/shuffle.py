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
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..engine import round_cap
from ..ops.gather import KeyCol, lane_plan, unpack_cols

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


def pack_lane_buffer(
    packed: torch.Tensor,
    dest: torch.Tensor,
    counts_round: torch.Tensor,
    num_partitions: int,
    bucket_cap: int,
) -> torch.Tensor:
    """Scatter the row-major lanes ``packed [n, L]`` into the send buffer
    ``[P * (bucket_cap + 1), L]``; each chunk's header row carries this
    round's send count for its destination in lane 0, the rest is zeros."""
    P = num_partitions
    rows = bucket_cap + HEADER_ROWS
    n, L = packed.shape
    body = P * rows
    buf = torch.zeros((body + DROP_ROWS, L), dtype=torch.int32, device=packed.device)
    buf[:body].view(P, rows, L)[:, 0, 0] = counts_round.to(torch.int32)
    hs = header_slots(dest, P, bucket_cap)
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
