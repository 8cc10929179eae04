"""Kernels B2 and B3: the chunked shuffle's fused pack and fused compact
(csrc/shuffle_codec.cu; replace cylon_tpu/ops/pallas_codec.py's
``fused_pack_dest`` and ``fused_compact_move``).

B2 is two kernels and one scan, as K1 is (ops/cuda_radix.py):

* B2a :func:`pack_hist` — per row the partition id (the murmur3 chain over
  the key words of :func:`key_words`, or a given pid lane), per tile the
  bucket counts, bucket-major ``[P, n_tiles]``. One launch per table and
  shuffle: its bucket totals are the count phase's send counts;
* :func:`scan_tiles` — each tile's first position within each bucket
  (``torch.cumsum`` along the tiles);
* B2b :func:`pack_dest` — round r's send slot of every row (sentinel
  ``P * bc``). One launch per round.

:func:`fused_pack_dest` composes them into the Pallas function's
``(dest, counts)``. B3 :func:`compact_move` front-packs the live rows of a
received buffer.

Each wrapper launches its CUDA kernel for a CUDA tensor and uses its plain
PyTorch version for a CPU tensor; there is no other route. ``LAUNCHES``
counts kernel launches (the plain versions do not count).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from .. import _build
from ..parallel import shuffle as _sh
from .hash import M32, KeyCol, mul32, murmur3_words, to_words
from .partition import partition_of_hash

#: rows per tile: must equal TILE in csrc/shuffle_codec.cu (checked on load)
TILE = 4096
#: partitions a block's shared-memory histogram holds
MAX_PARTITIONS = 1024
#: int32 elements one compact block copies
_COMPACT_BLOCK_ELEMS = 4096

LAUNCHES = {"pack_hist": 0, "pack_dest": 0, "compact_move": 0}


def n_tiles(cap: int) -> int:
    return -(-cap // TILE)


def _setup(lib) -> None:
    lib.ct_codec_tile.restype = ctypes.c_int
    lib.ct_codec_max_partitions.restype = ctypes.c_int
    if lib.ct_codec_tile() != TILE or lib.ct_codec_max_partitions() != MAX_PARTITIONS:
        raise RuntimeError("shuffle codec: tile sizes differ between CUDA and Python")
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.ct_pack_hist.argtypes = [p, i64, p, i64, p, p, p, i64, i64, i64, i64, p]
    lib.ct_pack_hist.restype = ctypes.c_int
    lib.ct_pack_dest.argtypes = [p, p, p, i64, i64, i64, i64, i64, p]
    lib.ct_pack_dest.restype = ctypes.c_int
    lib.ct_compact_move.argtypes = [p, p, i64, p, i64, i64, i64, i64, i64, p]
    lib.ct_compact_move.restype = ctypes.c_int


def _cuda(t: torch.Tensor, what: str):
    if t.device.type != "cuda":
        raise RuntimeError(f"{what}: no kernel for device {t.device}")
    return _build.library("shuffle_codec", _setup), torch.cuda.current_stream(t.device).cuda_stream


def _check_partitions(P: int, bc: int = 1) -> None:
    if not 1 <= P <= MAX_PARTITIONS:
        raise ValueError(f"shuffle codec: 1 <= P <= {MAX_PARTITIONS}, got {P}")
    if bc < 1 or P * bc >= 2**31:
        raise ValueError(f"shuffle codec: P * bucket_cap must fit int32 (P={P}, bc={bc})")


# ----------------------------------------------------------------------
# the hash prologue (the JAX package's pallas_codec.hash_operands)
# ----------------------------------------------------------------------

def key_words(
    key_cols: Sequence[KeyCol],
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Tuple[bool, ...]]:
    """(words [2 * nk, n] int32 holding each key column's two uint32 hash
    words, valids [nv, n] int32 of the nullable keys or None, has_valid per
    key). The float canonicalization and the float64 split happen here."""
    words, valids = [], []
    for data, valid in key_cols:
        for w in to_words(data):
            words.append(w.to(torch.int32))
        if valid is not None:
            valids.append(valid.to(torch.int32))
    return (
        torch.stack(words, 0),
        torch.stack(valids, 0) if valids else None,
        tuple(v is not None for _d, v in key_cols),
    )


def hash_words(
    words: torch.Tensor, valids: Optional[torch.Tensor], has_valid: Sequence[bool]
) -> torch.Tensor:
    """ops/hash.hash_columns over prepared words: uint32 in int64 [n]."""
    h = None
    vi = 0
    for c, hv in enumerate(has_valid):
        hc = murmur3_words(words[2 * c].to(torch.int64) & M32,
                           words[2 * c + 1].to(torch.int64) & M32)
        if hv:
            hc = torch.where(valids[vi] != 0, hc, torch.zeros_like(hc))
            vi += 1
        h = hc if h is None else (mul32(h, 31) + hc) & M32
    return h


def _check_pack_inputs(words, valids, has_valid, pid):
    if pid is not None:
        if pid.dim() != 1 or pid.dtype != torch.int32:
            raise TypeError("pack: pid must be a 1-D int32 tensor")
        return pid.shape[0]
    if words.dim() != 2 or words.dtype != torch.int32 or words.shape[0] != 2 * len(has_valid):
        raise TypeError("pack: words must be int32 [2 * n_keys, n]")
    if not has_valid:
        raise ValueError("pack: hash mode needs at least one key column")
    nv = sum(bool(v) for v in has_valid)
    if nv:
        if valids is None or valids.dtype != torch.int32 or valids.shape != (nv, words.shape[1]):
            raise TypeError("pack: valids must be int32 [n_nullable_keys, n]")
        if valids.device != words.device:
            raise ValueError("pack: words and valids on different devices")
    return words.shape[1]


# ----------------------------------------------------------------------
# B2a: partition ids + per-tile bucket histogram
# ----------------------------------------------------------------------

def pack_hist_plain(words, valids, has_valid, n: int, P: int, pid=None):
    cap = _check_pack_inputs(words, valids, has_valid, pid)
    device = (pid if pid is not None else words).device
    if pid is not None:
        lane = torch.where((pid >= 0) & (pid <= P), pid, P)
    else:
        lane = partition_of_hash(hash_words(words, valids, has_valid), P)
    lane = lane.to(torch.int32).clone()
    lane[n:] = P
    nt = n_tiles(cap)
    tile = torch.arange(cap, device=device) // TILE
    flat = torch.where(lane < P, lane.to(torch.int64) * nt + tile, P * nt)
    hist = torch.bincount(flat, minlength=P * nt + 1)[: P * nt]
    return lane, hist.to(torch.int32).view(P, nt)


def pack_hist(words, valids, has_valid, n: int, P: int, pid=None):
    """(pid lane int32 [cap], hist int32 [P, n_tiles]): the partition of
    every row (P for dead rows: at or past ``n``, or a given pid outside
    [0, P)) and each tile's rows per bucket. ``pid`` selects pid-input
    mode; ``words``/``valids``/``has_valid`` are then ignored."""
    _check_partitions(P)
    cap = _check_pack_inputs(words, valids, has_valid, pid)
    src = pid if pid is not None else words
    if src.device.type == "cpu":
        return pack_hist_plain(words, valids, has_valid, n, P, pid)
    lib, stream = _cuda(src, "pack_hist")
    nt = n_tiles(cap)
    lane = torch.empty(cap, dtype=torch.int32, device=src.device)
    hist = torch.empty((P, nt), dtype=torch.int32, device=src.device)
    if cap == 0:
        return lane, hist
    if pid is not None:
        if not pid.is_contiguous():
            raise ValueError("pack_hist: pid must be contiguous")
        args = (None, 0, None, 0, pid.data_ptr())
    else:
        if not words.is_contiguous() or (valids is not None and not valids.is_contiguous()):
            raise ValueError("pack_hist: words and valids must be contiguous")
        if len(has_valid) > 62:
            raise ValueError("pack_hist: at most 62 key columns")
        mask = sum(1 << c for c, hv in enumerate(has_valid) if hv)
        args = (
            words.data_ptr(), len(has_valid),
            None if valids is None else valids.data_ptr(), mask, None,
        )
    _build.launch(
        src.device, lib.ct_pack_hist,
        *args, lane.data_ptr(), hist.data_ptr(), cap, min(n, cap), nt, P, stream,
    )
    LAUNCHES["pack_hist"] += 1
    return lane, hist


def scan_tiles(hist: torch.Tensor) -> torch.Tensor:
    """Exclusive scan of ``[P, n_tiles]`` along the tiles: each tile's first
    position within each bucket."""
    return (torch.cumsum(hist, 1, dtype=torch.int32) - hist).contiguous()


# ----------------------------------------------------------------------
# B2b: round r's send slots
# ----------------------------------------------------------------------

def pack_dest_plain(lane, base, round_idx: int, P: int, bc: int) -> torch.Tensor:
    """B2b's plain version, a function of the pid lane alone (``base`` is
    the kernel's precomputed intermediate)."""
    return _sh.build_send_slots_round(lane, _sh.bucket_counts(lane, P), P, bc, round_idx)


def pack_dest(lane, base, round_idx: int, P: int, bc: int) -> torch.Tensor:
    """int32 [cap]: round ``round_idx``'s slot ``pid * bc + pos - r * bc``
    of every row whose stable position ``pos`` within its bucket falls in
    the round's window, else the sentinel ``P * bc``. ``base`` is
    ``scan_tiles(hist)`` of the lane's B2a histogram, computed once for all
    rounds."""
    _check_partitions(P, bc)
    if lane.dim() != 1 or lane.dtype != torch.int32:
        raise TypeError("pack_dest: pid lane must be a 1-D int32 tensor")
    cap = lane.shape[0]
    if base.dtype != torch.int32 or base.shape != (P, n_tiles(cap)):
        raise ValueError("pack_dest: base must be int32 [P, n_tiles]")
    if lane.device.type == "cpu":
        return pack_dest_plain(lane, base, round_idx, P, bc)
    lib, stream = _cuda(lane, "pack_dest")
    if not (lane.is_contiguous() and base.is_contiguous()):
        raise ValueError("pack_dest: pid lane and base must be contiguous")
    dest = torch.empty(cap, dtype=torch.int32, device=lane.device)
    if cap == 0:
        return dest
    _build.launch(
        lane.device, lib.ct_pack_dest,
        lane.data_ptr(), base.data_ptr(), dest.data_ptr(), cap, n_tiles(cap), P,
        round_idx, bc, stream,
    )
    LAUNCHES["pack_dest"] += 1
    return dest


def fused_pack_dest(words, valids, has_valid, n: int, round_idx: int, P: int, bc: int, pid=None):
    """(dest [cap] int32, bucket counts [P] int32) of one pack round: what
    the JAX package's ``fused_pack_dest`` returns, through B2a and B2b."""
    lane, hist = pack_hist(words, valids, has_valid, n, P, pid)
    return pack_dest(lane, scan_tiles(hist), round_idx, P, bc), hist.sum(1, dtype=torch.int32)


def fused_pack_dest_plain(words, valids, has_valid, n: int, round_idx: int, P: int, bc: int, pid=None):
    """The same through the XLA chain's twin: hash_partition_ids ->
    bucket_counts -> build_send_slots_round."""
    lane, _hist = pack_hist_plain(words, valids, has_valid, n, P, pid)
    cnt = _sh.bucket_counts(lane, P)
    return _sh.build_send_slots_round(lane, cnt, P, bc, round_idx), cnt


# ----------------------------------------------------------------------
# B3: the front-pack of a received buffer
# ----------------------------------------------------------------------

def _check_move(move, recv_counts, P, bc, n_header):
    _check_partitions(P, bc)
    if move.dim() != 2 or move.dtype != torch.int32:
        raise TypeError("compact_move: move must be a 2-D int32 tensor")
    if move.shape[0] != P * (bc + n_header):
        raise ValueError("compact_move: move must have P * (bc + n_header) rows")
    if recv_counts.dim() != 1 or recv_counts.shape[0] != P or recv_counts.dtype != torch.int32:
        raise TypeError("compact_move: recv_counts must be int32 [P]")
    if recv_counts.device != move.device:
        raise ValueError("compact_move: move and recv_counts on different devices")


def compact_move_plain(move, recv_counts, P: int, bc: int, n_header: int = 0) -> torch.Tensor:
    lm = move.shape[1]
    data = move.reshape(P, bc + n_header, lm)[:, n_header:].reshape(P * bc, lm)
    mask, _total = _sh.received_row_mask(recv_counts.clamp(0, bc), P, bc)
    return data[torch.argsort(~mask, stable=True)]


def compact_move(move, recv_counts, P: int, bc: int, n_header: int = 0) -> torch.Tensor:
    """int32 ``[P * bc, LM]``: the data rows of ``move`` (chunk p's
    ``bc`` rows follow its ``n_header`` header rows) with the first
    ``clip(recv_counts[p], 0, bc)`` rows of every chunk front-packed in
    (chunk, slot) order and the dead rows behind them in the same order:
    ``data[argsort(~mask, stable=True)]``. ``recv_counts`` may be a strided
    view into ``move``'s header rows."""
    _check_move(move, recv_counts, P, bc, n_header)
    if move.device.type == "cpu":
        return compact_move_plain(move, recv_counts, P, bc, n_header)
    lib, stream = _cuda(move, "compact_move")
    if not move.is_contiguous():
        raise ValueError("compact_move: move must be contiguous")
    lm = move.shape[1]
    out = torch.empty((P * bc, lm), dtype=torch.int32, device=move.device)
    if lm == 0:
        return out
    rows_per_block = max(1, _COMPACT_BLOCK_ELEMS // lm)
    _build.launch(
        move.device, lib.ct_compact_move,
        move.data_ptr(), recv_counts.data_ptr(), recv_counts.stride(0), out.data_ptr(),
        P, bc, n_header, lm, rows_per_block, stream,
    )
    LAUNCHES["compact_move"] += 1
    return out
