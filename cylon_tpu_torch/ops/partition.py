"""Partition-id assignment (counterpart of cylon_tpu/ops/partition.py):
hash partitioning, murmur3 row hash mod P with the power-of-two fast path
``h & (P - 1)`` (rows at or past ``n`` get the sentinel P), and the
sample-sort range partitioning of ``distributed_sort``, whose global
min/max and bin histogram come through the communicator's ``all_reduce``
(the JAX package's ``lax.pmin``/``pmax``/``psum``)."""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from .hash import KeyCol, hash_columns


def partition_of_hash(h: torch.Tensor, num_partitions: int) -> torch.Tensor:
    """int32 partition of uint32 hashes (carried in int64)."""
    if num_partitions & (num_partitions - 1) == 0:
        return (h & (num_partitions - 1)).to(torch.int32)
    return (h % num_partitions).to(torch.int32)


def hash_partition_ids(
    key_cols: Sequence[KeyCol], n: Optional[int], num_partitions: int
) -> torch.Tensor:
    """Target partition per row (int32); rows ``>= n`` -> ``num_partitions``.
    ``n=None`` means every row is live (the port's exact-length shards)."""
    pid = partition_of_hash(hash_columns(key_cols), num_partitions)
    if n is not None and n < pid.shape[0]:
        pid[n:] = num_partitions
    return pid


_F64_MAX = torch.finfo(torch.float64).max


def _as_float(data: torch.Tensor) -> torch.Tensor:
    """The key as float64, NaN as 0. uint64 converts as two exact halves
    whose sum rounds once: the nearest float64, as XLA's conversion."""
    if data.dtype.is_floating_point:
        data = torch.where(torch.isnan(data), torch.zeros_like(data), data)
    if data.dtype == torch.uint64:
        bits = data.view(torch.int64)
        hi = ((bits >> 32) & 0xFFFFFFFF).to(torch.float64)
        return hi * 4294967296.0 + (bits & 0xFFFFFFFF).to(torch.float64)
    return data.to(torch.float64)


def _saturating_int(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Float -> integer ``dtype`` as XLA converts: truncating toward zero,
    saturating at the integer's range, NaN -> 0, where a plain
    ``Tensor.to`` leaves the out-of-range values undefined."""
    info = torch.iinfo(dtype)
    top, bottom = float(info.max) + 1.0, float(info.min)  # powers of two, exact
    high, low = x >= top, x < bottom
    safe = torch.where(torch.isnan(x) | high | low, torch.zeros_like(x), x)
    out = safe.to(dtype)
    out = torch.where(high, torch.full_like(out, info.max), out)
    return torch.where(low, torch.full_like(out, info.min), out)


def range_partition_ids(
    keys: Sequence[KeyCol],
    num_partitions: int,
    comm,
    num_bins: Optional[int] = None,
    ascending: bool = True,
) -> List[torch.Tensor]:
    """Sample-sort range partitioning on one key column, bit for bit the
    JAX package's: ``keys`` holds the (data, valid) of each shard this
    process owns (every shard under the single-process communicator, one
    under torch.distributed), and the result those shards' int32
    partition lanes.

    Global lo/hi over the live keys and a ``num_bins`` equal-width histogram
    (default 16 * P) come through ``comm.all_reduce``; bin -> partition is
    the equal-weight split of the exclusive cumulative counts, so partition
    i holds keys <= partition i+1's (reversed when descending). Nulls go to
    the last partition, as the nulls-last sort puts them."""
    P = num_partitions
    nb = 16 * P if not num_bins else int(num_bins)
    xs = [_as_float(d) for d, _v in keys]
    oks = [torch.ones_like(x, dtype=torch.bool) if v is None else v for x, (_d, v) in zip(xs, keys)]

    def extreme(x, ok, fill, fn):
        vals = torch.where(ok, x, torch.full_like(x, fill))
        return fn(torch.cat([vals, vals.new_full((1,), fill)]))

    lo = comm.all_reduce([extreme(x, ok, _F64_MAX, torch.amin) for x, ok in zip(xs, oks)], "min")
    hi = comm.all_reduce([extreme(x, ok, -_F64_MAX, torch.amax) for x, ok in zip(xs, oks)], "max")
    bins = []
    for x, ok, lo_s, hi_s in zip(xs, oks, lo, hi):
        span = torch.clamp(hi_s - lo_s, min=1e-300)
        b = _saturating_int((x - lo_s) / span * nb, torch.int32).clamp(0, nb - 1)
        bins.append(torch.where(ok, b, nb))  # nulls counted out of range
    hists = comm.all_reduce(
        [torch.bincount(b.to(torch.int64), minlength=nb + 1)[:nb] for b in bins], "sum"
    )
    out = []
    for b, ok, hist in zip(bins, oks, hists):
        total = hist.sum()
        cum = torch.cumsum(hist, 0) - hist  # exclusive
        per_part = torch.clamp(total.to(torch.float64) / P, min=1.0)
        bin_to_part = _saturating_int(cum.to(torch.float64) / per_part, torch.int32).clamp(0, P - 1)
        pid = bin_to_part.index_select(0, b.clamp(0, nb - 1).to(torch.int64))
        if not ascending:
            pid = P - 1 - pid
        out.append(torch.where(ok, pid, P - 1).to(torch.int32))
    return out
