"""Hash partitioning (counterpart of the hash part of
cylon_tpu/ops/partition.py): murmur3 row hash mod P, with the power-of-two
fast path ``h & (P - 1)``; rows at or past ``n`` get the sentinel P."""
from __future__ import annotations

from typing import Optional, Sequence

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
