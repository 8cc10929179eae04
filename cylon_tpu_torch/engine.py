"""Capacity helpers of the PyTorch port (counterpart of the capacity part
of cylon_tpu/engine.py).

The port's tables hold exact-length shards, so these capacities size only
the shuffle's exchange buffers (``parallel/shuffle.py``) and the row split
of a table loaded from the host, exactly as the JAX package computes them.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def round_cap(n: int, minimum: int = 8) -> int:
    """Round a capacity up to a power of two (>= minimum)."""
    n = max(int(n), minimum)
    return 1 << (n - 1).bit_length()


def shard_caps(total_rows: int, world: int) -> Tuple[np.ndarray, int]:
    """Even row split of a global table: (per-shard counts [P], shard cap)."""
    base, rem = divmod(int(total_rows), world)
    counts = np.array([base + (1 if i < rem else 0) for i in range(world)], np.int64)
    return counts, round_cap(counts.max() if world else 0)
