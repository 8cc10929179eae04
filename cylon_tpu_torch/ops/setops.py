"""Set-operation primitives (counterpart of cylon_tpu/ops/setops.py).

Only :func:`compact_mask` is ported yet, for the PK-FK join
(ops/pk_join.py); unique, union, subtract and intersect are ROADMAP.md
queue A3.
"""
from __future__ import annotations

from typing import Tuple

import torch


def compact_mask(mask: torch.Tensor, cap_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Front-pack the indices of True entries, with no host sync.

    Returns (idx [cap_out] int64 with -1 padding, count as a device int64
    scalar). The surviving indices are in ascending order: the result is
    the JAX package's stable argsort of ``~mask``, built here as one
    scatter to distinct destinations (True entries to their rank, False
    entries behind them)."""
    n = mask.shape[0]
    m = mask.to(torch.int64)
    rank = torch.cumsum(m, 0) - m  # True entries before me
    total = m.sum()
    idx = torch.arange(n, dtype=torch.int64, device=mask.device)
    dest = torch.where(mask, rank, total + idx - rank)  # a permutation of [0, n)
    order = torch.empty_like(idx).scatter_(0, dest, idx)
    if cap_out <= n:
        order = order[:cap_out]
    else:
        order = torch.cat([order, order.new_full((cap_out - n,), -1)])
    keep = torch.arange(cap_out, dtype=torch.int64, device=mask.device) < total
    return torch.where(keep, order, -1), total
