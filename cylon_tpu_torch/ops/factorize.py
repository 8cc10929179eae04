"""Dense-id factorization of rows by key columns (counterpart of
cylon_tpu/ops/factorize.py).

Rows are lexsorted over their canonical key lanes (radix passes, kernel K1)
and run-detected; each distinct key tuple gets a dense id in sorted key
order (null == null; nulls after every value).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..dtypes import promote_key_dtypes
from .sort import KeyCol, canonical_row_lanes, sentinel_compact, sorted_runs


def factorize(key_cols: Sequence[KeyCol], fuse=None) -> Tuple[torch.Tensor, int]:
    """(ids [n] int32 in sorted key order, number of groups). One host sync
    reads the group count. ``fuse``: a sort-word fusion plan
    (ops/sort.FusePlan) of the canonical lanes: the same ids."""
    n = key_cols[0][0].shape[0]
    device = key_cols[0][0].device
    if n == 0:
        return torch.zeros(0, dtype=torch.int32, device=device), 0
    order, diff = sorted_runs(canonical_row_lanes(key_cols, fuse), fuse)
    ids_sorted = torch.cumsum(diff.to(torch.int32), 0, dtype=torch.int32) - 1
    num_groups = int(ids_sorted[-1].item()) + 1
    (ids,) = sentinel_compact(order, [ids_sorted])  # back to row order
    return ids, num_groups


def factorize_two(
    l_cols: Sequence[KeyCol], r_cols: Sequence[KeyCol], fuse=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Joint factorization of two tables' key rows onto one dense id space
    (equal key tuples across the tables share an id). Returns (l_ids [nl],
    r_ids [nr]) int32; ids are < nl + nr. ``fuse``: a fusion plan over the
    concatenated key columns, sized by both sides' merged stats."""
    nl = l_cols[0][0].shape[0]
    nr = r_cols[0][0].shape[0]
    device = l_cols[0][0].device
    cat_cols = []
    for (ld, lv), (rd, rv) in zip(l_cols, r_cols):
        common = ld.dtype if ld.dtype == rd.dtype else promote_key_dtypes(ld.dtype, rd.dtype)
        data = torch.cat([ld.to(common), rd.to(common)])
        if lv is None and rv is None:
            valid = None
        else:
            lvm = torch.ones(nl, dtype=torch.bool, device=device) if lv is None else lv
            rvm = torch.ones(nr, dtype=torch.bool, device=device) if rv is None else rv
            valid = torch.cat([lvm, rvm])
        cat_cols.append((data, valid))
    n = nl + nr
    if n == 0:
        empty = torch.zeros(0, dtype=torch.int32, device=device)
        return empty, empty
    order, diff = sorted_runs(canonical_row_lanes(cat_cols, fuse), fuse)
    ids_sorted = torch.cumsum(diff.to(torch.int32), 0, dtype=torch.int32) - 1
    (ids,) = sentinel_compact(order, [ids_sorted])
    return ids[:nl], ids[nl:]
