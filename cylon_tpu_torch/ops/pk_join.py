"""PK-FK inner join through hash buckets (counterpart of
cylon_tpu/ops/pallas_join.py).

For an inner join on one integer key whose right side is unique (a primary
key), the probe needs no merged sort of both sides:

1. :func:`bucket_layout` puts each side's rows into ``nb`` hash buckets of
   ``B`` slots: bucket id ``murmur3(key) & (nb - 1)`` (ops/hash.py, the
   JAX package's hash bit for bit; at world W > 1 the bits above the
   shuffle's ``log2 W`` partition bits), a stable radix argsort by bucket
   id (two K1 passes at nb = 65536), per-bucket offsets and a padded
   gather. Equal keys land in the same bucket on both sides.
2. kernel B5 (ops/cuda_probe.py) finds, per left slot, the largest
   matching right row id of its bucket (a shared-memory hash table of the
   bucket's right keys on the card).
3. the hits are compacted to the front in left-bucket order.

Right-key uniqueness and bucket overflow are speculated: ``bad`` reports a
miss and the caller reruns the exact sort join, as in the JAX package.
At world 1 the output order (left rows by bucket, then by row) is the JAX
package's whenever ``nb`` is, which :func:`bucket_count` sizes from the
capacities.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..engine import round_cap
from . import cuda_probe as _cp
from . import radix as _radix
from .gather import gather_rows
from .hash import murmur3_column
from .setops import compact_mask
from .sort import orderable_key

#: bucket width of the Table path (the JAX package's)
B_DEFAULT = 256

#: speculation misses of Table.join(algorithm="pallas_pk") that reran the
#: exact sort join
COUNTS = {"fallback": 0}

#: key dtypes the probe takes: integers of at most 32 bits
KEY_DTYPES = (torch.int8, torch.int16, torch.int32, torch.uint8, torch.uint16, torch.uint32)


def probe_lane(keys: torch.Tensor) -> torch.Tensor:
    """Keys as int32 bit patterns: signed types sign-extended, uint8/16
    zero-extended, uint32 reinterpreted. Each map is injective, so lane
    equality is key equality."""
    if keys.dtype not in KEY_DTYPES:
        raise TypeError(f"pk probe: key dtype {keys.dtype} is not an integer of <= 32 bits")
    if keys.dtype == torch.uint32:
        return keys.contiguous().view(torch.int32)
    return keys.to(torch.int32)


def pad_key(dtype: torch.dtype) -> int:
    """The empty slots' key, the JAX package's ``iinfo(dtype).min``, as
    :func:`probe_lane` maps it."""
    return int(torch.iinfo(dtype).min) if dtype.is_signed else 0


def bucket_count(cap_l: int, cap_r: int, B: int) -> int:
    """Buckets for about half-full buckets at the larger side's capacity
    (the smaller would overflow by pigeonhole): a power of two."""
    need = max(int(max(cap_l, cap_r) // max(B // 2, 1)), 1)
    return 1 << (need - 1).bit_length()


def bucket_layout(
    keys: torch.Tensor, nb: int, B: int, shift: int = 0
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Arrange the rows into ``nb`` hash buckets of ``B`` slots, bucket id
    ``(murmur3(key) >> shift) & (nb - 1)``.

    Returns (bucketed key lane int32 [nb*B], bucketed row id int32 [nb*B]
    with -1 on an empty slot, overflow flag): slot j of bucket b holds the
    j-th row of b in row order, and a bucket with more than B rows keeps
    its first B and sets the flag."""
    device = keys.device
    bucket = ((murmur3_column(keys) >> shift) & (nb - 1)).to(torch.int32)
    order = _radix.argsort_perm(bucket, _radix.bound_hint(nb - 1))
    cnt = torch.bincount(bucket.to(torch.int64), minlength=nb)
    offs = torch.cumsum(cnt, 0) - cnt
    overflow = (cnt > B).any()
    slot = torch.arange(nb * B, dtype=torch.int64, device=device)
    bb = slot // B
    w = slot - bb * B
    valid = w < cnt.index_select(0, bb)
    row = gather_rows(order, offs.index_select(0, bb) + w)  # clamped; masked below
    lane = gather_rows(probe_lane(keys), row)
    keys_b = torch.where(valid, lane, pad_key(keys.dtype))
    idx_b = torch.where(valid, row, -1)
    return keys_b.contiguous(), idx_b.to(torch.int32).contiguous(), overflow


def _has_duplicates(keys: torch.Tensor) -> torch.Tensor:
    """Device bool: two equal keys (adjacent equality after a radix sort)."""
    if keys.shape[0] < 2:
        return torch.zeros((), dtype=torch.bool, device=keys.device)
    # an orderable_key lane is its own digit lane, so the sort returns it
    # sorted; lane equality is key equality
    s, _ = _radix.sort_lane(orderable_key(keys))
    return (s[1:] == s[:-1]).any()


def pk_inner_join(
    l_key: torch.Tensor,
    r_key: torch.Tensor,
    nb: int = 0,
    B: int = B_DEFAULT,
    caps: Optional[Tuple[int, int]] = None,
    shift: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Inner join of two integer key columns, the right one unique.

    ``nb=0`` sizes the buckets by :func:`bucket_count` from ``caps`` (the
    two sides' capacities; default their lengths), else ``nb`` is rounded
    up to a power of two >= 8, as in the JAX package. ``shift`` drops that
    many low bits of the hash before the bucket id is taken (see
    Table._pallas_pk_join). Returns, with no host
    sync, (l_idx [nl] int64, r_idx [nl] int64, total, bad): slots
    ``[:total]`` pair left row ``l_idx[i]`` with right row ``r_idx[i]``,
    the rest hold -1; ``bad`` (int32) is nonzero when a bucket overflowed
    or the right keys repeat, and then the caller reruns the exact join."""
    if nb == 0:
        cap_l, cap_r = caps if caps is not None else (l_key.shape[0], r_key.shape[0])
        nb = bucket_count(cap_l, cap_r, B)
    else:
        nb = round_cap(nb, minimum=8)
    lkb, lib, ov_l = bucket_layout(l_key, nb, B, shift)
    rkb, rib, ov_r = bucket_layout(r_key, nb, B, shift)
    bad = (ov_l | ov_r | _has_duplicates(r_key)).to(torch.int32)
    matched = _cp.probe(lkb, rkb, rib, nb, B)
    hit = (matched >= 0) & (lib >= 0)
    pos, total = compact_mask(hit, l_key.shape[0])
    safe = pos.clamp(0, nb * B - 1)
    l_idx = torch.where(pos >= 0, lib.index_select(0, safe).to(torch.int64), -1)
    r_idx = torch.where(pos >= 0, matched.index_select(0, safe).to(torch.int64), -1)
    return l_idx, r_idx, total, bad
