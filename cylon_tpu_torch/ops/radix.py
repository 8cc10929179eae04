"""LSD radix sort engine (counterpart of cylon_tpu/ops/radix.py).

Every integer ordering of the port is a chain of lane sorts of kernel K1
(ops/cuda_radix.radix_sort_lane: stable 8-bit passes that carry the keys and
a permutation): the JAX package's ``radix_pallas`` tier made the only tier. A digit lane is a uint32 (held in
an int32 tensor) or uint64 (held in int64) bit pattern whose unsigned order
is the lane's order; the lane plan below maps each sort lane onto one, with
an optional hint that narrows the bit span.

Float lanes (the f64 total-order lane of ops/sort.orderable_key) have no
digit decomposition: a lexsort holding one declines, exactly where the JAX
package declines, and the caller sorts with ``torch.sort(stable=True)``.
``COUNTS["declined"]`` counts those declines; ``COUNTS["passes"]`` counts the
8-bit digit passes the sorts run (the profiler's sort stage units).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from . import cuda_radix as _cr

#: digit width of every pass (the JAX package's PALLAS_RADIX_BITS)
RADIX_BITS = 8

COUNTS = {"declined": 0, "passes": 0}

#: ("span", lo, hi): unsigned values with significant bits in [lo, hi);
#: ("bias", b, bits): small signed lane, (lane + b) fits ``bits`` bits
Hint = Tuple[str, int, int]

_SPAN = "span"
_BIAS = "bias"


def bias_hint(bias: int, bits: int) -> Hint:
    return (_BIAS, int(bias), int(bits))


def bound_hint(upper: int) -> Hint:
    """Span hint for a non-negative integer lane with values <= upper."""
    return (_SPAN, 0, max(int(upper).bit_length(), 1))


def span_hint(lo: int, hi: int) -> Hint:
    """Span hint for an unsigned lane whose significant bits are [lo, hi)."""
    return (_SPAN, int(lo), int(hi))


def fuse_word_hints(fuse) -> List[Optional[Hint]]:
    """Least-significant-first span hints of a FusePlan's fused sort words
    (ops/sort.py): the layout packs unused bits at the bottom of the last
    word as constant-zero tie padding, so those digits are skipped."""
    from .stats import layout_words

    bits_list = [b for _k, _p, b, _a in fuse.fields]
    layout = layout_words(bits_list, fuse.allow64)
    widths = [w for w, _ in layout]
    unused = sum(widths) - sum(bits_list)
    hints: List[Optional[Hint]] = [span_hint(0, w) for w in reversed(widths)]
    if hints:
        hints[0] = span_hint(unused, hints[0][2])
    return hints


def _digit_lane(
    lane: torch.Tensor, hint: Optional[Hint]
) -> Optional[Tuple[torch.Tensor, int, int, bool]]:
    """(digit lane, lo_bit, hi_bit, whether the digit lane is ``lane``
    itself), or None for a float lane. Lanes that come from
    ops/sort.orderable_key are already int32/int64 unsigned bit patterns;
    narrower or signed lanes are shifted into unsigned order."""
    dt = lane.dtype
    if hint is not None and hint[0] == _BIAS:
        _, bias, bits = hint
        return (lane.to(torch.int32) + bias).contiguous(), 0, int(bits), False
    if dt == torch.bool:
        return lane.to(torch.int32), 0, 1, False
    if dt.is_floating_point:
        return None
    if hint is not None and hint[0] == _SPAN:
        _, lo, hi = hint
        if dt in (torch.int64, torch.uint64) and hi > 32:
            return lane.view(torch.int64).contiguous(), int(lo), int(hi), dt == torch.int64
        return lane.to(torch.int32).contiguous(), int(lo), int(hi), dt == torch.int32
    size = lane.element_size()
    if dt in (torch.uint8, torch.uint16):
        return lane.to(torch.int32), 0, 8 * size, False
    if dt == torch.uint32:
        return lane.view(torch.int32).contiguous(), 0, 32, False
    if dt == torch.uint64:
        return lane.view(torch.int64).contiguous(), 0, 64, False
    if size == 1:
        return lane.to(torch.int32) + 128, 0, 8, False
    if size == 2:
        return lane.to(torch.int32) + 32768, 0, 16, False
    # int32 / int64 lanes are the orderable_key patterns themselves
    return lane.contiguous(), 0, 8 * size, True


def plan_lanes(
    lanes: Sequence[torch.Tensor], hints: Optional[Sequence[Optional[Hint]]] = None
) -> Optional[List[Tuple[torch.Tensor, int, int, bool]]]:
    """Digit-lane plan (:func:`_digit_lane` per lane) for a
    least-significant-first lane stack, or None when any lane is a float
    lane (the whole sort then declines)."""
    out = []
    for i, lane in enumerate(lanes):
        h = hints[i] if hints is not None and i < len(hints) else None
        pl = _digit_lane(lane, h)
        if pl is None:
            return None
        out.append(pl)
    return out


def lexsort_perm(
    lanes: Sequence[torch.Tensor],
    n: int,
    hints: Optional[Sequence[Optional[Hint]]] = None,
) -> Optional[torch.Tensor]:
    """Stable lexsort permutation (int32) over ``lanes``, least-significant
    FIRST, one K1 lane sort per lane (the next lane gathered through the
    carried perm once, at its entry); None when a float lane declines the
    sort. The stable lexsort permutation is unique, so the result equals
    any other stable lexsort's."""
    planned = plan_lanes(lanes, hints)
    if planned is None:
        COUNTS["declined"] += 1
        return None
    perm = None
    for enc, lo, hi, _ in planned:
        COUNTS["passes"] += _cr.n_passes(lo, hi)
        _, perm = _cr.radix_sort_lane(enc, perm, lo, hi)
    if perm is None:
        device = lanes[0].device if lanes else torch.device("cpu")
        perm = torch.arange(n, dtype=torch.int32, device=device)
    return perm


def sort_lane(
    lane: torch.Tensor, hint: Optional[Hint] = None
) -> Optional[Tuple[Optional[torch.Tensor], torch.Tensor]]:
    """One K1 lane sort of ``lane``: (``lane`` sorted, or None where the
    digit lane is a transform of it (narrowed, biased, reinterpreted); its
    stable argsort perm int32). None for a float lane, counted as a
    decline."""
    planned = plan_lanes([lane], [hint])
    if planned is None:
        COUNTS["declined"] += 1
        return None
    enc, lo, hi, is_lane = planned[0]
    COUNTS["passes"] += _cr.n_passes(lo, hi)
    skeys, perm = _cr.radix_sort_lane(enc, None, lo, hi)
    return (skeys if is_lane else None), perm


def argsort_perm(
    lane: torch.Tensor, hint: Optional[Hint] = None
) -> Optional[torch.Tensor]:
    """Radix replacement for a stable argsort of one lane."""
    res = sort_lane(lane, hint)
    return None if res is None else res[1]


def kv_sort(
    keys: torch.Tensor, pay: torch.Tensor, hint: Optional[Hint] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable 1-key kv-sort (the join probe's merged sort): radix when the
    key is an integer lane, else ``torch.sort(stable=True)``."""
    res = sort_lane(keys, hint)
    if res is None:
        skey, order = torch.sort(keys, stable=True)
        return skey, pay[order]
    skey, perm = res
    if skey is None:
        skey = keys.index_select(0, perm)
    return skey, pay.index_select(0, perm)
