"""Multi-column ordering primitives (counterpart of cylon_tpu/ops/sort.py).

Tables hold exact-length tensors, so there are no padding rows: where the
JAX package adds a "row class" lane to push padding last, the port's lanes
only order live values and nulls. Every integer ordering goes through the
radix engine (ops/radix.py, kernel K1); a lexsort with a float lane
declines to chained ``torch.sort(stable=True)`` passes, as the JAX package
declines to chained ``lax.sort`` passes.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from . import radix as _radix

KeyCol = Tuple[torch.Tensor, Optional[torch.Tensor]]  # (data, valid-or-None)

_I32_MIN = -(2**31)
_I64_MIN = -(2**63)


def wide_float() -> torch.dtype:
    return torch.float64


def wide_int() -> torch.dtype:
    return torch.int64


def orderable_key(data: torch.Tensor) -> torch.Tensor:
    """Map a numeric column to its canonical sort/equality lane.

    Everything but float64 becomes an unsigned bit pattern whose unsigned
    order is value order, held in int32 (uint32 patterns) or int64 (uint64
    patterns): f32 in total order (-inf < ... < -0 == +0 < ... < +inf < NaN,
    all NaNs equal), signed ints with the sign bit flipped. float64 keeps a
    canonical float lane (-0 -> +0), as in the JAX package, and a sort over
    it declines the radix engine. Equality of lanes is equality of keys."""
    dt = data.dtype
    if dt == torch.bool:
        return data.to(torch.int32)
    if dt.is_floating_point:
        if dt in (torch.float16, torch.bfloat16):
            data = data.to(torch.float32)
            dt = torch.float32
        data = torch.where(data == 0, torch.zeros_like(data), data)
        if dt == torch.float64:
            return data
        b = data.view(torch.int32)
        b = torch.where(torch.isnan(data), torch.full_like(b, 0x7FC00000), b)
        return torch.where(b >= 0, b | _I32_MIN, ~b)
    if dt in (torch.uint8, torch.uint16):
        return data.to(torch.int32)
    if dt == torch.uint32:
        return data.view(torch.int32)
    if dt == torch.uint64:
        return data.view(torch.int64)
    if data.element_size() <= 4:
        return data.to(torch.int32) ^ _I32_MIN
    return data ^ _I64_MIN


def lanes_differ(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise lane inequality; NaN == NaN on float (f64) lanes."""
    d = a != b
    if a.dtype.is_floating_point:
        d = d & ~(torch.isnan(a) & torch.isnan(b))
    return d


def _norm_key(data: torch.Tensor, ascending: bool) -> torch.Tensor:
    lane = orderable_key(data)
    if not ascending:
        if lane.dtype.is_floating_point:
            lane = -lane  # NaNs stay last: torch.sort puts NaN greatest
        else:
            lane = ~lane
            if data.dtype.is_floating_point:
                lane = torch.where(torch.isnan(data), torch.full_like(lane, -1), lane)
    return lane


def row_class(valid: Optional[torch.Tensor], n: int, device, nulls_last: bool = True):
    """Most-significant sort lane: 0 = live value, 1 = null (-1 with nulls
    first). Without padding rows there is no padding class."""
    if valid is None:
        return torch.zeros(n, dtype=torch.int8, device=device)
    null = (~valid).to(torch.int8)
    return null if nulls_last else -null


def _sortable(lane: torch.Tensor) -> torch.Tensor:
    """A lane in a dtype whose SIGNED order is the lane's order, for the
    ``torch.sort`` decline route: uint32 patterns widen to int64, uint64
    patterns flip their top bit back."""
    if lane.dtype.is_floating_point:
        return lane
    if lane.dtype == torch.int32:
        return lane.to(torch.int64) & 0xFFFFFFFF
    if lane.dtype == torch.int64:
        return lane ^ _I64_MIN
    return lane.to(torch.int64)


def _chained_sort_indices(lanes: Sequence[torch.Tensor], n: int, device) -> torch.Tensor:
    """Stable lexsort by chained stable 1-key ``torch.sort`` passes, least
    significant lane first (the JAX package's lexsort_with_payload)."""
    order = torch.arange(n, dtype=torch.int64, device=device)
    for lane in lanes:
        _, o = torch.sort(_sortable(lane)[order], stable=True)
        order = order[o]
    return order.to(torch.int32)


def lexsort_indices(lanes: Sequence[torch.Tensor], n: int, hints=None) -> torch.Tensor:
    """Permutation (int32) that stably lexsorts ``lanes`` (least-significant
    first): radix passes when every lane has an integer digit plan, else the
    chained stable sorts — the same unique permutation either way."""
    perm = _radix.lexsort_perm(lanes, n, hints)
    if perm is not None:
        return perm
    device = lanes[0].device if lanes else torch.device("cpu")
    return _chained_sort_indices(lanes, n, device)


# ---------------------------------------------------------------------------
# run (equal-key segment) scans over a sorted order. ``new_run[0]`` is True
# at every call site. The JAX package broadcasts a run's first value with a
# cummax; torch's CUDA cummax scans a 1-D tensor in one thread block, so here
# each run's first value is scattered to its run id and gathered back.
# ---------------------------------------------------------------------------
def run_start_broadcast(new_run: torch.Tensor, prefix: torch.Tensor) -> torch.Tensor:
    """Broadcast each run's first ``prefix`` value over the run."""
    rid = torch.cumsum(new_run, 0) - 1
    n = new_run.shape[0]
    dest = torch.where(new_run, rid, torch.arange(n, n + n, device=rid.device))
    first = torch.empty(2 * n, dtype=prefix.dtype, device=prefix.device)
    first.scatter_(0, dest, prefix)
    return first.index_select(0, rid.clamp(min=0))


def run_count_upto(new_run: torch.Tensor, flag: torch.Tensor) -> torch.Tensor:
    """How many ``flag`` positions MY run has at/before me."""
    f = flag.to(torch.int64)
    excl = torch.cumsum(f, 0) - f
    return excl + f - run_start_broadcast(new_run, excl)


def run_count_from(new_run: torch.Tensor, flag: torch.Tensor) -> torch.Tensor:
    """How many ``flag`` positions MY run has at/after me (at a run start:
    the run's total): :func:`run_count_upto` on the flipped arrays, where a
    run's end is its start."""
    if new_run.shape[0] == 0:
        return torch.zeros(0, dtype=torch.int64, device=new_run.device)
    run_end = torch.cat([new_run[1:], new_run.new_ones(1)])
    return torch.flip(run_count_upto(torch.flip(run_end, (0,)), torch.flip(flag, (0,))), (0,))


def canonical_row_lanes(cols: Sequence[KeyCol], fuse: Optional["FusePlan"] = None) -> list:
    """Canonical key lanes for one combined row ordering, most significant
    first: per column (null lane, value lane). Value lanes are zeroed under
    null so a run of nulls is ONE run (null == null). The JAX package's
    leading padding-class lane is constant here (no padding rows) and is
    left out.

    ``fuse``: a stats-driven :class:`FusePlan` (pad_bits=1) bit-packs the
    whole lane stack into fewer words; the sorted order and the run
    boundaries are the same by construction, so factorize ids are too."""
    if fuse is not None:
        return fused_key_words(fuse, cols, nulls_last=True, zero_null_values=True)
    lanes: list = []
    for data, valid in cols:
        vlane = orderable_key(data)
        if valid is not None:
            lanes.append((~valid).to(torch.uint8))  # one 8-bit pass
            vlane = torch.where(valid, vlane, torch.zeros_like(vlane))
        lanes.append(vlane)
    return lanes


def lane_runs_differ(sorted_lanes: Sequence[torch.Tensor]) -> torch.Tensor:
    """Row-differs-from-predecessor over SORTED canonical lanes (row 0 True)."""
    n = sorted_lanes[0].shape[0]
    diff = torch.zeros(n, dtype=torch.bool, device=sorted_lanes[0].device)
    for lane in sorted_lanes:
        diff[1:] |= lanes_differ(lane[1:], lane[:-1])
    if n:
        diff[0] = True
    return diff


def sorted_runs(
    lanes_msb_first: Sequence[torch.Tensor], fuse: Optional["FusePlan"] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable row ordering + run boundaries over canonical lanes: (order
    [n] int32 original row indices in sorted order, new_run [n] bool).
    ``fuse``: the lanes are that plan's fused words (their digit spans)."""
    lanes = list(lanes_msb_first)
    n = lanes[0].shape[0]
    hints = None if fuse is None else _radix.fuse_word_hints(fuse)
    order = lexsort_indices(list(reversed(lanes)), n, hints)
    return order, lane_runs_differ([lane.index_select(0, order) for lane in lanes])


def sentinel_compact(order: torch.Tensor, payloads: Sequence[torch.Tensor]) -> list:
    """Stable 1-key sort of ``payloads`` by ``order``, a permutation of
    ``[0, n)``: row r lands at ``order[r]``, one scatter per payload. The
    JAX package sorts by a key whose dropped rows hold a sentinel past the
    kept ones; here every call site keys by a whole permutation and slices
    the kept range off the result."""
    dest = order.to(torch.int64)
    return [torch.empty_like(p).scatter_(0, dest, p) for p in payloads]


def rows_differ(key_cols: Sequence[KeyCol]) -> torch.Tensor:
    """Row-differs-from-predecessor over key columns in row order (row 0
    True): a key's orderable lane differs, or one of the two rows is null
    and the other not (null == null)."""
    n = key_cols[0][0].shape[0]
    device = key_cols[0][0].device
    diff = torch.zeros(n, dtype=torch.bool, device=device)
    for data, valid in key_cols:
        lane = orderable_key(data)
        d = lanes_differ(lane[1:], lane[:-1])
        if valid is not None:
            v, vprev = valid[1:], valid[:-1]
            d = torch.where(v & vprev, d, v != vprev)
        diff[1:] |= d
    if n:
        diff[0] = True
    return diff


def prefix_run_lane(key_cols: Sequence[KeyCol]) -> torch.Tensor:
    """Run ids (int32, from 0) of rows ALREADY sorted by mask-free key
    columns: one lane that orders the rows as those keys do (the JAX
    package's ``prefix_run_lane``)."""
    return torch.cumsum(rows_differ(key_cols).to(torch.int32), 0, dtype=torch.int32) - 1


def lexsort_rows_payload(
    key_cols: Sequence[KeyCol],
    n: int,
    payloads: Sequence[torch.Tensor] = (),
    ascending: Optional[Sequence[bool]] = None,
    nulls_last: bool = True,
    prefix_lane: Optional[torch.Tensor] = None,
    fuse: Optional["FusePlan"] = None,
) -> Tuple[torch.Tensor, list]:
    """Stable argsort of rows by several key columns, nulls per column
    first or last; returns (order [n] int32, payloads gathered by it).
    ``prefix_lane`` (a :func:`prefix_run_lane`) is the most significant
    key, ahead of ``key_cols``.

    ``fuse``: a stats-driven :class:`FusePlan` over exactly (pad_bits=2,
    prefix, key_cols in order): the lane stack bit-packs into
    ``fuse.n_words`` words, each one K1 lane sort over its live bits. The
    permutation is the same (null rows still order by their masked value,
    which the stats measured too)."""
    if ascending is None:
        ascending = [True] * len(key_cols)
    device = key_cols[0][0].device if key_cols else torch.device("cpu")
    if fuse is not None:
        words = fused_key_words(fuse, list(key_cols), nulls_last=nulls_last,
                                prefix_lane=prefix_lane)
        perm = lexsort_indices(list(reversed(words)), n, _radix.fuse_word_hints(fuse))
        return perm, [p.index_select(0, perm) for p in payloads]
    lanes, hints = [], []  # least-significant first
    for (data, valid), asc in zip(reversed(list(key_cols)), reversed(list(ascending))):
        lanes.append(_norm_key(data, asc))
        hints.append(None)
        if valid is not None:
            lanes.append(row_class(valid, n, data.device, nulls_last))
            hints.append(_radix.bias_hint(1, 2))  # {-1, 0, 1}
    if prefix_lane is not None:
        lanes.append(prefix_lane)
        hints.append(_radix.bound_hint(n))
    if not lanes:
        perm = torch.arange(n, dtype=torch.int32, device=device)
    else:
        perm = lexsort_indices(lanes, n, hints)
    return perm, [p.index_select(0, perm) for p in payloads]


# ---------------------------------------------------------------------------
# bit-width-adaptive sort-word fusion (ops/stats.py range stats drive it)
#
# Each chained K1 lane sort streams one lane; a 12-bit dictionary code, a
# 16-bit int key and a 1-bit null flag each take a whole word. The planner
# bit-packs narrow orderable_key lanes, rebased by their per-shard minimum
# (the stats fix only the field widths), into the fewest words. Order is
# kept by construction: the encodings are monotone, a uniform rebase keeps
# order, and msb-first fields make word order equal lane order.
# ---------------------------------------------------------------------------

class FusePlan(NamedTuple):
    """Sort-word fusion plan (quantized widths only, never raw bounds).

    ``fields``: msb-first ``(kind, key_pos, bits, ascending)`` with kind in
    {'pad', 'prefix', 'null', 'value'}; the 'pad' field is the JAX
    package's padding class, constant zero here (no padding rows), kept so
    that plans and their gate agree with it. ``allow64``: the layout is one
    uint64 word (only when the whole plan fits one). ``n_words`` /
    ``n_plain``: fused vs unfused lane counts (fusion engages only when
    strictly fewer)."""

    fields: Tuple[Tuple[str, int, int, bool], ...]
    allow64: bool
    n_words: int
    n_plain: int


def plan_lane_fusion(
    key_specs: Sequence[Optional[Tuple[str, int, bool, bool]]],
    pad_bits: int,
    prefix_bits: int,
    allow64: bool,
) -> Optional[FusePlan]:
    """A :class:`FusePlan` for key columns with measured range stats.

    ``key_specs``: per key ``(enc_class, field_bits, has_valid, ascending)``
    or None where the key has no usable stats. ``pad_bits``: 2 for the
    lexsort row class, 1 for the canonical live flag; ``prefix_bits``: the
    run-id prefix lane's width (0: none). None when a key is unplannable, a
    float key sorts descending (NaN stays last in both directions, which a
    rebased descending float field cannot give), or fusion would not
    strictly cut the pass count."""
    from .stats import layout_words

    if any(s is None for s in key_specs) or not key_specs:
        return None
    fields: list = [("pad", -1, pad_bits, True)]
    if prefix_bits:
        fields.append(("prefix", -1, prefix_bits, True))
    n_plain = 1 + (1 if prefix_bits else 0)
    for pos, (cls, bits, has_valid, asc) in enumerate(key_specs):
        if cls == "f32" and not asc:
            return None
        if bits > 32 and not allow64:
            return None
        if has_valid:
            fields.append(("null", pos, 1, True))
            n_plain += 1
        fields.append(("value", pos, bits, bool(asc)))
        n_plain += 1
    bits_list = [b for _k, _p, b, _a in fields]
    # a 64-bit word only as the single sort word (the JAX package's rule)
    layout = layout_words(bits_list, allow64)
    use64 = allow64 and len(layout) == 1
    if not use64:
        layout = layout_words(bits_list, False)
    n_words = len(layout)
    if n_words >= n_plain:
        return None
    return FusePlan(tuple(fields), use64, n_words, n_plain)


def fused_key_words(
    plan: FusePlan,
    key_cols: Sequence[KeyCol],
    nulls_last: bool = True,
    prefix_lane: Optional[torch.Tensor] = None,
    zero_null_values: bool = False,
) -> list:
    """The fused sort words of one plan, most significant first (int32
    uint32 words, or one int64 uint64 word).

    A value field is the key's orderable encoding rebased by its minimum
    over the shard (its maximum minus it, descending) and clamped to the
    field width. ``zero_null_values`` gives canonical_row_lanes' zeroed
    value under null (null == null runs); without it null rows order by
    their masked value, as the lexsort does."""
    from .stats import M32, assemble_words, clamp_field, layout_words, umax, umin

    n = key_cols[0][0].shape[0]
    fields, bits_list = [], []
    for kind, pos, bits, asc in plan.fields:
        v = None  # a constant-zero field: the pad class (no padding rows here)
        if kind == "prefix":
            v = prefix_lane.to(torch.int64).clamp(0, (1 << bits) - 1)
        elif kind == "null":
            valid = key_cols[pos][1]
            v = (~valid if nulls_last else valid).to(torch.int64)
        elif kind == "value":
            data, valid = key_cols[pos]
            if bits and n:
                enc = orderable_key(data)
                if enc.dtype == torch.int32:  # uint32 patterns: widen, then plain min/max
                    enc = enc.to(torch.int64) & M32
                    v = enc - enc.min() if asc else enc.max() - enc
                else:  # uint64 patterns
                    v = enc - umin(enc) if asc else umax(enc) - enc
                v = clamp_field(v, bits)
            if v is not None and zero_null_values and valid is not None:
                v = v.masked_fill(~valid, 0)
        fields.append(v)
        bits_list.append(bits)
    if all(f is None for f in fields):
        fields[0] = torch.zeros(n, dtype=torch.int64, device=key_cols[0][0].device)
    return assemble_words(fields, layout_words(bits_list, plan.allow64), bits_list)
