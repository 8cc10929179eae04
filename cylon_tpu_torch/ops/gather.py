"""Packed multi-column row gather (counterpart of cylon_tpu/ops/gather.py).

Every column is re-expressed as int32 lanes plus one lane per validity mask,
so a set of columns moves as one lane-major ``[L, n]`` int32 matrix: one
gather for all of them, and one source for the windowed expand (kernel K2).
The codec is bit-exact. A 4-byte column is one lane by
``Tensor.view(torch.int32)``; an 8-byte column (int64, uint64, float64) is
two lanes the same way, so float64 needs no separate route here (the JAX
package passes it through because a TPU cannot bitcast 64-bit values);
narrower columns widen to one lane.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

KeyCol = Tuple[torch.Tensor, Optional[torch.Tensor]]

#: dtypes stored in one int32 lane by widening (and narrowed back)
_WIDEN = (torch.bool, torch.uint8, torch.int8, torch.int16, torch.uint16)


def lane_plan(cols: Sequence[KeyCol]):
    """(dtype, n_lanes, has_valid) per column."""
    plan = []
    for data, valid in cols:
        n_lanes = 2 if data.element_size() == 8 else 1
        plan.append((data.dtype, n_lanes, valid is not None))
    return plan


def _to_lanes(data: torch.Tensor) -> List[torch.Tensor]:
    dt = data.dtype
    if data.numel() == 0:  # an empty tensor may carry a stride no view accepts
        return [data.new_empty(0, dtype=torch.int32)] * (2 if data.element_size() == 8 else 1)
    if dt in _WIDEN:
        return [data.to(torch.int32)]
    if dt in (torch.float16, torch.bfloat16):
        return [data.view(torch.int16).to(torch.int32)]
    if data.element_size() == 4:
        return [data.contiguous().view(torch.int32)]
    pair = data.contiguous().view(torch.int32).view(-1, 2)
    return [pair[:, 0], pair[:, 1]]


def _from_lanes(lanes: List[torch.Tensor], dt: torch.dtype) -> torch.Tensor:
    if lanes[0].numel() == 0:
        return lanes[0].new_empty(0, dtype=dt)
    if dt in _WIDEN:
        return lanes[0].to(dt)
    if dt in (torch.float16, torch.bfloat16):
        return lanes[0].to(torch.int16).view(dt)
    if len(lanes) == 1:
        return lanes[0].contiguous().view(dt)
    return torch.stack(lanes, 1).contiguous().view(dt).view(-1)


def pack_cols(cols: Sequence[KeyCol]):
    """(plan, int32 lanes) for a column set: data lanes, then the column's
    validity lane when it has one."""
    plan = lane_plan(cols)
    lanes: List[torch.Tensor] = []
    for data, valid in cols:
        lanes.extend(_to_lanes(data))
        if valid is not None:
            lanes.append(valid.to(torch.int32))
    return plan, lanes


def unpack_cols(plan, out_lanes, make_valid):
    """Inverse of :func:`pack_cols`; ``make_valid(lane_or_None)`` shapes
    each output validity. Returns (columns, lanes consumed)."""
    out: List[KeyCol] = []
    pos = 0
    for dt, n_lanes, has_valid in plan:
        data = _from_lanes(list(out_lanes[pos : pos + n_lanes]), dt)
        pos += n_lanes
        if has_valid:
            v = make_valid(out_lanes[pos])
            pos += 1
        else:
            v = make_valid(None)
        out.append((data, v))
    return out, pos


def gather_rows(x: torch.Tensor, idx: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """``x`` indexed along ``dim`` by ``idx`` clamped into range; an empty
    source gives zeros (every such row is masked by its caller)."""
    n = x.shape[dim]
    if n == 0:
        shape = list(x.shape)
        shape[dim] = idx.shape[0]
        return torch.zeros(shape, dtype=x.dtype, device=x.device)
    return x.index_select(dim, idx.clamp(0, n - 1))


def pack_gather(
    cols: Sequence[KeyCol], idx: torch.Tensor, all_valid: bool = False
) -> List[KeyCol]:
    """Gather every column by row index in ONE gather of the packed lane
    matrix.

    An index of -1 means "no source row" (the null side of an outer join):
    the value comes from a clamped index and the row is null.
    ``all_valid=True``: the caller guarantees no -1 index (a permutation),
    so mask-free columns stay mask-free."""
    plan, lanes = pack_cols(cols)
    ok = idx >= 0
    g_cols = list(gather_rows(torch.stack(lanes, 0), idx, dim=1).unbind(0)) if lanes else []

    def make_valid(lane):
        if all_valid:
            return None if lane is None else lane.to(torch.bool)
        return ok if lane is None else (ok & lane.to(torch.bool))

    return unpack_cols(plan, g_cols, make_valid)[0]


# ----------------------------------------------------------------------
# the bit-width-adaptive WIRE codec (ops/stats.py range stats drive it)
#
# The lane codec above ships every value as whole int32 lanes and every
# validity mask as a lane. On the shuffle's exchange that width is pure
# wire cost: a column whose measured range fits 12 bits ships 12 bits
# rebased by a GLOBAL per-column base (both sides of the exchange must
# agree, so the base comes from the host-folded stats of every shard), a
# validity mask 1 bit, a bool 1 bit, a float16 its 16 bits. Only
# bit-lossless encodings narrow (int families, bools, dictionary codes);
# float32 rides as a plain lane, float64 as two passthrough lanes behind
# the packed words, unless the opt-in lossy tier (ops/quant.py) gives a
# float payload column a quantized field (kind 'q'), whose q8 block scales
# ride the exchange's header rows.
# ----------------------------------------------------------------------

class WireField(NamedTuple):
    """One bit-field of the wire layout, in column-major field order.

    ``kind``: 'enc' (stats-rebased orderable encoding), 'lane' (one plain
    32-bit lane of an un-narrowed column), 'valid' (1-bit validity), 'h16'
    (the native 16 bits of a float16/bfloat16), 'q' (a lossy quantized
    field of ops/quant.py). ``off``: a 'lane' field's lane within its
    column. ``cls``: an 'enc' field's encoding class; an 'h16' field's
    dtype; a 'q' field's ``"<codec>:<dtype>"`` (q8/qb16/qf32 and the
    column's dtype, which the decode restores)."""

    col: int
    kind: str
    off: int
    bits: int
    cls: str


class WirePlan(NamedTuple):
    """Static wire-narrowing plan (quantized widths only): ``plan`` is the
    :func:`wire_lane_plan` it narrows."""

    plan: tuple
    fields: Tuple[WireField, ...]
    n_words: int
    n_plain: int


def wire_lane_plan(cols: Sequence[KeyCol]):
    """The JAX package's lane-codec plan of a column set, from dtypes alone:
    (tag or None, n_lanes, has_valid) per column, tag the dtype's name and
    None for float64, which rides outside the packed words."""
    plan = []
    for data, valid in cols:
        dt = data.dtype
        if dt == torch.float64:
            plan.append((None, 0, valid is not None))
        else:
            plan.append((str(dt).replace("torch.", ""), 2 if data.element_size() == 8 else 1,
                         valid is not None))
    return plan


def wire_plan(cols_plan, stats_list, quant=None) -> Optional[WirePlan]:
    """The wire layout of a column set, or None when packing would not
    strictly cut the word count.

    ``stats_list``: per column ``(enc_class, field_bits)`` from measured
    global range stats, or None. Lossless narrow encodings take 'enc'
    fields (bool needs no stats: 1 bit, base 0), float16/bfloat16 'h16'
    fields, everything else its plain 32-bit lanes; float64 stays outside;
    every validity mask takes 1 bit. ``quant``: per-column lossy codecs
    (ops/quant.quant_spec, None entries exact); a quantized column, a
    float64 one too (which so leaves the passthrough), ships a 'q' field
    at its codec's width, and a quantized float64 counts as two plain
    lanes in the engagement compare."""
    from .quant import CODEC_BITS
    from .stats import wire_narrowable

    fields: List[WireField] = []
    n_plain = 0
    for ci, (tag, nl, has_valid) in enumerate(cols_plan):
        qc = quant[ci] if quant is not None else None
        if tag is not None:
            n_plain += nl
            st = stats_list[ci]
            if qc is not None:
                fields.append(WireField(ci, "q", 0, CODEC_BITS[qc], f"{qc}:{tag}"))
            elif tag == "bool":
                fields.append(WireField(ci, "enc", 0, 1, "bool"))
            elif tag in ("float16", "bfloat16"):
                fields.append(WireField(ci, "h16", 0, 16, tag))
            elif st is not None and wire_narrowable(st[0]):
                fields.append(WireField(ci, "enc", 0, int(st[1]), st[0]))
            else:
                for j in range(nl):
                    fields.append(WireField(ci, "lane", j, 32, ""))
        elif qc is not None:
            n_plain += 2
            fields.append(WireField(ci, "q", 0, CODEC_BITS[qc], f"{qc}:float64"))
        if has_valid:
            n_plain += 1
            fields.append(WireField(ci, "valid", 0, 1, ""))
    if not fields:
        return None
    total = sum(f.bits for f in fields)
    n_words = max(-(-total // 32), 1)
    if n_words >= n_plain:
        return None
    return WirePlan(tuple(cols_plan), tuple(fields), n_words, n_plain)


def static_wire_plan(cols: Sequence[KeyCol], quant=None) -> Optional[WirePlan]:
    """The stats-free wire plan: only the static narrowings (bool data and
    validity masks to 1 bit, float16/bfloat16 to 16, and under ``quant``
    the lossy fields, whose block scales ride the headers). The fused
    pipeline takes it: it has no host stats step."""
    from .stats import enabled

    if not enabled():
        return None
    plan = wire_lane_plan(cols)
    return wire_plan(plan, [None] * len(plan), quant=quant)


def wire_row_bytes(wplan: WirePlan) -> int:
    """Bytes one row takes in a wire-narrowed exchange buffer: 4 per packed
    word + 8 per float64 column (two lanes behind the words)."""
    qcols = {f.col for f in wplan.fields if f.kind == "q"}
    total = 4 * wplan.n_words
    total += sum(8 for ci, (tag, _nl, _hv) in enumerate(wplan.plan) if tag is None and ci not in qcols)
    return max(total, 1)


def wire_q8_cols(wplan: Optional[WirePlan]) -> Tuple[Tuple[int, str], ...]:
    """(col, dtype) of every block-scaled 'q8' field in field order: the
    fields whose per-chunk scales ride the exchange header rows."""
    if wplan is None:
        return ()
    return tuple((f.col, f.cls.split(":", 1)[1]) for f in wplan.fields
                 if f.kind == "q" and f.cls.startswith("q8:"))


def wire_has_quant(wplan: Optional[WirePlan]) -> bool:
    """Whether the plan holds a lossy field."""
    return wplan is not None and any(f.kind == "q" for f in wplan.fields)


def wire_pt_order(wplan: WirePlan, pt_order) -> tuple:
    """The passthrough (float64) columns that still ride outside the words."""
    qcols = {f.col for f in wplan.fields if f.kind == "q"}
    return tuple(ci for ci in pt_order if ci not in qcols)


def wire_bases(wplan: WirePlan, stats_by_col: dict) -> np.ndarray:
    """[n_enc, 2] uint32 (hi, lo) base words of the plan's 'enc' fields in
    field order, the same on every rank; bool fields (and absent stats)
    use base 0."""
    rows = []
    for f in wplan.fields:
        if f.kind != "enc":
            continue
        st = stats_by_col.get(f.col)
        lo = 0 if (f.cls == "bool" or st is None) else int(st.lo)
        rows.append(((lo >> 32) & 0xFFFFFFFF, lo & 0xFFFFFFFF))
    return np.asarray(rows, np.uint32).reshape(-1, 2)


def _enc_base(bases: Optional[np.ndarray], ei: int) -> int:
    """Base of 'enc' field ``ei`` as an int64 value (a uint64 base as its
    two's-complement pattern). ``bases=None``: every base is 0."""
    if bases is None:
        return 0
    b = (int(bases[ei, 0]) << 32) | int(bases[ei, 1])
    return b - (1 << 64) if b >= 1 << 63 else b


def wire_pack_cols(cols: Sequence[KeyCol], wplan: WirePlan, bases: Optional[np.ndarray],
                   qscales: Optional[torch.Tensor] = None):
    """Encode every column into the plan's packed words.

    Returns (word lanes, each an int32 [n] tensor, passthrough {col ->
    float64 data}). 'enc' fields clamp to their width: the values fit
    whenever the stats were sound bounds (values under null were measured
    too), so the clamp is a firewall, not a data path. ``qscales``: [n,
    n_q8] float32 per-row block scales of the 'q8' fields in field order
    (each row its destination chunk's, :func:`~cylon_tpu_torch.parallel
    .shuffle.send_row_scales`)."""
    from . import quant as _q
    from .stats import M32, assemble_words, clamp_field, encode_enc, layout_words

    qcols = {f.col for f in wplan.fields if f.kind == "q"}
    field_vals: List[torch.Tensor] = []
    bits_list: List[int] = []
    ei = qi = 0
    for f in wplan.fields:
        data, valid = cols[f.col]
        if f.kind == "enc":
            base = _enc_base(bases, ei)
            ei += 1
            if f.bits == 0:
                v = torch.zeros(data.shape, dtype=torch.int64, device=data.device)
            else:
                v = clamp_field(encode_enc(data, f.cls) - base, f.bits)
        elif f.kind == "h16":
            v = data.contiguous().view(torch.int16).to(torch.int64) & 0xFFFF
        elif f.kind == "lane":
            v = _to_lanes(data)[f.off].to(torch.int64) & M32
        elif f.kind == "valid":
            v = valid.to(torch.int64)
        else:  # 'q'
            codec = f.cls.split(":", 1)[0]
            scale = None
            if codec == "q8":
                scale = qscales[:, qi]
                qi += 1
            v = _q.encode_field(codec, data, scale)
        field_vals.append(v)
        bits_list.append(f.bits)
    passthrough = {ci: cols[ci][0] for ci, (tag, _nl, _hv) in enumerate(wplan.plan)
                   if tag is None and ci not in qcols}
    return assemble_words(field_vals, layout_words(bits_list, False), bits_list), passthrough


def wire_unpack_cols(word_lanes, wplan: WirePlan, bases: Optional[np.ndarray],
                     handle_passthrough, make_valid, qscales: Optional[torch.Tensor] = None):
    """Decode :func:`wire_pack_cols` words back into columns: the wire
    counterpart of :func:`unpack_cols` (``handle_passthrough(ci)`` gives a
    float64 column, ``make_valid(lane_or_None)`` shapes each validity).
    ``qscales``: [rows, n_q8] float32 per-row scales of the 'q8' fields,
    each row its source chunk's."""
    from . import quant as _q
    from .stats import decode_enc, extract_fields, layout_words

    bits_list = [f.bits for f in wplan.fields]
    vals = extract_fields(list(word_lanes), layout_words(bits_list, False), bits_list)
    per_col: dict = {}
    ei = qi = 0
    for f, v in zip(wplan.fields, vals):
        slot = -1
        if f.kind == "enc":
            slot = ei
            ei += 1
        elif f.kind == "q" and f.cls.startswith("q8:"):
            slot = qi
            qi += 1
        per_col.setdefault(f.col, []).append((f, v, slot))
    out: List[KeyCol] = []
    for ci, (tag, _nl, has_valid) in enumerate(wplan.plan):
        data = vlane = None
        frags: List[torch.Tensor] = []
        for f, v, slot in per_col.get(ci, []):
            if f.kind == "enc":
                data = decode_enc(v + _enc_base(bases, slot), f.cls, getattr(torch, tag))
            elif f.kind == "h16":
                data = torch.where(v >= 2**15, v - 2**16, v).to(torch.int16).view(getattr(torch, f.cls))
            elif f.kind == "q":
                codec, out_dt = f.cls.split(":", 1)
                scale = qscales[:, slot] if codec == "q8" else None
                data = _q.decode_field(codec, v, scale, getattr(torch, out_dt))
            elif f.kind == "lane":
                frags.append(torch.where(v >= 2**31, v - 2**32, v).to(torch.int32))
            else:
                vlane = v.to(torch.int32)
        if data is None and tag is None:
            data = handle_passthrough(ci)
        elif data is None:
            data = _from_lanes(frags, getattr(torch, tag))
        out.append((data, make_valid(vlane) if has_valid else make_valid(None)))
    return out
