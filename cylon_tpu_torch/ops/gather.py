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

from typing import List, Optional, Sequence, Tuple

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
