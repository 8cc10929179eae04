"""Column range statistics and the bit-layout engine behind lane packing
(counterpart of cylon_tpu/ops/stats.py).

A 12-bit dictionary code, an int key spanning 0..50k and a 1-bit validity
mask each take a whole 32-bit word in every sort lane and every exchange
row. This module lets two consumers narrow them:

* :func:`enc_class` / :func:`encode_enc` / :func:`decode_enc`: the one
  monotone-encoding classifier and codec shared by the sort-word fusion
  planner (ops/sort.py), the wire codec (ops/gather.py) and the semi-join
  range gate (ops/sketch.py). The value encoding is
  :func:`cylon_tpu_torch.ops.sort.orderable_key`.
* :class:`ColStat`: per-column [lo, hi] bounds of the orderable encoding
  over the rows (values under null included: they ride sort lanes and wire
  fields too). Carried on ``Table`` like the order descriptor: measured by
  the shuffle's count phase (the bounds ride its one host fetch) and by
  ``Table.ensure_stats`` on demand; carried by row subsets, renames and
  permutations (bounds stay sound); cleared by an in-place change.
* :func:`layout_words` / :func:`assemble_words` / :func:`extract_fields`:
  a most-significant-first list of field widths sliced into the fewest
  uint32/uint64 words, so that word-lexicographic order is
  field-lexicographic order (a field may straddle two words).

Tensors: an encoding or a field value is an int64 tensor holding the
unsigned value (a 64-bit one as its two's-complement bit pattern); an
assembled 32-bit word is an int32 tensor holding the uint32 pattern (the
radix engine's digit lane, ops/radix.py), a 64-bit word an int64 tensor.

``CYLON_TPU_TORCH_NO_LANE_PACK=1`` turns every consumer off (sort-word
fusion, canonical-lane fusion, wire narrowing, stats measurement);
``disabled()`` is the differential oracle of the tests.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.envgate import env_gate
from .sort import KeyCol, orderable_key

# the CYLON_TPU_TORCH_NO_LANE_PACK=1 kill switch (utils/envgate.py)
enabled, disabled = env_gate(
    "CYLON_TPU_TORCH_NO_LANE_PACK",
    keyed_via="the plan fingerprint carries the gate (plan/lazy.py); fuse and "
    "wire plans are decided per call from it",
)

M32 = 0xFFFFFFFF
_I64_MIN = -(2**63)

def enc_class(dtype: torch.dtype) -> Optional[str]:
    """Monotone orderable-encoding family of a physical dtype, or None where
    the dtype has no packable unsigned lane:

    - ``bool``/``u32``/``i32``: 32-bit-or-narrower ints and bools (the lane
      is a bijective uint32; dictionary codes qualify as int32);
    - ``i64``/``u64``: 64-bit ints (bijective uint64);
    - ``f32``: every sub-64-bit float: monotone uint32, exact for order but
      not bit-lossless (-0.0 and NaN payloads canonicalize), so the wire
      codec must not use it (:func:`wire_narrowable`);
    - None: float64 (its orderable lane is a float), anything else."""
    if dtype == torch.bool:
        return "bool"
    if dtype == torch.float64:
        return None
    if dtype.is_floating_point:
        return "f32"
    if dtype.is_complex:
        return None
    kind = "i" if dtype.is_signed else "u"
    return kind + ("32" if dtype.itemsize <= 4 else "64")


def wire_narrowable(cls: Optional[str]) -> bool:
    """Classes whose encoding is bit-lossless, so the wire codec may use it
    (floats are order-exact but canonicalize -0.0/NaN)."""
    return cls in ("bool", "u32", "i32", "i64", "u64")


def encode_enc(data: torch.Tensor, cls: str) -> torch.Tensor:
    """The orderable encoding of a classified column as an int64 tensor: the
    uint32 value for 32-bit classes, the uint64 bit pattern for 64-bit
    ones (``orderable_key``'s lane, widened)."""
    enc = orderable_key(data)
    if enc.dtype == torch.int64:
        return enc
    if enc.dtype != torch.int32:
        raise TypeError(f"class {cls!r}: no unsigned encoding for {data.dtype}")
    return enc.to(torch.int64) & M32


def decode_enc(enc: torch.Tensor, cls: str, dtype: torch.dtype) -> torch.Tensor:
    """Exact inverse of :func:`encode_enc` for the wire-narrowable classes."""
    if cls == "bool":
        return enc != 0
    if cls == "u32":
        return (enc & M32).to(dtype)
    if cls == "i32":
        return ((enc & M32) - 2**31).to(dtype)
    if cls == "u64":
        return enc.view(torch.uint64)
    if cls == "i64":
        return (enc ^ _I64_MIN).to(dtype)
    raise ValueError(f"class {cls!r} has no lossless decode")


class ColStat(NamedTuple):
    """[lo, hi] bounds of one column's orderable encoding over its rows
    (values under null included), as Python ints of the uint64-widened
    encoding. Any wider range stays sound, so row subsets carry it."""

    lo: int
    hi: int
    cls: str

    def merge(self, other: "ColStat") -> Optional["ColStat"]:
        if other is None or other.cls != self.cls:
            return None
        return ColStat(min(self.lo, other.lo), max(self.hi, other.hi), self.cls)


def field_bits(stat: ColStat) -> int:
    """Quantized field width of a stat's span: exact for 0-2 bits, else
    rounded up to a multiple of 4 (cap 64)."""
    b = int(stat.hi - stat.lo).bit_length()
    if b <= 2:
        return b
    return min(64, -(-b // 4) * 4)


# ----------------------------------------------------------------------
# unsigned helpers over int64 tensors
# ----------------------------------------------------------------------

def mask_of(bits: int) -> int:
    """Width mask of a ``bits``-wide field as an int64 value (-1 at 64)."""
    return -1 if bits >= 64 else (1 << bits) - 1


def lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns."""
    if s <= 0:
        return x
    return (x >> s) & ((1 << (64 - s)) - 1)


def umin(x: torch.Tensor) -> torch.Tensor:
    """Unsigned minimum of int64 bit patterns (a 0-d tensor)."""
    return (x ^ _I64_MIN).min() ^ _I64_MIN


def umax(x: torch.Tensor) -> torch.Tensor:
    """Unsigned maximum of int64 bit patterns (a 0-d tensor)."""
    return (x ^ _I64_MIN).max() ^ _I64_MIN


def clamp_field(v: torch.Tensor, bits: int) -> torch.Tensor:
    """``v`` held inside a ``bits``-wide field (int64 bit patterns). Values
    from sound stats already fit and pass unchanged; anything else lands
    inside the field (the JAX package's unsigned ``min(v, mask)`` sends a
    wrapped value to the mask, this to 0), so a bad value never spills into
    a neighbouring field."""
    if bits >= 64:
        return v
    return v.clamp(0, (1 << bits) - 1)


def to_u32_lane(w: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) as int32 tensors holding the uint32."""
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


# ----------------------------------------------------------------------
# stat measurement (device side) and the host fold
# ----------------------------------------------------------------------

def stat_words(col: KeyCol) -> torch.Tensor:
    """int64 [4] per-shard stat vector of one statable column: [min_hi,
    min_lo, max_hi, max_lo] uint32 words of the uint64-widened encoding
    bounds over the shard's rows. An empty shard reports the inverted
    window (min = MAX, max = 0), which the host fold reads as "no rows"."""
    data, _valid = col
    enc = orderable_key(data)
    dev = data.device
    if enc.shape[0] == 0:
        wide = enc.dtype == torch.int64
        return torch.tensor([M32 if wide else 0, M32, 0, 0], dtype=torch.int64, device=dev)
    if enc.dtype == torch.int64:
        lo, hi = umin(enc), umax(enc)
        return torch.stack([lsr(lo, 32), lo & M32, lsr(hi, 32), hi & M32])
    e = enc.to(torch.int64) & M32
    z = torch.zeros((), dtype=torch.int64, device=dev)
    return torch.stack([z, e.min(), z, e.max()])


def fold_stat_words(per_shard: np.ndarray, cls: str) -> ColStat:
    """Fold [P, 4] per-shard stat words into one global :class:`ColStat`.
    A globally empty column folds to the degenerate (0, 0) stat."""
    w = (np.asarray(per_shard).astype(np.int64) & M32).astype(np.uint64)
    lo = int((w[:, 0] << np.uint64(32) | w[:, 1]).min())
    hi = int((w[:, 2] << np.uint64(32) | w[:, 3]).max())
    if lo > hi:  # inverted window: every shard was empty
        return ColStat(0, 0, cls)
    return ColStat(lo, hi, cls)


# ----------------------------------------------------------------------
# the shared bit-layout engine
# ----------------------------------------------------------------------

# a word layout: [(width_bits, [(field_idx, frag_lo, frag_bits, shift)])],
# most-significant word first; frag_lo is the fragment's offset inside the
# FIELD, shift its offset inside the WORD
WordLayout = List[Tuple[int, List[Tuple[int, int, int, int]]]]


def layout_words(bits_list: Sequence[int], allow64: bool) -> WordLayout:
    """Slice a most-significant-first list of field widths into the fewest
    words (uint64 where ``allow64`` and more than 32 bits remain, else
    uint32). A field may straddle two words: its (hi, lo) fragments compare
    like the whole number. Unused bits sit at the bottom of the last word.
    Zero-width fields take no bits; all zero widths give one zero word."""
    total = sum(bits_list)
    if total == 0:
        return [(32, [])]
    widths: List[int] = []
    remaining = total
    while remaining > 0:
        w = 64 if (allow64 and remaining > 32) else 32
        widths.append(w)
        remaining -= w
    padded = sum(widths)
    fpos = []
    top = padded
    for b in bits_list:
        fpos.append((top - b, top))
        top -= b
    layout: WordLayout = []
    wtop = padded
    for w in widths:
        wlo = wtop - w
        frags = []
        for fi, (flo, fhi) in enumerate(fpos):
            take_lo = max(flo, wlo)
            take_hi = min(fhi, wtop)
            if take_hi <= take_lo:
                continue
            frags.append((fi, take_lo - flo, take_hi - take_lo, take_lo - wlo))
        layout.append((w, frags))
        wtop = wlo
    return layout


def assemble_words(
    fields: Sequence[Optional[torch.Tensor]], layout: WordLayout,
    bits_list: Optional[Sequence[int]] = None,
) -> List[torch.Tensor]:
    """Pack per-row field values (int64, already within their widths; None
    for a constant-zero field) into words per ``layout``, most significant
    first: int32 tensors holding the uint32 words, int64 tensors for 64-bit
    words. With ``bits_list`` (the field widths) a field's top fragment
    skips its mask, which a value within its width does not need."""
    ref = next(f for f in fields if f is not None)
    out = []
    for width, frags in layout:
        acc = None
        for fi, frag_lo, frag_bits, shift in frags:
            f = fields[fi]
            if f is None:
                continue
            f = lsr(f, frag_lo)
            if bits_list is None or frag_lo + frag_bits != bits_list[fi]:
                f = f & mask_of(frag_bits)
            if shift:
                f = f << shift
            acc = f if acc is None else acc.bitwise_or_(f)
        if acc is None:
            acc = torch.zeros(ref.shape, dtype=torch.int64, device=ref.device)
        out.append(acc if width == 64 else to_u32_lane(acc))
    return out


def extract_fields(
    words: Sequence[torch.Tensor], layout: WordLayout, bits_list: Sequence[int]
) -> List[torch.Tensor]:
    """Inverse of :func:`assemble_words`: per-field int64 values."""
    fields: List[Optional[torch.Tensor]] = [None] * len(bits_list)
    for (width, frags), word in zip(layout, words):
        w = word if width == 64 else word.to(torch.int64) & M32
        for fi, frag_lo, frag_bits, shift in frags:
            v = lsr(w, shift) & mask_of(frag_bits)
            if frag_lo:
                v = v << frag_lo
            prev = fields[fi]
            fields[fi] = v if prev is None else (prev | v)
    return [
        f if f is not None else torch.zeros(words[0].shape, dtype=torch.int64, device=words[0].device)
        for f in fields
    ]
