"""Semi-join key sketches: blocked-Bloom and min/max range filters that
prune shuffle rows before the all-to-all (counterpart of
cylon_tpu/ops/sketch.py).

The reference ships every row of both join sides through its all-to-all
and lets the local join drop the rows without a partner. Here each side
summarizes its join keys in a small sketch, the sketches are exchanged
once, and every row provably absent from the OTHER side's sketch is left
out of the exchange. A false positive ships an extra row; it never changes
the answer.

* The Bloom filter is blocked at uint32 granularity: a key hashes to one
  word of the ``[W]`` sketch and to ``PROBE_BITS`` bits inside it, so the
  probe is one gather and a bitwise test per row. Word and bits come from
  the murmur3 of ops/hash.py under two fixed seeds, bit for bit the JAX
  package's, so the combined sketch equals its sketch word for word.
* torch has no scatter-OR: the build sets one byte per bit of a bit array
  (a scatter of ``True``, duplicates harmless) and packs 32 of them into a
  word.
* The cross-shard combine is one all_gather of every shard's packed words
  (``comm.all_gather``; NCCL has no bitwise-OR reduction either), then an
  OR over the Bloom words and max/min over the two range words on each
  rank. The range words prune by key range even where the Bloom
  saturates, for a first key whose orderable lane is a monotone uint32
  (dictionary codes qualify).
* Nulls: joins and set ops treat null == null, so nulls are sketched as
  values (a null key hashes as hash_columns' zero contribution and
  range-encodes as the nulls-last sentinel on both sides): a null row is
  pruned only where the other side holds no null.

A sketch here is an int32 tensor holding uint32 words, ``[sketch_len]``
for one side, ``[S, sketch_len]`` for the S sides of a pair.
``CYLON_TPU_TORCH_NO_SEMI_FILTER=1`` turns every consumer off; the gate
in ``table._shuffle_many`` also skips a filter whose measured selectivity
does not pay.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..utils.envgate import env_gate
from .hash import M32, hash_columns
from .sort import KeyCol, orderable_key
from .stats import enc_class, lsr, to_u32_lane

# independent hash streams for (word index, in-word bits), apart from the
# shuffle's partition hash (seed 0)
_SEED_WORD = 0x5EEDB10C
_SEED_BITS = 0x5EEDB175

# bits set per key inside its block word
PROBE_BITS = 4
# target bits per build-side key before the sketch-bit cap
BITS_PER_KEY = 4
# uint32 words after the W Bloom words: [max_enc, min_enc]
RANGE_WORDS = 2

_NULL_ENC = M32  # nulls-last sentinel of the range lane

# the CYLON_TPU_TORCH_NO_SEMI_FILTER=1 kill switch (utils/envgate.py)
enabled, disabled = env_gate(
    "CYLON_TPU_TORCH_NO_SEMI_FILTER",
    keyed_via="the plan fingerprint carries the gate (plan/lazy.py); each "
    "shuffle pair reads it when it decides to build sketches",
)


def join_filter_sides(how: str) -> Optional[str]:
    """Which sides of a join's shuffle may be semi-filtered ('a' = the left
    table against the right sketch, 'b' = the right against the left):
    inner both, left only b, right only a, outer none (every row emits)."""
    return {"inner": "both", "left": "b", "right": "a"}.get(how)


def setop_filter_sides(op: str) -> Optional[str]:
    """Intersect filters both sides; subtract only the right (unmatched
    left rows emit); union none."""
    return {"intersect": "both", "subtract": "b"}.get(op)


def sketch_bits_for(build_rows: int, max_bits: int) -> int:
    """Bloom size in bits, always a power of two: BITS_PER_KEY a key
    (from 4096), capped by ``max_bits`` rounded down to a power of two
    (floor 32, one word)."""
    cap = 32
    while 2 * cap <= int(max_bits):
        cap *= 2
    want = BITS_PER_KEY * max(int(build_rows), 1)
    bits = min(4096, cap)
    while bits < want and bits < cap:
        bits *= 2
    return min(bits, cap)


def sketch_len(bits: int) -> int:
    """uint32 words of one packed sketch: Bloom words + range words."""
    return bits // 32 + RANGE_WORDS


def hash_class(dtype) -> Optional[str]:
    """Equality-consistent hashing family of a key dtype: ints of every
    width (and bools) share one, the hash words being width-independent;
    so do floats. A pair whose classes differ may compare equal in the
    local op yet hash apart, so its filter is off."""
    if dtype.is_floating_point:
        return "float"
    return None if dtype.is_complex else "int"


def range_class(dtype) -> Optional[str]:
    """Monotone-uint32 encoding family of the range words, or None (float64
    has none). Both sides must share the exact class; the 64-bit families
    are named ``...hi`` because the range lane keeps their high word."""
    cls = enc_class(dtype)
    if cls in ("i64", "u64"):
        return cls + "hi"
    return cls


def _range_enc(key: KeyCol) -> torch.Tensor:
    """Monotone uint32 (in int64) of the first key column; 64-bit keys keep
    their orderable high word (a non-strict monotone map, so pruning stays
    sound); nulls take the nulls-last sentinel."""
    data, valid = key
    enc = orderable_key(data)
    enc = lsr(enc, 32) if enc.dtype == torch.int64 else enc.to(torch.int64) & M32
    if valid is not None:
        enc = torch.where(valid, enc, torch.full_like(enc, _NULL_ENC))
    return enc


def key_hashes(cols: Sequence[KeyCol]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two murmur3 streams of the key rows (word index, in-word bits).
    A table both built into a sketch and probed against the other side's
    hashes its keys once (``hashes=`` of :func:`build_local`, :func:`probe`)."""
    h = hash_columns(cols, seed=(_SEED_WORD, _SEED_BITS))  # both streams in one pass
    return h[0], h[1]


def _word_and_bits(cols: Sequence[KeyCol], n_words: int, hashes=None):
    """(block word index int64 [n], PROBE_BITS in-word bit positions, each
    int64 [n]) per row; ``n_words`` is a power of two."""
    h1, h2 = key_hashes(cols) if hashes is None else hashes
    word = h1 & (n_words - 1)
    positions = [(h2 >> (5 * i)) & 31 for i in range(PROBE_BITS)]
    return word, positions


def _pattern(positions) -> torch.Tensor:
    pattern = torch.zeros_like(positions[0])
    for pos in positions:
        pattern = pattern | (1 << pos)
    return pattern


def build_local(cols: Sequence[KeyCol], bits: int, use_range: bool, hashes=None) -> torch.Tensor:
    """One shard's packed sketch, int32 ``[sketch_len(bits)]``: the Bloom
    words of every key (nulls as values), then [max_enc, min_enc] of the
    range lane. An empty shard leaves the window inverted (max 0 < min
    MAX), so an empty build side prunes everything; an all-null shard gives
    max = min = the sentinel, which probe-side nulls pass."""
    n = cols[0][0].shape[0]
    device = cols[0][0].device
    W = bits // 32
    bitarr = torch.zeros(bits, dtype=torch.bool, device=device)
    if n:
        word, positions = _word_and_bits(cols, W, hashes)
        base = word * 32
        bitarr[torch.cat([base + pos for pos in positions])] = True
    shifts = torch.arange(32, dtype=torch.int64, device=device)
    words = (bitarr.view(W, 32).to(torch.int64) << shifts).sum(1)
    if use_range and n:
        enc = _range_enc(cols[0])
        rng = torch.stack([enc.max(), enc.min()])
    elif use_range:
        rng = torch.tensor([0, _NULL_ENC], dtype=torch.int64, device=device)
    else:  # no range test: the widest window passes every probe
        rng = torch.tensor([_NULL_ENC, 0], dtype=torch.int64, device=device)
    return to_u32_lane(torch.cat([words, rng]))


def combine_pair(local: Sequence[torch.Tensor], comm) -> List[torch.Tensor]:
    """Cross-shard combine of the stacked local sketches ``[S, L]`` of each
    shard this process owns -> the global ``[S, L]`` on each: ONE
    ``comm.all_gather`` moves every shard's words (both sides of a pair
    together), then a local fold: OR over the Bloom words, max/min over
    the range words."""
    out = []
    for g in comm.all_gather(list(local)):  # [P, S, L] per owned shard
        W = g.shape[-1] - RANGE_WORDS
        bloom = g[0, :, :W]
        for p in range(1, g.shape[0]):
            bloom = bloom | g[p, :, :W]
        rng = g[:, :, W:].to(torch.int64) & M32
        max_enc = rng[:, :, 0].max(0).values
        min_enc = rng[:, :, 1].min(0).values
        out.append(torch.cat([bloom, to_u32_lane(torch.stack([max_enc, min_enc], 1))], 1))
    return out


def probe(cols: Sequence[KeyCol], sketch: torch.Tensor, use_range: bool, hashes=None) -> torch.Tensor:
    """Row survival mask bool [n] against one combined sketch ``[L]``: True
    = the row MAY have a partner on the other side, False = it provably
    has none. A null-key row survives exactly where the other side may
    hold a null."""
    W = sketch.shape[0] - RANGE_WORDS
    words = sketch.to(torch.int64) & M32
    word, positions = _word_and_bits(cols, W, hashes)
    pattern = _pattern(positions)
    hit = (words[:W].index_select(0, word) & pattern) == pattern
    if use_range:
        enc = _range_enc(cols[0])
        hit = hit & (enc >= words[W + 1]) & (enc <= words[W])
    return hit

