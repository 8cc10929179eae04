"""Vectorized row hashing (counterpart of cylon_tpu/ops/hash.py), bit for
bit: murmur3_x86_32 over exactly two uint32 words per value, chained across
columns with ``h = 31 * h + column_hash``, nulls hashing to 0. Equal hashes
in both packages put every row on the same shard.

torch has no full uint32 arithmetic, so a uint32 pattern rides in an int64
tensor and every multiply and shift is masked back to 32 bits. Multiplies
split one factor into 16-bit halves so no product leaves int64's range.
On a card the shuffle's pack kernel (ops/cuda_codec.py, kernel B2) replays
the murmur chain itself over the words :func:`to_words` makes here.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

M32 = 0xFFFFFFFF
C1, C2 = 0xCC9E2D51, 0x1B873593
NAN_WORD = 0x7FC00000

KeyCol = Tuple[torch.Tensor, Optional[torch.Tensor]]

_SIGNED_NARROW = (torch.int8, torch.int16, torch.int32)
_UNSIGNED_NARROW = (torch.uint8, torch.uint16, torch.uint32)
_FLOAT_NARROW = (torch.float32, torch.float16, torch.bfloat16)


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2^32`` for uint32 patterns in int64 and a constant c."""
    lo = (x & 0xFFFF) * c
    hi = ((x >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & M32


def rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def mix_word(h: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """One murmur3_x86_32 body round."""
    k = mul32(k, C1)
    k = rotl32(k, 15)
    k = mul32(k, C2)
    h = h ^ k
    h = rotl32(h, 13)
    return (mul32(h, 5) + 0xE6546B64) & M32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _f32_bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32).to(torch.int64) & M32


_F32_TINY = 2.0**-126   # smallest normal float32
_F64_TINY = 2.0**-1022  # smallest normal float64


def _ftz(x: torch.Tensor) -> torch.Tensor:
    """Flush float32 subnormals to a zero of the same sign. The JAX package
    hashes in XLA, which treats subnormal inputs as zero and flushes
    subnormal results (on the CPU as on the TPU); the port does the same by
    hand so tiny floats route alike."""
    return torch.where(x.abs() < _F32_TINY, x * 0, x)


def to_words(data: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A numeric column as exactly TWO uint32 words (int64 tensors), the
    JAX package's encoding: the same value hashes the same at any width
    (int8/int32/int64 -1 all give (0xFFFFFFFF, 0xFFFFFFFF); f32 and f64 5.0
    give (bits(5.0f), 0)). Floats map -0 to +0 and every NaN to 0x7FC00000;
    a float64 is the double-float split hi = f32(x), lo = f32(x - f64(hi)),
    not its bit pattern, so both packages route it alike."""
    dt = data.dtype
    zeros = torch.zeros(data.shape, dtype=torch.int64, device=data.device)
    if dt == torch.bool:
        return data.to(torch.int64), zeros
    if dt in _FLOAT_NARROW:
        x = data.to(torch.float32)
        x = torch.where(x.abs() < _F32_TINY, torch.zeros_like(x), x)  # -0, subnormals -> +0
        w = torch.where(torch.isnan(x), NAN_WORD, _f32_bits(x))
        return w, zeros
    if dt == torch.float64:
        x = torch.where(data.abs() < _F64_TINY, torch.zeros_like(data), data)
        nanm = torch.isnan(x)
        hi = _ftz(x.to(torch.float32))
        lo = torch.where(
            nanm | torch.isinf(hi),
            torch.zeros_like(hi),
            _ftz((x - hi.to(torch.float64)).to(torch.float32)),
        )
        hib = torch.where(nanm, NAN_WORD, _f32_bits(hi))
        return hib, _f32_bits(lo)
    if dt in _SIGNED_NARROW:
        w = data.to(torch.int64)
        return w & M32, (w >> 31) & M32
    if dt in _UNSIGNED_NARROW:
        return data.to(torch.int64), zeros
    if dt in (torch.int64, torch.uint64):
        u = data.view(torch.int64) if dt == torch.uint64 else data
        return u & M32, (u >> 32) & M32
    raise TypeError(f"cannot hash a column of dtype {dt}")


def murmur3_words(w0: torch.Tensor, w1: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """murmur3_x86_32 of two uint32 words per row -> uint32 in int64."""
    h = torch.full(w0.shape, seed & M32, dtype=torch.int64, device=w0.device)
    h = mix_word(h, w0)
    h = mix_word(h, w1)
    return fmix32(h ^ 8)


def murmur3_column(data: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """murmur3_x86_32 of each element's two words -> uint32 in int64 [n]."""
    return murmur3_words(*to_words(data), seed=seed)


def hash_columns(cols: Sequence[KeyCol], seed: int = 0) -> torch.Tensor:
    """Composite row hash over (data, valid) columns: ``h = 31*h + col``,
    null entries contributing 0. uint32 values in an int64 tensor."""
    h = None
    for data, valid in cols:
        ch = murmur3_column(data, seed)
        if valid is not None:
            ch = torch.where(valid, ch, torch.zeros_like(ch))
        h = ch if h is None else (mul32(h, 31) + ch) & M32
    if h is None:
        raise ValueError("hash_columns requires at least one column")
    return h


# ----------------------------------------------------------------------
# strings: murmur3_x86_32 of the UTF-8 bytes (the JAX package's
# native.murmur3_strings and its pure-python twin, util/murmur3.cpp)
# ----------------------------------------------------------------------

def murmur3_bytes(data: bytes, seed: int = 0) -> int:
    """MurmurHash3_x86_32 of a byte string."""
    h = seed & M32
    nblocks = len(data) // 4
    for i in range(nblocks):
        k = int.from_bytes(data[4 * i: 4 * i + 4], "little")
        k = (k * C1) & M32
        k = ((k << 15) | (k >> 17)) & M32
        k = (k * C2) & M32
        h ^= k
        h = ((h << 13) | (h >> 19)) & M32
        h = (h * 5 + 0xE6546B64) & M32
    tail = data[4 * nblocks:]
    k = 0
    if len(tail) >= 3:
        k ^= tail[2] << 16
    if len(tail) >= 2:
        k ^= tail[1] << 8
    if len(tail) >= 1:
        k ^= tail[0]
        k = (k * C1) & M32
        k = ((k << 15) | (k >> 17)) & M32
        k = (k * C2) & M32
        h ^= k
    h ^= len(data)
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & M32
    return h ^ (h >> 16)


def hash_dictionary_host(dictionary: np.ndarray) -> np.ndarray:
    """uint32 value hash of each dictionary string (host side, once per
    dictionary). Hashing ``dict_hash[codes]`` instead of the codes makes
    routing independent of the dictionary: equal strings land on the same
    shard whichever table encoded them."""
    return np.array(
        [murmur3_bytes(str(s).encode("utf-8")) for s in dictionary], np.uint32
    )
