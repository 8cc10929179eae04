"""Kernel K1: stable LSD radix sort of one digit lane, carrying its keys and
a permutation (csrc/radix_pass.cu; replaces
cylon_tpu/ops/pallas_radix.py::radix_pass_pallas).

A digit lane is an int32 tensor holding uint32 bit patterns or an int64
tensor holding uint64 bit patterns (torch has no full unsigned arithmetic,
so the signed containers carry the patterns and every digit is extracted
with a mask). :func:`radix_sort_lane` sorts the bits ``[lo, hi)`` in 8-bit
digits, the last one possibly narrower:

* the lane is gathered once through the carried perm (not at all when the
  perm is the identity, ``perm=None``);
* K1a :func:`lane_hist` — one read of the lane counts every digit of every
  pass: int32 ``[passes, 256]``;
* K1b :func:`onesweep_pass` — one launch per digit: stable rank within a
  tile, decoupled look-back over the tiles before it for each digit's
  global start, keys and perm written out together in digit order.

Each wrapper launches its CUDA kernel for a CUDA tensor and uses its plain
PyTorch version for a CPU tensor; there is no other route. ``LAUNCHES``
counts kernel launches (the plain versions do not count).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import _build

#: rows per tile of K1b: must equal TILE in csrc/radix_pass.cu (checked on load)
TILE = 4096
#: ints before each pass's status words (the tile counter), as in the source
STATUS_HEAD = 32
RADIX = 256
RADIX_BITS = 8
#: status words carry a count in 30 bits
MAX_ROWS = (1 << 30) - 1

LAUNCHES = {"radix_lane_hist": 0, "radix_onesweep": 0}


def n_tiles(n: int) -> int:
    return -(-n // TILE)


def n_passes(lo: int, hi: int) -> int:
    return -(-(hi - lo) // RADIX_BITS)


def digits(keys: torch.Tensor, shift: int, bits: int) -> torch.Tensor:
    """int64 digit ``[shift, shift + bits)`` of every key."""
    return (keys.to(torch.int64) >> shift) & ((1 << bits) - 1)


def _pass_digits(lo: int, hi: int):
    """(shift, bits) of each pass over ``[lo, hi)``."""
    return [(s, min(RADIX_BITS, hi - s)) for s in range(lo, hi, RADIX_BITS)]


def _check(keys, perm, lo, hi):
    if keys.dim() != 1:
        raise ValueError("radix sort: the lane must be 1-D")
    if keys.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"radix sort: digit lane must be int32/int64, got {keys.dtype}")
    if perm is not None:
        if perm.dim() != 1 or perm.shape[0] != keys.shape[0]:
            raise ValueError("radix sort: lane and perm must be 1-D of equal length")
        if perm.dtype != torch.int32:
            raise TypeError(f"radix sort: perm must be int32, got {perm.dtype}")
        if perm.device != keys.device:
            raise ValueError("radix sort: lane and perm on different devices")
    if not (0 <= lo <= hi <= 8 * keys.element_size()):
        raise ValueError(f"radix sort: bad bit span [{lo}, {hi})")


def _cuda_lib(x: torch.Tensor):
    if x.device.type != "cuda":
        raise RuntimeError(f"radix sort: no kernel for device {x.device}")
    if x.shape[0] > MAX_ROWS:
        raise ValueError(f"radix sort: {x.shape[0]} rows exceed the kernel's {MAX_ROWS}")
    return _build.library("radix_pass", _setup), torch.cuda.current_stream(x.device).cuda_stream


def _setup(lib) -> None:
    lib.ct_radix_tile.restype = ctypes.c_int
    lib.ct_radix_status_head.restype = ctypes.c_int
    if lib.ct_radix_tile() != TILE or lib.ct_radix_status_head() != STATUS_HEAD:
        raise RuntimeError("radix sort: TILE or STATUS_HEAD differs between CUDA and Python")
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.ct_radix_lane_hist.argtypes = [p, i64, p, i64, i64, i64, p]
    lib.ct_radix_lane_hist.restype = ctypes.c_int
    lib.ct_radix_onesweep.argtypes = [p, p, p, p, p, p, i64, i64, i64, i64, p]
    lib.ct_radix_onesweep.restype = ctypes.c_int


# ----------------------------------------------------------------------
# K1a: every digit's histogram in one read
# ----------------------------------------------------------------------
def lane_hist_plain(keys: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    rows = [torch.bincount(digits(keys, s, b), minlength=RADIX) for s, b in _pass_digits(lo, hi)]
    return torch.stack(rows).to(torch.int32)


def lane_hist(keys: torch.Tensor, lo: int, hi: int, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int32 ``[passes, 256]``: the counts of each pass's digit over the lane.
    ``out``, when given, is a zeroed int32 ``[passes * 256]`` to count into."""
    _check(keys, None, lo, hi)
    if hi <= lo:
        raise ValueError("radix sort: empty bit span")
    if keys.device.type == "cpu":
        return lane_hist_plain(keys, lo, hi)
    lib, stream = _cuda_lib(keys)
    passes = n_passes(lo, hi)
    if out is None:
        out = torch.zeros(passes * RADIX, dtype=torch.int32, device=keys.device)
    if keys.shape[0] > 0:
        _build.launch(keys.device, lib.ct_radix_lane_hist, keys.contiguous().data_ptr(),
                      keys.element_size(), out.data_ptr(), keys.shape[0], lo, hi, stream)
        LAUNCHES["radix_lane_hist"] += 1
    return out.view(passes, RADIX)


# ----------------------------------------------------------------------
# K1b: one one-sweep pass
# ----------------------------------------------------------------------
def onesweep_pass_plain(
    keys: torch.Tensor, perm: Optional[torch.Tensor], shift: int, bits: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pass in plain torch ops: keys and perm reordered by a stable
    argsort of the digit."""
    order = torch.sort(digits(keys, shift, bits), stable=True).indices
    p = order.to(torch.int32) if perm is None else perm[order]
    return keys[order], p


def status_words(n: int, passes: int, device) -> torch.Tensor:
    """Zeroed scratch of K1b for ``passes`` passes over ``n`` rows."""
    return torch.zeros(passes * (STATUS_HEAD + n_tiles(n) * RADIX), dtype=torch.int32, device=device)


def onesweep_pass(
    keys: torch.Tensor,
    perm: Optional[torch.Tensor],
    counts: torch.Tensor,
    shift: int,
    bits: int,
    status: Optional[torch.Tensor] = None,
    out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(keys, perm) stably sorted by digit ``[shift, shift + bits)``,
    ``bits <= 8``; ``perm=None`` is the identity. ``counts`` is the digit's
    int32 ``[256]`` histogram over the lane (a row of :func:`lane_hist`);
    ``status`` a zeroed :func:`status_words` block for one pass (allocated
    here when None); ``out`` the two output tensors."""
    _check(keys, perm, shift, shift + bits)
    if not 1 <= bits <= RADIX_BITS:
        raise ValueError(f"radix sort: bad digit width {bits}")
    if keys.device.type == "cpu":
        return onesweep_pass_plain(keys, perm, shift, bits)
    lib, stream = _cuda_lib(keys)
    n = keys.shape[0]
    k_out, p_out = out if out is not None else (
        torch.empty_like(keys), torch.empty(n, dtype=torch.int32, device=keys.device))
    if n == 0:
        return k_out, p_out
    if status is None:
        status = status_words(n, 1, keys.device)
    for x, size in ((counts, RADIX), (status, STATUS_HEAD + n_tiles(n) * RADIX)):
        if x.dtype != torch.int32 or x.numel() < size or not x.is_contiguous() or x.device != keys.device:
            raise ValueError("radix sort: counts or status words of the wrong type, size or device")
    if not keys.is_contiguous() or (perm is not None and not perm.is_contiguous()):
        raise ValueError("radix sort: inputs must be contiguous")
    for x, dt in ((k_out, keys.dtype), (p_out, torch.int32)):
        if x.dtype != dt or x.shape != (n,) or not x.is_contiguous() or x.device != keys.device:
            raise ValueError("radix sort: output buffers of the wrong type, size or device")
    _build.launch(
        keys.device, lib.ct_radix_onesweep,
        keys.data_ptr(), None if perm is None else perm.data_ptr(), k_out.data_ptr(),
        p_out.data_ptr(), counts.data_ptr(), status.data_ptr(), keys.element_size(), n,
        shift, bits, stream,
    )
    LAUNCHES["radix_onesweep"] += 1
    return k_out, p_out


# ----------------------------------------------------------------------
# the lane sort
# ----------------------------------------------------------------------
def radix_sort_lane_plain(
    enc: torch.Tensor, perm: Optional[torch.Tensor], lo: int, hi: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The lane sort in plain torch ops: a stable ``torch.sort`` per digit,
    carrying key and perm."""
    n = enc.shape[0]
    keys = enc if perm is None else enc[perm.long()]
    p = torch.arange(n, dtype=torch.int32, device=enc.device) if perm is None else perm
    for shift, bits in _pass_digits(lo, hi):
        keys, p = onesweep_pass_plain(keys, p, shift, bits)
    return keys, p


def radix_sort_lane(
    enc: torch.Tensor, perm: Optional[torch.Tensor], lo: int, hi: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable sort of ``enc[perm]`` by bits ``[lo, hi)``: returns
    (sorted keys, perm_out) with sorted keys == ``enc[perm_out]`` and
    perm_out the carried perm reordered (``perm=None``: the identity, and
    perm_out is the stable argsort)."""
    _check(enc, perm, lo, hi)
    if enc.device.type == "cpu":
        return radix_sort_lane_plain(enc, perm, lo, hi)
    lib, _ = _cuda_lib(enc)
    n = enc.shape[0]
    keys = enc.contiguous() if perm is None else enc.index_select(0, perm)
    if n == 0 or hi <= lo:
        p = torch.arange(n, dtype=torch.int32, device=enc.device) if perm is None else perm
        return keys, p
    passes = n_passes(lo, hi)
    per_pass = STATUS_HEAD + n_tiles(n) * RADIX
    scratch = torch.zeros(passes * (RADIX + per_pass), dtype=torch.int32, device=enc.device)
    hist = lane_hist(keys, lo, hi, out=scratch[: passes * RADIX])
    status = scratch[passes * RADIX:]
    bufs = [(torch.empty_like(keys), torch.empty(n, dtype=torch.int32, device=enc.device))]
    if passes > 1:
        bufs.append((torch.empty_like(keys), torch.empty(n, dtype=torch.int32, device=enc.device)))
    p = perm.contiguous() if perm is not None else None
    for i, (shift, bits) in enumerate(_pass_digits(lo, hi)):
        keys, p = onesweep_pass(keys, p, hist[i], shift, bits,
                                status=status[i * per_pass:(i + 1) * per_pass], out=bufs[i % 2])
    return keys, p


def radix_pass(enc: torch.Tensor, perm: torch.Tensor, shift: int, bits: int) -> torch.Tensor:
    """One stable counting-sort pass over digit ``[shift, shift + bits)`` of
    ``enc`` carrying ``perm``: ``enc[result]`` is stably sorted by the
    digit (the JAX package's ``radix_pass``)."""
    return radix_sort_lane(enc, perm, shift, shift + bits)[1]
