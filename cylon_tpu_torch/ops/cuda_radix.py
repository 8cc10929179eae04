"""Kernel K1: one stable radix pass carrying a permutation
(csrc/radix_pass.cu; replaces cylon_tpu/ops/pallas_radix.py::radix_pass_pallas).

A digit lane is an int32 tensor holding uint32 bit patterns or an int64
tensor holding uint64 bit patterns (torch has no full unsigned arithmetic,
so the signed containers carry the patterns and every digit is extracted
with a mask). A pass over digit ``[shift, shift + bits)``, ``bits <= 8``:

* K1a :func:`radix_hist` — per-tile digit histogram, bucket-major
  ``[256 * n_tiles]``;
* the exclusive scan of that histogram (``torch.cumsum``, as the JAX package
  does it in XLA glue) — every (bucket, tile) start offset;
* K1b :func:`radix_scatter` — each row's stable in-tile rank, written
  straight to ``perm_out[offset + rank]``.

Each wrapper launches its CUDA kernel for a CUDA tensor and uses its plain
PyTorch version for a CPU tensor; there is no other route. ``LAUNCHES``
counts kernel launches (the plain versions do not count).
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

#: rows per tile: must equal TILE in csrc/radix_pass.cu (checked on load)
TILE = 4096
RADIX = 256

LAUNCHES = {"radix_hist": 0, "radix_scatter": 0}


def n_tiles(n: int) -> int:
    return -(-n // TILE)


def digits(enc: torch.Tensor, perm: torch.Tensor, shift: int, bits: int) -> torch.Tensor:
    """int64 digit of every row read through the permutation."""
    g = enc.index_select(0, perm).to(torch.int64)
    return (g >> shift) & ((1 << bits) - 1)


def _check(enc, perm, shift, bits):
    if enc.dim() != 1 or perm.dim() != 1 or enc.shape[0] != perm.shape[0]:
        raise ValueError("radix pass: enc and perm must be 1-D of equal length")
    if enc.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"radix pass: digit lane must be int32/int64, got {enc.dtype}")
    if perm.dtype != torch.int32:
        raise TypeError(f"radix pass: perm must be int32, got {perm.dtype}")
    if not (1 <= bits <= 8) or shift < 0 or shift + bits > 8 * enc.element_size():
        raise ValueError(f"radix pass: bad digit shift={shift} bits={bits}")
    if enc.device != perm.device:
        raise ValueError("radix pass: enc and perm on different devices")


def _cuda_args(enc, perm):
    if enc.device.type != "cuda":
        raise RuntimeError(f"radix pass: no kernel for device {enc.device}")
    if not (enc.is_contiguous() and perm.is_contiguous()):
        raise ValueError("radix pass: inputs must be contiguous")
    lib = _build.library("radix_pass", _setup)
    return lib, torch.cuda.current_stream(enc.device).cuda_stream


def _setup(lib) -> None:
    lib.ct_radix_tile.restype = ctypes.c_int
    if lib.ct_radix_tile() != TILE:
        raise RuntimeError("radix pass: TILE differs between CUDA and Python")
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.ct_radix_hist.argtypes = [p, i64, p, p, i64, i64, i64, i64, p]
    lib.ct_radix_hist.restype = ctypes.c_int
    lib.ct_radix_scatter.argtypes = [p, i64, p, p, p, i64, i64, i64, i64, p]
    lib.ct_radix_scatter.restype = ctypes.c_int


# ----------------------------------------------------------------------
# K1a: histogram
# ----------------------------------------------------------------------
def radix_hist_plain(enc, perm, shift: int, bits: int) -> torch.Tensor:
    n = perm.shape[0]
    nt = n_tiles(n)
    tile = torch.arange(n, device=perm.device) // TILE
    flat = digits(enc, perm, shift, bits) * nt + tile
    return torch.bincount(flat, minlength=RADIX * nt).to(torch.int32)


def radix_hist(enc, perm, shift: int, bits: int) -> torch.Tensor:
    """int32 ``[256 * n_tiles]`` bucket-major digit counts per tile."""
    _check(enc, perm, shift, bits)
    if enc.device.type == "cpu":
        return radix_hist_plain(enc, perm, shift, bits)
    lib, stream = _cuda_args(enc, perm)
    n = perm.shape[0]
    nt = n_tiles(n)
    hist = torch.empty(RADIX * nt, dtype=torch.int32, device=enc.device)
    if n == 0:
        return hist
    _build.launch(
        enc.device, lib.ct_radix_hist,
        enc.data_ptr(), enc.element_size(), perm.data_ptr(), hist.data_ptr(),
        n, nt, shift, bits, stream,
    )
    LAUNCHES["radix_hist"] += 1
    return hist


# ----------------------------------------------------------------------
# K1b: stable rank + scatter
# ----------------------------------------------------------------------
def radix_scatter_plain(enc, perm, offs, shift: int, bits: int) -> torch.Tensor:
    """perm_out[offs[bucket, tile] + stable rank within (bucket, tile)] = perm."""
    n = perm.shape[0]
    nt = n_tiles(n)
    tile = torch.arange(n, device=perm.device) // TILE
    flat = digits(enc, perm, shift, bits) * nt + tile
    order = torch.sort(flat, stable=True).indices
    start = torch.cumsum(torch.bincount(flat, minlength=RADIX * nt), 0)
    start = start - torch.bincount(flat, minlength=RADIX * nt)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=perm.device) - start[flat[order]]
    dest = offs.to(torch.int64)[flat] + rank
    out = torch.empty_like(perm)
    out[dest] = perm
    return out


def radix_scatter(enc, perm, offs, shift: int, bits: int) -> torch.Tensor:
    _check(enc, perm, shift, bits)
    if enc.device.type == "cpu":
        return radix_scatter_plain(enc, perm, offs, shift, bits)
    lib, stream = _cuda_args(enc, perm)
    n = perm.shape[0]
    nt = n_tiles(n)
    if offs.dtype != torch.int32 or offs.shape != (RADIX * nt,) or not offs.is_contiguous():
        raise ValueError("radix scatter: offs must be contiguous int32 [256 * n_tiles]")
    out = torch.empty_like(perm)
    if n == 0:
        return out
    _build.launch(
        enc.device, lib.ct_radix_scatter,
        enc.data_ptr(), enc.element_size(), perm.data_ptr(), offs.data_ptr(),
        out.data_ptr(), n, nt, shift, bits, stream,
    )
    LAUNCHES["radix_scatter"] += 1
    return out


def scan_offsets(hist: torch.Tensor) -> torch.Tensor:
    """Exclusive scan of the bucket-major histogram: each (bucket, tile)'s
    first destination row."""
    return torch.cumsum(hist, 0, dtype=torch.int32) - hist


def radix_pass(enc, perm, shift: int, bits: int) -> torch.Tensor:
    """One stable counting-sort pass over digit ``[shift, shift + bits)`` of
    ``enc`` carrying ``perm``: ``enc[result]`` is stably sorted by the digit."""
    hist = radix_hist(enc, perm, shift, bits)
    return radix_scatter(enc, perm, scan_offsets(hist), shift, bits)


def radix_pass_plain(enc, perm, shift: int, bits: int) -> torch.Tensor:
    """The pass in plain torch ops: the carried perm reordered by a stable
    argsort of the digit."""
    d = digits(enc, perm, shift, bits)
    return perm[torch.sort(d, stable=True).indices]
