"""Kernel K2: the windowed expand (csrc/expand_rows.cu; replaces
cylon_tpu/ops/pallas_gather.py::expand_rows_raw).

``expand_rows(srcT, li)`` is ``srcT[:, clamp(li, 0, cap - 1)]`` for a
lane-major int32 source ``[L, cap]``. The join's left emit calls it with
indices that are non-decreasing with step <= 1, so each block of outputs
reads one narrow source window; the kernel stays exact for any indices.
Bound on the H100: memory (one read of the touched source columns and of
``li``, one write of the output).

For a CUDA tensor the wrapper launches the kernel; for a CPU tensor it uses
the plain version. ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

LAUNCHES = {"expand_rows": 0}

#: outputs per block: must equal OUT_TILE in csrc/expand_rows.cu
OUT_TILE = 1024


def expand_rows_plain(srcT: torch.Tensor, li: torch.Tensor) -> torch.Tensor:
    cap = srcT.shape[1]
    return srcT.index_select(1, li.clamp(0, cap - 1))


def _setup(lib) -> None:
    lib.ct_expand_out_tile.restype = ctypes.c_int
    if lib.ct_expand_out_tile() != OUT_TILE:
        raise RuntimeError("expand: OUT_TILE differs between CUDA and Python")
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.ct_expand_rows.argtypes = [p, p, p, i64, i64, i64, p]
    lib.ct_expand_rows.restype = ctypes.c_int


def expand_rows(srcT: torch.Tensor, li: torch.Tensor) -> torch.Tensor:
    """int32 ``[L, n_out]``: ``srcT[:, clamp(li, 0, cap - 1)]``."""
    if srcT.dim() != 2 or srcT.dtype != torch.int32:
        raise TypeError("expand: srcT must be a 2-D int32 tensor")
    if li.dim() != 1 or li.dtype != torch.int32:
        raise TypeError("expand: li must be a 1-D int32 tensor")
    if srcT.device != li.device:
        raise ValueError("expand: srcT and li on different devices")
    L, cap = srcT.shape
    n_out = li.shape[0]
    if cap == 0 and n_out > 0:
        raise ValueError("expand: empty source with outputs requested")
    if srcT.device.type == "cpu":
        return expand_rows_plain(srcT, li)
    if srcT.device.type != "cuda":
        raise RuntimeError(f"expand: no kernel for device {srcT.device}")
    if not (srcT.is_contiguous() and li.is_contiguous()):
        raise ValueError("expand: inputs must be contiguous")
    out = torch.empty((L, n_out), dtype=torch.int32, device=srcT.device)
    if L == 0 or n_out == 0:
        return out
    lib = _build.library("expand_rows", _setup)
    stream = torch.cuda.current_stream(srcT.device).cuda_stream
    _build.check(
        lib.ct_expand_rows(
            srcT.data_ptr(), li.data_ptr(), out.data_ptr(), L, cap, n_out, stream
        ),
        "ct_expand_rows",
    )
    LAUNCHES["expand_rows"] += 1
    return out
