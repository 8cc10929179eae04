"""Kernel B5: the PK-FK bucket probe (csrc/pk_probe.cu; replaces
cylon_tpu/ops/pallas_join.py::_pallas_probe and its _probe_block kernel).

``probe(lk, rk, rid, nb, B)``: both sides laid out in ``nb`` hash buckets of
``B`` slots (ops/pk_join.bucket_layout), keys as int32 bit patterns, right
row ids int32 with -1 on an empty slot. For every left slot, the largest
live right row id in its bucket whose key is equal, else -1. With unique
right keys that is the unique match. The kernel builds one open-addressing
hash table per bucket in shared memory (its size rule lives in the
source); a B whose table does not fit a block's 227 KB raises
``ValueError``. Bound on the H100: bytes (see the note in the source).

For a CUDA tensor the wrapper launches the kernel; for a CPU tensor it uses
the plain version. ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

LAUNCHES = {"pk_probe": 0}

#: compare elements per chunk of the plain version (its [g, B, B] compare
#: would take gigabytes at the main path's size in one piece)
_PLAIN_ELEMS = 1 << 24


def probe_plain(lk: torch.Tensor, rk: torch.Tensor, rid: torch.Tensor, nb: int, B: int) -> torch.Tensor:
    """The probe in plain torch ops, over chunks of buckets."""
    lk2, rk2, ri2 = lk.reshape(nb, B), rk.reshape(nb, B), rid.reshape(nb, B)
    out = torch.empty((nb, B), dtype=torch.int32, device=lk.device)
    step = max(1, _PLAIN_ELEMS // (B * B))
    for b0 in range(0, nb, step):
        sl = slice(b0, b0 + step)
        eq = (lk2[sl, :, None] == rk2[sl, None, :]) & (ri2[sl, None, :] >= 0)
        cand = torch.where(eq, ri2[sl, None, :], torch.full_like(ri2[sl, None, :], -1))
        out[sl] = cand.amax(dim=2)
    return out.view(nb * B)


def _setup(lib) -> None:
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.ct_pk_probe.argtypes = [p, p, p, p, i64, i64, p]
    lib.ct_pk_probe.restype = ctypes.c_int
    lib.ct_pk_probe_shared_bytes.argtypes = [i64]
    lib.ct_pk_probe_shared_bytes.restype = i64
    lib.ct_pk_probe_shared_limit.argtypes = []
    lib.ct_pk_probe_shared_limit.restype = i64


def probe(lk: torch.Tensor, rk: torch.Tensor, rid: torch.Tensor, nb: int, B: int) -> torch.Tensor:
    """int32 ``[nb * B]``: each left slot's matching right row id, or -1."""
    nb, B = int(nb), int(B)
    if nb < 1 or B < 1:
        raise ValueError(f"pk probe: need nb >= 1 and B >= 1, got nb={nb} B={B}")
    if nb * B > 2**31 - 1:
        raise ValueError(f"pk probe: nb * B = {nb * B} slots exceed int32 row ids")
    for name, x in (("lk", lk), ("rk", rk), ("rid", rid)):
        if x.dim() != 1 or x.dtype != torch.int32 or x.shape[0] != nb * B:
            raise TypeError(f"pk probe: {name} must be a 1-D int32 tensor of nb * B = {nb * B}")
        if x.device != lk.device:
            raise ValueError("pk probe: inputs on different devices")
    if lk.device.type == "cpu":
        return probe_plain(lk, rk, rid, nb, B)
    if lk.device.type != "cuda":
        raise RuntimeError(f"pk probe: no kernel for device {lk.device}")
    if not (lk.is_contiguous() and rk.is_contiguous() and rid.is_contiguous()):
        raise ValueError("pk probe: inputs must be contiguous")
    lib = _build.library("pk_probe", _setup)
    need, limit = lib.ct_pk_probe_shared_bytes(B), lib.ct_pk_probe_shared_limit()
    if need > limit:
        raise ValueError(
            f"pk probe: B = {B} needs a {need}-byte hash table, more than the "
            f"{limit} bytes ({limit // 1024} KB) of shared memory a block can have")
    out = torch.empty(nb * B, dtype=torch.int32, device=lk.device)
    stream = torch.cuda.current_stream(lk.device).cuda_stream
    _build.launch(
        lk.device, lib.ct_pk_probe,
        lk.data_ptr(), rk.data_ptr(), rid.data_ptr(), out.data_ptr(), nb, B, stream,
    )
    LAUNCHES["pk_probe"] += 1
    return out
