"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds) and
loaded with ``ctypes``. Libraries land in ``build/cylon_tpu_torch/`` beside
the package, named by a hash of the sources and flags, so an edited source
rebuilds and an unchanged one is reused; ptxas's resource report of each
build is kept beside its library (:func:`resource_usage`). :func:`build_all`
starts one ``nvcc`` per source at once; :func:`library` builds on first use.

Nothing here runs at import time: the CPU tests import every module and
there is no ``nvcc`` without the CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "cylon_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
SOURCES = ("radix_pass", "expand_rows", "shuffle_codec", "pk_probe")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):  # shared headers key every library
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(name.encode())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start one nvcc build (or return None when the library exists)."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    out.with_suffix(".ptxas.txt").write_text(log)
    os.replace(tmp, out)


def build_all(names: List[str] = SOURCES) -> Dict[str, Path]:
    """Build every kernel library in parallel (one nvcc per source)."""
    with _lock:
        started = {n: _start(n) for n in names}
        for n, s in started.items():
            _finish(n, s)
    return {n: _target(n) for n in names}


def resource_usage(name: str) -> Dict[str, Dict[str, int]]:
    """ptxas's report of the built ``csrc/<name>.cu``, by mangled kernel
    name: registers a thread, spill stores and spill loads in bytes, static
    shared memory in bytes. Empty when the library was not built here."""
    log = _target(name).with_suffix(".ptxas.txt")
    if not log.exists():
        return {}
    usage: Dict[str, Dict[str, int]] = {}
    cur = None
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = usage.setdefault(m.group(1), {"registers": 0, "spill_stores": 0,
                                                "spill_loads": 0, "smem": 0})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            cur["smem"] = int(m.group(1))
    return usage


def library(name: str, setup: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use;
    ``setup`` declares its entry points' ctypes signatures, once."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(_target(name)))
            setup(lib)
            _libs[name] = lib
        return _libs[name]


def launch(device, entry, *args) -> None:
    """Call the C entry point ``entry`` with ``device`` made current (a raw
    launch goes to the current device, whichever device its stream belongs
    to) and raise on the nonzero cudaError_t it returns."""
    import torch

    with torch.cuda.device(device):
        rc = entry(*args)
    if rc != 0:
        raise RuntimeError(f"{entry.__name__}: CUDA error {rc}")
