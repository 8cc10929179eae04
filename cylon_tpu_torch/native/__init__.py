"""Native (C++) host runtime of the port, loaded over ctypes (counterpart of
cylon_tpu/native/__init__.py).

The reference's host-side runtime is native C++ (Arrow CSV reader over mmap,
io/arrow_io.cpp:33-61; row-wise CSV writer, table.cpp:244-253). Here it lives
in ``csv.cpp`` (the mmap, multithreaded CSV tokenizer and typed parser with
sorted dictionary-coded strings, the buffered row writer) and
``runtime.cpp`` (the arena pool, murmur3 over strings, the sorted
dictionary merge): the port's own copies of the JAX package's sources.
They build with g++ at first use into ``build/cylon_tpu_torch/``, named by
a hash of the sources and flags, as the CUDA kernels do (``_build.py``).

No quiet fallback: a failed build raises ``RuntimeError`` with the
compiler's last lines. The pure-Python paths (pyarrow for reads, pandas for
writes) are taken only under ``CYLON_TPU_TORCH_NO_NATIVE=1`` or for the
read options the codec does not cover (``io.csv.CSVReadOptions``).
:func:`murmur3_strings` uses the native batch only when the library is
already loaded, and otherwise its bit-identical Python twin, so no g++
build ever lands on a join's path.

``capi.cpp`` is the C ABI a foreign language calls (:func:`build_capi`);
``examples/`` holds two C programs that drive it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from .._build import BUILD_DIR
from ..ops.hash import murmur3_bytes as _murmur3_32_py
from ..utils import envgate as _envgate

HERE = Path(__file__).resolve().parent
SOURCES = (HERE / "csv.cpp", HERE / "runtime.cpp")
SOURCE_CAPI = HERE / "capi.cpp"
CXX_FLAGS = ["-std=c++20", "-O3", "-fPIC", "-shared", "-pthread"]
CAPI_FLAGS = ["-std=c++20", "-O2", "-fPIC", "-shared", "-pthread"]

_lock = threading.Lock()
_lib_handle = None

# ColType tags (must match csv.cpp)
CT_INT64, CT_FLOAT64, CT_BOOL, CT_STRING = 0, 1, 2, 3


def enabled() -> bool:
    """False under the kill switch CYLON_TPU_TORCH_NO_NATIVE (set, not 0)."""
    return _envgate.NO_NATIVE.get() in ("", "0")


def _target(stem: str, sources, flags) -> Path:
    """``build/cylon_tpu_torch/<stem>_<hash>.so``: the hash covers the
    sources and the flags, so an edited source lands at a new path (glibc's
    dlopen caches by pathname) and an unchanged one is reused."""
    h = hashlib.sha256()
    for p in sources:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"


def _compile(out: Path, cmd: List[str]) -> Path:
    """Run the g++ command ``cmd`` (its output last) into ``out`` unless it
    exists; raise with the compiler's last lines when it fails."""
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run([*cmd, "-o", str(tmp)], capture_output=True, text=True,
                              timeout=300)
    except (FileNotFoundError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"g++ could not build {out.name}: {e}") from e
    if proc.returncode != 0:
        tail = "\n".join((proc.stdout + proc.stderr).splitlines()[-30:])
        raise RuntimeError(f"g++ failed to build {out.name}:\n{tail}")
    os.replace(tmp, out)
    return out


def library_path() -> Path:
    """The built codec and runtime library (built here on first call)."""
    return _compile(_target("libcylon_native", SOURCES, CXX_FLAGS),
                    ["g++", *CXX_FLAGS, *map(str, SOURCES)])


def build_capi() -> str:
    """Compile the C ABI (``capi.cpp``, the Java/JNI binding's analog)
    against the running interpreter and return the library's path. It links
    libpython from sysconfig's LIBDIR; a program that loads it needs that
    directory on LD_LIBRARY_PATH and the port on PYTHONPATH."""
    import sysconfig

    inc = sysconfig.get_path("include")
    libdir = sysconfig.get_config_var("LIBDIR") or ""
    ver = sysconfig.get_config_var("LDVERSION") or sysconfig.get_python_version()
    include, link = f"-I{inc}", [f"-L{libdir}", f"-lpython{ver}"]
    out = _target("libcylon_capi", (SOURCE_CAPI,), [*CAPI_FLAGS, include, *link])
    # the library comes after the source on the command line
    return str(_compile(out, ["g++", *CAPI_FLAGS, include, str(SOURCE_CAPI), *link]))


def _bind(lib):
    c = ctypes
    lib.ct_csv_read.restype = c.c_void_p
    lib.ct_csv_read.argtypes = [c.c_char_p, c.c_char, c.c_int32, c.c_int32, c.c_int32]
    lib.ct_csv_error.restype = c.c_char_p
    lib.ct_csv_error.argtypes = [c.c_void_p]
    lib.ct_csv_nrows.restype = c.c_int64
    lib.ct_csv_nrows.argtypes = [c.c_void_p]
    lib.ct_csv_ncols.restype = c.c_int32
    lib.ct_csv_ncols.argtypes = [c.c_void_p]
    lib.ct_csv_colname.restype = c.c_char_p
    lib.ct_csv_colname.argtypes = [c.c_void_p, c.c_int32]
    lib.ct_csv_coltype.restype = c.c_int32
    lib.ct_csv_coltype.argtypes = [c.c_void_p, c.c_int32]
    for name, ty in [
        ("ct_csv_data_i64", c.POINTER(c.c_int64)),
        ("ct_csv_data_f64", c.POINTER(c.c_double)),
        ("ct_csv_data_bool", c.POINTER(c.c_uint8)),
        ("ct_csv_data_codes", c.POINTER(c.c_int32)),
        ("ct_csv_valid", c.POINTER(c.c_uint8)),
    ]:
        fn = getattr(lib, name)
        fn.restype = ty
        fn.argtypes = [c.c_void_p, c.c_int32]
    lib.ct_csv_dict_size.restype = c.c_int32
    lib.ct_csv_dict_size.argtypes = [c.c_void_p, c.c_int32]
    lib.ct_csv_dict.restype = c.POINTER(c.c_char_p)
    lib.ct_csv_dict.argtypes = [c.c_void_p, c.c_int32]
    lib.ct_csv_free.restype = None
    lib.ct_csv_free.argtypes = [c.c_void_p]
    lib.ct_csv_write.restype = c.c_int32
    lib.ct_csv_write.argtypes = [
        c.c_char_p, c.c_char, c.c_int64, c.c_int32,
        c.POINTER(c.c_char_p), c.POINTER(c.c_int32),
        c.POINTER(c.c_void_p), c.POINTER(c.c_void_p), c.POINTER(c.c_void_p),
    ]
    # runtime.cpp: pool + murmur3 + dictionary union
    lib.ct_pool_create.restype = c.c_void_p
    lib.ct_pool_create.argtypes = [c.c_int64]
    lib.ct_pool_alloc.restype = c.c_void_p
    lib.ct_pool_alloc.argtypes = [c.c_void_p, c.c_int64]
    for name in ("ct_pool_in_use", "ct_pool_peak", "ct_pool_reserved", "ct_pool_allocs"):
        fn = getattr(lib, name)
        fn.restype = c.c_int64
        fn.argtypes = [c.c_void_p]
    lib.ct_pool_reset.restype = None
    lib.ct_pool_reset.argtypes = [c.c_void_p]
    lib.ct_pool_destroy.restype = None
    lib.ct_pool_destroy.argtypes = [c.c_void_p]
    lib.ct_murmur3_32.restype = c.c_uint32
    lib.ct_murmur3_32.argtypes = [c.c_void_p, c.c_int64, c.c_uint32]
    lib.ct_murmur3_batch.restype = None
    lib.ct_murmur3_batch.argtypes = [
        c.c_char_p, c.POINTER(c.c_int64), c.c_int64, c.c_uint32,
        c.POINTER(c.c_uint32),
    ]
    lib.ct_dict_union_u32.restype = c.c_int64
    lib.ct_dict_union_u32.argtypes = [
        c.c_void_p, c.c_int64, c.c_int32,
        c.c_void_p, c.c_int64, c.c_int32,
        c.c_void_p, c.c_int32,
        c.POINTER(c.c_int32), c.POINTER(c.c_int32),
    ]
    return lib


def get_lib():
    """The loaded native library, built on first use. Raises RuntimeError
    when g++ fails, or when CYLON_TPU_TORCH_NO_NATIVE turns it off."""
    global _lib_handle
    if not enabled():
        raise RuntimeError("the native runtime is off (CYLON_TPU_TORCH_NO_NATIVE)")
    if _lib_handle is not None:
        return _lib_handle
    with _lock:
        if _lib_handle is None:
            _lib_handle = _bind(ctypes.CDLL(str(library_path())))
    return _lib_handle


def get_lib_if_loaded():
    """The library handle only if already loaded and not switched off:
    never triggers a g++ build (keeps compile latency off the join and
    groupby path)."""
    return _lib_handle if enabled() else None


def available() -> bool:
    """Whether the native codec serves: False under the kill switch, else
    True once the library is built and loaded (a failed build raises)."""
    return enabled() and get_lib() is not None


class MemoryPool:
    """Arena allocator for host staging buffers (reference memory-pool
    analog, ctx/memory_pool.hpp:69). ``alloc_array`` returns a numpy view
    into pool memory, valid until ``reset``/``close``."""

    def __init__(self, block_bytes: int = 1 << 20):
        self._lib = get_lib()
        self._h = self._lib.ct_pool_create(block_bytes)

    def alloc_array(self, shape, dtype) -> np.ndarray:
        dt = np.dtype(dtype)
        n = int(np.prod(shape)) * dt.itemsize
        ptr = self._lib.ct_pool_alloc(self._h, max(n, 1))
        buf = (ctypes.c_char * max(n, 1)).from_address(ptr)
        # the view's base chain (array -> ctypes buf -> pool) keeps the pool
        # alive while any allocation is referenced; reset()/close() are the
        # explicit arena-invalidation points
        buf._pool = self
        return np.frombuffer(buf, dtype=dt, count=int(np.prod(shape))).reshape(shape)

    def reset(self) -> None:
        self._lib.ct_pool_reset(self._h)

    @property
    def bytes_in_use(self) -> int:
        return self._lib.ct_pool_in_use(self._h)

    @property
    def bytes_peak(self) -> int:
        return self._lib.ct_pool_peak(self._h)

    @property
    def bytes_reserved(self) -> int:
        return self._lib.ct_pool_reserved(self._h)

    @property
    def alloc_count(self) -> int:
        return self._lib.ct_pool_allocs(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.ct_pool_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def murmur3_strings(values: np.ndarray, seed: int = 0) -> np.ndarray:
    """MurmurHash3_x86_32 of each string's UTF-8 bytes (reference
    util/murmur3.cpp). Uses the native batch only when the library is
    already loaded (no g++ build on the join and groupby path); the Python
    twin ``_murmur3_32_py`` (ops/hash.py ``murmur3_bytes``) gives the same
    bits, so shuffle routing agrees across processes whichever path each
    one took."""
    enc = [str(s).encode("utf-8") for s in values]
    lib = get_lib_if_loaded()
    if lib is None:
        return np.array([_murmur3_32_py(b, seed) for b in enc], np.uint32)
    offsets = np.zeros(len(enc) + 1, np.int64)
    np.cumsum([len(b) for b in enc], out=offsets[1:])
    out = np.empty(len(enc), np.uint32)
    lib.ct_murmur3_batch(
        b"".join(enc), offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(enc), seed, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
    )
    return out


class NativeColumn:
    """One parsed column: numpy data (+valid mask, +sorted dictionary)."""

    __slots__ = ("name", "ctype", "data", "valid", "dictionary")

    def __init__(self, name, ctype, data, valid, dictionary):
        self.name = name
        self.ctype = ctype
        self.data = data
        self.valid = valid
        self.dictionary = dictionary


def read_csv(
    path: str,
    delimiter: str = ",",
    skip_rows: int = 0,
    has_header: bool = True,
    num_threads: int = 0,
) -> List[NativeColumn]:
    """Parse a CSV file with the native codec. Raises on parse error."""
    lib = get_lib()
    h = lib.ct_csv_read(
        str(path).encode(), delimiter.encode(), skip_rows, int(has_header), num_threads
    )
    try:
        err = lib.ct_csv_error(h)
        if err:
            raise ValueError(f"native csv read failed: {err.decode()}")
        nrows = lib.ct_csv_nrows(h)
        out: List[NativeColumn] = []
        for i in range(lib.ct_csv_ncols(h)):
            name = lib.ct_csv_colname(h, i).decode()
            ctype = lib.ct_csv_coltype(h, i)
            if ctype == CT_INT64:
                src, dt = lib.ct_csv_data_i64(h, i), np.int64
            elif ctype == CT_FLOAT64:
                src, dt = lib.ct_csv_data_f64(h, i), np.float64
            elif ctype == CT_BOOL:
                src, dt = lib.ct_csv_data_bool(h, i), np.uint8
            else:
                src, dt = lib.ct_csv_data_codes(h, i), np.int32
            data = np.ctypeslib.as_array(src, shape=(nrows,)).copy() if nrows else np.empty(0, dt)
            if ctype == CT_BOOL:
                data = data.astype(bool)
            vptr = lib.ct_csv_valid(h, i)
            valid = (np.ctypeslib.as_array(vptr, shape=(nrows,)).astype(bool)
                     if vptr and nrows else None)
            dictionary = None
            if ctype == CT_STRING:
                dptr = lib.ct_csv_dict(h, i)
                dictionary = np.array([dptr[j].decode() for j in range(lib.ct_csv_dict_size(h, i))],
                                      dtype=str)
            out.append(NativeColumn(name, ctype, data, valid, dictionary))
        return out
    finally:
        lib.ct_csv_free(h)


def write_csv(
    path: str,
    names: List[str],
    columns: List[Tuple[int, np.ndarray, Optional[np.ndarray], Optional[np.ndarray]]],
    delimiter: str = ",",
) -> None:
    """Write columns to CSV. Each column: (ctype, data, valid, dictionary)."""
    lib = get_lib()
    ncols = len(names)
    nrows = len(columns[0][1]) if ncols else 0
    c_names = (ctypes.c_char_p * ncols)(*[n.encode() for n in names])
    c_types = (ctypes.c_int32 * ncols)(*[c[0] for c in columns])
    keep = []  # keep numpy buffers + dict arrays alive
    c_data = (ctypes.c_void_p * ncols)()
    c_valid = (ctypes.c_void_p * ncols)()
    c_dicts = (ctypes.c_void_p * ncols)()
    for i, (ctype, data, valid, dictionary) in enumerate(columns):
        want = {CT_INT64: np.int64, CT_FLOAT64: np.float64,
                CT_BOOL: np.uint8, CT_STRING: np.int32}[ctype]
        arr = np.ascontiguousarray(data, dtype=want)
        keep.append(arr)
        c_data[i] = arr.ctypes.data_as(ctypes.c_void_p)
        if valid is not None:
            v = np.ascontiguousarray(valid, dtype=np.uint8)
            keep.append(v)
            c_valid[i] = v.ctypes.data_as(ctypes.c_void_p)
        if ctype == CT_STRING:
            entries = [str(s).encode() for s in (dictionary if dictionary is not None else [])]
            darr = (ctypes.c_char_p * max(len(entries), 1))(*entries)
            keep.append(darr)
            c_dicts[i] = ctypes.cast(darr, ctypes.c_void_p)
    rc = lib.ct_csv_write(
        str(path).encode(), delimiter.encode(), nrows, ncols,
        c_names, c_types, c_data,
        ctypes.cast(c_valid, ctypes.POINTER(ctypes.c_void_p)),
        ctypes.cast(c_dicts, ctypes.POINTER(ctypes.c_void_p)),
    )
    if rc != 0:
        raise IOError(f"native csv write failed (rc={rc})")


def dict_union(a: np.ndarray, b: np.ndarray):
    """Merge-union of two SORTED unique numpy unicode arrays through the
    native two-pointer merge (runtime.cpp ct_dict_union_u32): O(Da+Db)
    against np.union1d's concatenation and sort. Returns (union, map_a,
    map_b), or None where the arrays are not plain native-order 'U' (the
    merge compares raw UCS4 words) or the library is off. Below 100,000
    entries it uses the library only when already loaded, as
    :func:`murmur3_strings` does."""
    if a.dtype.kind != "U" or b.dtype.kind != "U":
        return None
    if any(
        d.byteorder not in ("=", "|")
        and d.byteorder != ("<" if sys.byteorder == "little" else ">")
        for d in (a.dtype, b.dtype)
    ):
        return None
    if not enabled():
        return None
    lib = get_lib_if_loaded() if len(a) + len(b) < 100_000 else get_lib()
    if lib is None:
        return None
    da, db = len(a), len(b)
    wa = max(a.dtype.itemsize // 4, 1)
    wb = max(b.dtype.itemsize // 4, 1)
    wu = max(wa, wb)
    a_c = np.ascontiguousarray(a)
    b_c = np.ascontiguousarray(b)
    out = np.zeros(max(da + db, 1), dtype=f"<U{wu}")
    map_a = np.empty(max(da, 1), np.int32)
    map_b = np.empty(max(db, 1), np.int32)
    n = lib.ct_dict_union_u32(
        a_c.ctypes.data_as(ctypes.c_void_p), da, wa,
        b_c.ctypes.data_as(ctypes.c_void_p), db, wb,
        out.ctypes.data_as(ctypes.c_void_p), wu,
        map_a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        map_b.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    union = out[:n]
    if n < 0.9 * (da + db):
        # a view would pin the full (da+db)-slot buffer; copy when the
        # slack is material
        union = union.copy()
    return union, map_a[:da], map_b[:db]
