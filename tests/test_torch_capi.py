"""The port's C ABI (cylon_tpu_torch/native/capi.cpp, the Java/JNI
binding's analog) on the CPU: both C programs of native/examples run as
programs of their own (dlopen, the embedded interpreter) with
CYLON_TPU_TORCH_PLATFORM=cpu, and their results equal the same calls made
through the JAX package (``cylon_tpu``, as its own C ABI makes them) and
through the port's Python API on the same CSVs: the joined, sorted and
projected table written by ``capi_client.c``, the counts
``java_abi_harness.c`` prints and the join it writes. Then the in-process
ctypes calls: every marshalled argument (the join's ``how`` and
distributed flag, the sort column, the project list, the partition count
and each partition's rows, the callbacks of select, filter and map)
against the JAX package's call, the raw-buffer table of
tests/test_native_runtime.py, and ``ct_api_init`` without a card and
without that variable, which fails with the card error.

Skips only where gcc or libpython is missing, as the JAX package's tests
do.
"""
import ctypes
import os
import shutil
import subprocess
import sys
import sysconfig

import numpy as np
import pytest
import torch

import cylon_tpu as ct
import cylon_tpu_torch as ctt
from cylon_tpu_torch import native
from test_torch_shuffle_slice import _contexts
import _torch_jax_native as J

torch.set_num_threads(1)
J.load_jax_native()  # one xdist worker's first build at a time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def capi():
    """The built C ABI, or a skip where gcc or libpython is missing."""
    if shutil.which("g++") is None or shutil.which("gcc") is None:
        pytest.skip("no gcc")
    try:
        return native.build_capi()
    except RuntimeError as e:
        pytest.skip(f"capi build failed (no libpython?): {str(e)[-300:]}")


def _build_client(tmp_path, name):
    exe = str(tmp_path / name)
    r = subprocess.run(["gcc", "-O2", str(native.HERE / "examples" / f"{name}.c"), "-o", exe,
                        "-ldl"], capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    return exe


def client_env(platform="cpu"):
    """The port and the running interpreter's packages on PYTHONPATH,
    libpython's directory on LD_LIBRARY_PATH (tests/test_capi_client.py's
    environment)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([ROOT] + [p for p in sys.path if p and p != ROOT])
    env.pop("CYLON_TPU_TORCH_PLATFORM", None)
    if platform:
        env["CYLON_TPU_TORCH_PLATFORM"] = platform
    env["LD_LIBRARY_PATH"] = os.pathsep.join(
        filter(None, [sysconfig.get_config_var("LIBDIR") or "", env.get("LD_LIBRARY_PATH", "")]))
    return env


def _sides(tmp_path, seed, n_l, n_r, keys):
    rng = np.random.default_rng(seed)
    left = {"k": rng.integers(0, keys, n_l), "x": rng.normal(size=n_l)}
    right = {"k": rng.integers(0, keys, n_r), "y": rng.normal(size=n_r)}
    ctx = ctt.CylonContext.init_distributed(ctt.GPUConfig(device="cpu"))
    paths = []
    for name, cols in (("l", left), ("r", right)):
        paths.append(str(tmp_path / f"{name}.csv"))
        ctt.write_csv(ctt.Table.from_pydict(ctx, cols), paths[-1])
    return ctx, paths


def test_c_client_equals_the_python_api(tmp_path, capi):
    ctx, (lp, rp) = _sides(tmp_path, 5, 200, 150, 20)
    exe = _build_client(tmp_path, "capi_client")
    out = str(tmp_path / "out.csv")
    res = subprocess.run([exe, capi, lp, rp, out], capture_output=True, text=True, timeout=300,
                         env=client_env())
    assert res.returncode == 0, f"stdout={res.stdout}\nstderr={res.stderr[-2000:]}"
    jctx = _contexts(1)[0]
    J.require_jax_native()
    jwant = (ct.read_csv(jctx, lp).distributed_join(ct.read_csv(jctx, rp), on="k", how="inner")
             .distributed_sort("k_x").project(["k_x", "x", "y"]))
    ct.write_csv(jwant, str(tmp_path / "jax.csv"))
    assert f"rows={jwant.row_count} cols=3" in res.stdout
    assert open(out, "rb").read() == (tmp_path / "jax.csv").read_bytes()
    want = (ctt.read_csv(ctx, lp).distributed_join(ctt.read_csv(ctx, rp), on="k", how="inner")
            .distributed_sort("k_x").project(["k_x", "x", "y"]))
    ctt.write_csv(want, str(tmp_path / "want.csv"))
    assert open(out, "rb").read() == (tmp_path / "want.csv").read_bytes()


def _harness_counts(mod, ctx, lp, rp, tmp_path, tag):
    """The calls java_abi_harness.c makes, through ``mod`` (cylon_tpu or
    cylon_tpu_torch): its printed counts, and its sorted join written to
    ``<tag>.csv``."""
    lt, rt = mod.read_csv(ctx, lp), mod.read_csv(ctx, rp)
    join = lt.distributed_join(rt, on="k", how="inner").distributed_sort("k_x")
    mod.write_csv(join, str(tmp_path / f"{tag}.csv"))
    even = np.asarray(lt.to_pydict()["k"]) % 2 == 0
    sel = lt.filter(even)
    mapped = mod.Table.from_pydict(ctx, {"k": np.array(
        [f"v{x}" for x in lt.to_pydict()["k"]], object)})
    parts = lt.hash_partition(["k"], 4)
    return {"join_rows": str(join.row_count), "join_cols": str(join.column_count),
            "select_rows": str(sel.row_count), "filter_rows": str(sel.row_count),
            "map_rows": str(mapped.row_count),
            "partition_total": str(sum(p.row_count for p in parts.values())),
            "merge_rows": str(mod.concat(list(parts.values())).row_count), "ok": "1"}


def test_java_abi_harness_equals_the_python_api(tmp_path, capi):
    ctx, (lp, rp) = _sides(tmp_path, 11, 240, 180, 30)
    exe = _build_client(tmp_path, "java_abi_harness")
    out = str(tmp_path / "out.csv")
    res = subprocess.run([exe, capi, lp, rp, out], capture_output=True, text=True, timeout=300,
                         env=client_env())
    assert res.returncode == 0, f"stdout={res.stdout}\nstderr={res.stderr[-2000:]}"
    got = dict(line.split("=", 1) for line in res.stdout.splitlines()
               if "=" in line and not line.startswith("Table("))
    J.require_jax_native()
    assert got == _harness_counts(ct, _contexts(1)[0], lp, rp, tmp_path, "jax")
    assert open(out, "rb").read() == (tmp_path / "jax.csv").read_bytes()
    assert got == _harness_counts(ctt, ctx, lp, rp, tmp_path, "want")
    assert open(out, "rb").read() == (tmp_path / "want.csv").read_bytes()


def _bind(lib):
    c = ctypes
    lib.ct_api_init.restype = c.c_int
    lib.ct_api_last_error.restype = c.c_char_p
    lib.ct_api_read_csv.restype = c.c_int64
    lib.ct_api_read_csv.argtypes = [c.c_char_p]
    lib.ct_api_join.restype = c.c_int64
    lib.ct_api_join.argtypes = [c.c_int64, c.c_int64, c.c_char_p, c.c_char_p, c.c_int]
    lib.ct_api_row_count.restype = c.c_int64
    lib.ct_api_row_count.argtypes = [c.c_int64]
    lib.ct_api_column_count.restype = c.c_int32
    lib.ct_api_column_count.argtypes = [c.c_int64]
    lib.ct_api_write_csv.restype = c.c_int
    lib.ct_api_write_csv.argtypes = [c.c_int64, c.c_char_p]
    lib.ct_api_release.argtypes = [c.c_int64]
    lib.ct_api_table_from_columns.restype = c.c_int64
    lib.ct_api_table_from_columns.argtypes = [
        c.c_int32, c.POINTER(c.c_char_p), c.POINTER(c.c_int32), c.POINTER(c.c_void_p), c.c_int64]
    lib.ct_api_sort.restype = c.c_int64
    lib.ct_api_sort.argtypes = [c.c_int64, c.c_char_p, c.c_int]
    lib.ct_api_project.restype = c.c_int64
    lib.ct_api_project.argtypes = [c.c_int64, c.c_char_p]
    lib.ct_api_select.restype = c.c_int64
    lib.ct_api_select.argtypes = [c.c_int64, ROW_PRED, c.c_void_p]
    lib.ct_api_filter_column.restype = c.c_int64
    lib.ct_api_filter_column.argtypes = [c.c_int64, c.c_int32, VAL_PRED, c.c_void_p]
    lib.ct_api_map_column.restype = c.c_int64
    lib.ct_api_map_column.argtypes = [c.c_int64, c.c_int32, VAL_MAP, c.c_void_p]
    lib.ct_api_hash_partition.restype = c.c_int
    lib.ct_api_hash_partition.argtypes = [c.c_int64, c.c_char_p, c.c_int32,
                                          c.POINTER(c.c_int64)]
    lib.ct_api_merge.restype = c.c_int64
    lib.ct_api_merge.argtypes = [c.POINTER(c.c_int64), c.c_int32]
    return lib


# the callbacks of select, filter_column and map_column (capi.cpp's typedefs)
ROW_PRED = ctypes.CFUNCTYPE(ctypes.c_int32, ctypes.c_int64, ctypes.c_char_p, ctypes.c_void_p)
VAL_PRED = ctypes.CFUNCTYPE(ctypes.c_int32, ctypes.c_char_p, ctypes.c_void_p)
VAL_MAP = ctypes.CFUNCTYPE(ctypes.c_int32, ctypes.c_char_p, ctypes.POINTER(ctypes.c_char),
                           ctypes.c_int32, ctypes.c_void_p)


@pytest.fixture
def inproc(capi, monkeypatch):
    """The C ABI loaded into this process on the CPU context; shut down
    after the test, so the next ``ct_api_init`` makes a new context."""
    monkeypatch.setenv("CYLON_TPU_TORCH_PLATFORM", "cpu")
    lib = _bind(ctypes.CDLL(capi))
    yield lib
    lib.ct_api_shutdown()


def test_capi_round_trip_in_process(tmp_path, inproc):
    lib = inproc
    ctx, (lp, rp) = _sides(tmp_path, 3, 40, 30, 6)
    assert lib.ct_api_init() == 0, lib.ct_api_last_error().decode()
    hl, hr = lib.ct_api_read_csv(lp.encode()), lib.ct_api_read_csv(rp.encode())
    assert hl and hr, lib.ct_api_last_error().decode()
    hj = lib.ct_api_join(hl, hr, b"k", b"inner", 0)
    assert hj, lib.ct_api_last_error().decode()
    want = ctt.read_csv(ctx, lp).join(ctt.read_csv(ctx, rp), on="k", how="inner")
    assert lib.ct_api_row_count(hj) == want.row_count
    assert lib.ct_api_column_count(hj) == 4
    out = str(tmp_path / "out.csv")
    assert lib.ct_api_write_csv(hj, out.encode()) == 0
    ctt.write_csv(want, str(tmp_path / "want.csv"))
    assert open(out, "rb").read() == (tmp_path / "want.csv").read_bytes()
    # bad input surfaces an error, not a crash
    assert lib.ct_api_join(hj, 999999, b"k", b"inner", 0) == 0
    assert b"handle" in lib.ct_api_last_error()
    for h in (hl, hr, hj):
        lib.ct_api_release(h)


def _abi_calls(lib):
    """Each case: the C ABI's calls on the handles of the two CSVs (the
    tables they give, in order), and the same calls through a package's
    Python API ``mod`` on its tables ``lt``, ``rt``."""
    keep_odd_row = ROW_PRED(lambda row, csv, user: row % 2)
    x_pos = VAL_PRED(lambda v, user: float(v) > 0)

    def tag(v, out, cap, user):
        b = b"v" + v
        ctypes.memmove(out, b, len(b))
        return len(b)

    v_tag = VAL_MAP(tag)

    def parts(h, k):
        out = (ctypes.c_int64 * k)()
        assert lib.ct_api_hash_partition(h, b"k", k, out) == 0, lib.ct_api_last_error()
        return list(out)

    def merge(hs):
        return lib.ct_api_merge((ctypes.c_int64 * len(hs))(*hs), len(hs))

    return {
        "join_left_local": (lambda hl, hr: [lib.ct_api_join(hl, hr, b"k", b"left", 0)],
                            lambda mod, lt, rt: [lt.join(rt, on="k", how="left")]),
        "join_outer_distributed": (
            lambda hl, hr: [lib.ct_api_join(hl, hr, b"k", b"outer", 1)],
            lambda mod, lt, rt: [lt.distributed_join(rt, on="k", how="outer")]),
        "sort": (lambda hl, hr: [lib.ct_api_sort(hl, b"x", 0), lib.ct_api_sort(hr, b"k", 1)],
                 lambda mod, lt, rt: [lt.sort("x"), rt.distributed_sort("k")]),
        "project": (lambda hl, hr: [lib.ct_api_project(hl, b"x,k")],
                    lambda mod, lt, rt: [lt.project(["x", "k"])]),
        "hash_partition": (lambda hl, hr: parts(hl, 3) + [merge(parts(hr, 4))],
                           lambda mod, lt, rt: [*lt.hash_partition(["k"], 3).values(), mod.concat(
                               list(rt.hash_partition(["k"], 4).values()))]),
        "select_filter_map": (
            lambda hl, hr: [lib.ct_api_select(hl, keep_odd_row, None),
                            lib.ct_api_filter_column(hl, 1, x_pos, None),
                            lib.ct_api_map_column(hr, 0, v_tag, None)],
            lambda mod, lt, rt: [
                lt.filter(np.arange(lt.row_count) % 2 == 1),
                lt.filter(np.asarray(lt.to_pydict()["x"]) > 0),
                mod.Table.from_pydict(lt.ctx, {
                    "k": np.array([f"v{v}" for v in rt.to_pydict()["k"]], object)})]),
    }


@pytest.mark.parametrize("case", ["join_left_local", "join_outer_distributed", "sort", "project",
                                  "hash_partition", "select_filter_map"])
def test_capi_calls_equal_the_jax_package(tmp_path, inproc, case):
    """Each ``ct_api_*`` call passes its arguments on with the meaning the
    JAX package's C ABI gives them: the tables it returns, written by
    ``ct_api_write_csv``, equal byte for byte the same calls' tables made
    through ``cylon_tpu`` and written by its writer."""
    lib = inproc
    _ctx, (lp, rp) = _sides(tmp_path, 8, 60, 50, 40)  # keys on one side only
    assert lib.ct_api_init() == 0, lib.ct_api_last_error().decode()
    hl, hr = lib.ct_api_read_csv(lp.encode()), lib.ct_api_read_csv(rp.encode())
    abi, py = _abi_calls(lib)[case]
    handles = abi(hl, hr)
    jctx = _contexts(1)[0]
    J.require_jax_native()
    want = py(ct, ct.read_csv(jctx, lp), ct.read_csv(jctx, rp))
    assert len(handles) == len(want)
    for i, (h, w) in enumerate(zip(handles, want)):
        assert h, lib.ct_api_last_error().decode()
        got_p, want_p = str(tmp_path / f"got{i}.csv"), str(tmp_path / f"want{i}.csv")
        assert lib.ct_api_write_csv(h, got_p.encode()) == 0, lib.ct_api_last_error().decode()
        ct.write_csv(w, want_p)
        assert open(got_p, "rb").read() == open(want_p, "rb").read(), f"{case}: table {i}"
        lib.ct_api_release(h)
    for h in (hl, hr):
        lib.ct_api_release(h)


def test_capi_table_from_raw_buffers(tmp_path, inproc):
    lib = inproc
    assert lib.ct_api_init() == 0, lib.ct_api_last_error().decode()
    n = 1000
    a = np.arange(n, dtype=np.int64)
    b = np.sqrt(np.arange(n, dtype=np.float64))
    c = np.arange(n) % 3 == 0
    names = (ctypes.c_char_p * 3)(b"a", b"b", b"flag")
    types = (ctypes.c_int32 * 3)(0, 1, 2)
    bufs = (ctypes.c_void_p * 3)(a.ctypes.data, b.ctypes.data, c.ctypes.data)
    h = lib.ct_api_table_from_columns(3, names, types, bufs, n)
    assert h, lib.ct_api_last_error().decode()
    assert lib.ct_api_row_count(h) == n and lib.ct_api_column_count(h) == 3
    out = str(tmp_path / "buf.csv")
    assert lib.ct_api_write_csv(h, out.encode()) == 0
    ctx = ctt.CylonContext.init_distributed(ctt.GPUConfig(device="cpu"))
    got = ctt.read_csv(ctx, out).to_pydict()
    np.testing.assert_array_equal(got["a"], a)
    np.testing.assert_array_equal(got["b"], b)  # shortest round-trip doubles: exact
    np.testing.assert_array_equal(got["flag"], c)
    lib.ct_api_release(h)
    types_bad = (ctypes.c_int32 * 3)(0, 9, 2)
    assert lib.ct_api_table_from_columns(3, names, types_bad, bufs, n) == 0
    assert b"type tag" in lib.ct_api_last_error()


def test_capi_init_needs_a_card_unless_cpu_is_asked(capi, monkeypatch):
    """Without CYLON_TPU_TORCH_PLATFORM the context is GPUConfig() on
    cuda:0: with no card, ct_api_init fails with the card error."""
    monkeypatch.delenv("CYLON_TPU_TORCH_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lib = _bind(ctypes.CDLL(capi))
    lib.ct_api_shutdown()  # no context left from an earlier test
    try:
        assert lib.ct_api_init() == 1
        assert b"no CUDA device" in lib.ct_api_last_error()
        monkeypatch.setenv("CYLON_TPU_TORCH_PLATFORM", "cpu")
        assert lib.ct_api_init() == 0, lib.ct_api_last_error().decode()
    finally:
        lib.ct_api_shutdown()
