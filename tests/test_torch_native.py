"""The port's native runtime (cylon_tpu_torch/native: its copies of the JAX
package's csv.cpp and runtime.cpp) against the JAX package's on the CPU:
the CSV codec column for column (data, validity, type code, dictionary)
on seeded files, the arena pool's statistics, murmur3 over strings and
the sorted dictionary union. Every comparison is exact. A failed g++
build raises with the compiler's output, and the kill switch
CYLON_TPU_TORCH_NO_NATIVE=1 turns the library off.
"""
import shutil

import numpy as np
import pytest
import torch

from cylon_tpu import native as jnative
from cylon_tpu import table as jtable
from cylon_tpu_torch import native
from cylon_tpu_torch import table as ttable
from cylon_tpu_torch.ops.hash import hash_dictionary_host, murmur3_bytes

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _gxx():
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native runtime cannot build")


def _quoted(s):
    return '"' + s.replace('"', '""') + '"' if any(c in s for c in ',;"') else s


def _write_mixed(path, rng, n, sep=",", header=True, junk=0, quotes=True):
    """ints, floats, bools and strings (quoted where they hold the
    delimiter or a quote), about 10% of the fields empty (nulls)."""
    words = ["ant", "bee", "cat,dog", 'say "hi"', "eel;fox", "gnu"] if quotes else [
        "ant", "bee", "cat", "dog", "eel"]
    lines = [f"junk line {i}" for i in range(junk)]
    if header:
        lines.append(sep.join(["i", "f", "b", "s"]))
    for r in range(n):
        row = [str(int(rng.integers(-10**12, 10**12))), repr(float(rng.normal())),
               ["true", "false"][int(rng.integers(2))], _quoted(str(rng.choice(words)))]
        row = ["" if rng.random() < 0.1 else x for x in row]
        lines.append(sep.join(row))
    path.write_text("\n".join(lines) + "\n")


CASES = {
    "plain": ({}, {}),
    "skip_rows": ({"junk": 3}, {"skip_rows": 3}),
    "semicolon": ({"sep": ";"}, {"delimiter": ";"}),
    "no_header": ({"header": False}, {"has_header": False}),
    "threads": ({"quotes": False}, {"num_threads": 4}),  # > 1 MiB: split over threads
    "one_thread": ({"quotes": False}, {"num_threads": 1}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_read_csv_equals_the_jax_codec(tmp_path, case):
    fmt, kw = CASES[case]
    rng = np.random.default_rng(3)
    n = 30_000 if kw.get("num_threads", 0) > 1 else 400  # past 1 MiB: the threaded tokenizer
    path = tmp_path / "t.csv"
    _write_mixed(path, rng, n, **fmt)
    got, want = native.read_csv(str(path), **kw), jnative.read_csv(str(path), **kw)
    assert [c.name for c in got] == [c.name for c in want]
    assert [c.ctype for c in got] == [c.ctype for c in want] == [
        native.CT_INT64, native.CT_FLOAT64, native.CT_BOOL, native.CT_STRING]
    for g, w in zip(got, want):
        assert g.data.dtype == w.data.dtype and g.data.tobytes() == w.data.tobytes(), g.name
        assert (g.valid is None) == (w.valid is None), g.name
        if w.valid is not None:
            np.testing.assert_array_equal(g.valid, w.valid)
            assert not w.valid.all()  # the empty fields are nulls
        if w.dictionary is not None:
            assert g.dictionary.tolist() == w.dictionary.tolist()
            assert g.dictionary.tolist() == sorted(g.dictionary.tolist())
    assert len(got[0].data) == n


def test_write_csv_equals_the_jax_writer(tmp_path):
    rng = np.random.default_rng(4)
    n = 300
    cols = [
        (native.CT_INT64, rng.integers(-10**15, 10**15, n), rng.random(n) > 0.1, None),
        (native.CT_FLOAT64, rng.normal(size=n) * 1e6, None, None),
        (native.CT_BOOL, rng.random(n) < 0.5, rng.random(n) > 0.2, None),
        (native.CT_STRING, rng.integers(0, 3, n).astype(np.int32), None,
         np.array(["a,b", 'q"x', "plain"])),
    ]
    names = ["i", "f", "b", "s"]
    for sep in (",", "|"):
        native.write_csv(str(tmp_path / "t.csv"), names, cols, delimiter=sep)
        jnative.write_csv(str(tmp_path / "j.csv"), names, cols, delimiter=sep)
        assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()


def test_pool_alloc_reset_stats():
    """The JAX package's sequence (tests/test_native_runtime.py)."""
    pool = native.MemoryPool(block_bytes=4096)
    a = pool.alloc_array((100,), np.int64)
    a[:] = np.arange(100)
    assert a.sum() == 4950
    b = pool.alloc_array((8, 4), np.float64)
    b[:] = 1.5
    assert pool.alloc_count == 2
    assert pool.bytes_in_use >= 100 * 8 + 8 * 4 * 8
    peak1 = pool.bytes_peak
    pool.reset()
    assert pool.bytes_in_use == 0
    assert pool.bytes_peak == peak1
    reserved = pool.bytes_reserved
    c = pool.alloc_array((100,), np.int64)
    c[:] = 7
    assert pool.bytes_reserved == reserved  # the same arena, no growth
    ref = jnative.MemoryPool(block_bytes=4096)
    for shape, dt in (((100,), np.int64), ((8, 4), np.float64)):
        ref.alloc_array(shape, dt)
    ref.reset()
    ref.alloc_array((100,), np.int64)
    assert (pool.alloc_count, pool.bytes_in_use, pool.bytes_peak, pool.bytes_reserved) == (
        ref.alloc_count, ref.bytes_in_use, ref.bytes_peak, ref.bytes_reserved)
    pool.close()
    ref.close()


def test_pool_oversized_block():
    pool = native.MemoryPool(block_bytes=256)
    big = pool.alloc_array((10000,), np.int64)  # far above the block size
    big[:] = 3
    small = pool.alloc_array((4,), np.int32)
    small[:] = 9
    assert big.sum() == 30000 and small.sum() == 36
    pool.close()


def test_murmur3_known_vectors_and_twins():
    """MurmurHash3_x86_32's public vectors; the batch, the Python twin and
    the JAX package's give the same bits."""
    lib = native.get_lib()
    assert lib.ct_murmur3_32(b"", 0, 0) == 0
    assert lib.ct_murmur3_32(b"", 0, 1) == 0x514E28B7
    assert lib.ct_murmur3_32(b"abc", 3, 0) == 0xB3DD93FA
    assert lib.ct_murmur3_32(b"Hello, world!", 13, 1234) == 0xFAF6CDB3
    vals = np.array(["ant", "bee", "", "a much longer string value", "ünï", "x" * 37])
    got = native.murmur3_strings(vals)
    assert got.dtype == np.uint32
    assert got.tolist() == [murmur3_bytes(s.encode()) for s in vals]
    assert got.tolist() == jnative.murmur3_strings(vals).tolist()
    assert got.tolist() == [jnative._murmur3_32_py(s.encode()) for s in vals]
    assert native.murmur3_strings(vals, seed=7).tolist() == [
        lib.ct_murmur3_32(s.encode(), len(s.encode()), 7) for s in vals]
    assert hash_dictionary_host(vals).tolist() == got.tolist()


def test_murmur3_without_the_library_takes_the_twin(monkeypatch):
    """Before the library is loaded (and under the kill switch) the Python
    twin answers, with the same bits: no g++ build on a join's path."""
    vals = np.array(["k0", "k1", "segment"])
    want = native.murmur3_strings(vals)
    monkeypatch.setattr(native, "_lib_handle", None)
    assert native.get_lib_if_loaded() is None
    assert native.murmur3_strings(vals).tolist() == want.tolist()
    assert native._lib_handle is None  # nothing was built or loaded
    monkeypatch.setenv("CYLON_TPU_TORCH_NO_NATIVE", "1")
    assert hash_dictionary_host(vals).tolist() == want.tolist()


@pytest.mark.parametrize("na,nb", [(0, 5), (7, 0), (50, 80), (200_000, 3)])
def test_dict_union_equals_union1d(na, nb):
    rng = np.random.default_rng(na + nb)
    words = np.array([f"w{i:06d}{'é' * (i % 3)}" for i in range(na + nb + 50)])
    a = np.unique(rng.choice(words, na)) if na else np.array([], dtype="<U1")
    b = np.unique(rng.choice(words, nb)) if nb else np.array([], dtype="<U1")
    native.get_lib()
    union, map_a, map_b = native.dict_union(a, b)
    want = np.union1d(a, b)
    assert union.tolist() == want.tolist()
    np.testing.assert_array_equal(map_a, np.searchsorted(want, a))
    np.testing.assert_array_equal(map_b, np.searchsorted(want, b))
    jgot = jnative.dict_union(a, b)
    assert jgot is None or jgot[0].tolist() == union.tolist()


@pytest.mark.parametrize("merge", ["native", "union1d"])
def test_unify_encoded_shards_equals_the_jax_unification(monkeypatch, merge):
    """The port's unification folds the shards' dictionaries through
    ``native.dict_union`` where the library is loaded, and through
    ``np.union1d`` under the kill switch; either way it gives the JAX
    package's dictionaries and codes."""
    from cylon_tpu.dtypes import DataType as JDataType, Type as JType
    from cylon_tpu_torch.dtypes import DataType, Type

    if merge == "native":
        native.get_lib()
    else:
        monkeypatch.setenv("CYLON_TPU_TORCH_NO_NATIVE", "1")
    merged = []
    real = native.dict_union

    def spy(a, b):
        merged.append(real(a, b))
        return merged[-1]

    monkeypatch.setattr(native, "dict_union", spy)
    rng = np.random.default_rng(9)
    words = np.array([f"s{i:03d}" for i in range(300)])

    def shards(dt):
        out = []
        for s in range(4):
            vals = rng.choice(words[s * 50: s * 50 + 120], 200)
            d, codes = np.unique(vals, return_inverse=True)
            out.append({"s": (codes.astype(np.int32), None, dt, d)})
        return out

    mine = shards(DataType(Type.STRING))
    rng = np.random.default_rng(9)
    ref = shards(JDataType(JType.STRING))
    ttable.unify_encoded_shards(mine)
    jtable.unify_encoded_shards(ref)
    assert len(merged) == 3  # one fold a shard after the first
    assert all((m is not None) == (merge == "native") for m in merged)
    for g, w in zip(mine, ref):
        assert g["s"][3].tolist() == w["s"][3].tolist()
        np.testing.assert_array_equal(g["s"][0], w["s"][0])


def test_write_csv_stages_through_the_context_pool(tmp_path):
    """The native writer carves its typed staging copies (int32 -> int64,
    float32 -> float64) from the context's pool, resets it at each write
    and reuses its blocks; the bytes equal the JAX package's writer."""
    import cylon_tpu as ct
    import cylon_tpu_torch as ctt
    from test_torch_shuffle_slice import _contexts, _encode

    jctx, ctx = _contexts(1)
    rng = np.random.default_rng(4)
    enc = _encode({"k": rng.integers(-9, 9, 3000).astype(np.int32),
                   "x": rng.normal(size=3000).astype(np.float32)})
    t = ctt.Table.from_encoded(ctx, enc)
    pool = ctx.memory_pool
    pool.reset()
    allocs = pool.alloc_count
    ctt.write_csv(t, str(tmp_path / "a.csv"))
    assert pool.alloc_count == allocs + 2  # one staging copy a column
    in_use, reserved = pool.bytes_in_use, pool.bytes_reserved
    assert in_use >= 3000 * 16
    ctt.write_csv(t, str(tmp_path / "b.csv"))
    assert (pool.bytes_in_use, pool.bytes_reserved) == (in_use, reserved)
    ct.write_csv(ct.Table.from_encoded(jctx, enc), str(tmp_path / "j.csv"))
    want = (tmp_path / "j.csv").read_bytes()
    assert (tmp_path / "a.csv").read_bytes() == (tmp_path / "b.csv").read_bytes() == want


def test_a_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("int broken( { return 0; }\n")
    monkeypatch.setattr(native, "SOURCES", (bad,))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib_handle", None)
    with pytest.raises(RuntimeError, match=r"g\+\+ failed to build(.|\n)*broken\.cpp"):
        native.get_lib()
    assert native._lib_handle is None


def test_kill_switch_turns_the_library_off(monkeypatch):
    import cylon_tpu_torch as ctt

    native.get_lib()
    monkeypatch.setenv("CYLON_TPU_TORCH_NO_NATIVE", "1")
    assert not native.enabled() and not native.available()
    assert native.get_lib_if_loaded() is None
    a = np.array(["a", "c"])
    assert native.dict_union(a, np.array(["b"])) is None
    ctx = ctt.CylonContext.init_distributed(ctt.GPUConfig(device="cpu"))
    assert ctx.memory_pool is None
    monkeypatch.delenv("CYLON_TPU_TORCH_NO_NATIVE")
    pool = ctx.memory_pool
    assert pool is ctx.memory_pool and pool.bytes_in_use == 0
