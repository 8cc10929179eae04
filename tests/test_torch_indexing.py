"""The port's indexing against the JAX package on the CPU:
``set_index`` / ``reset_index`` / ``index`` / ``get_index``, ``loc`` (one
label, a list of labels with missing and repeated ones, an inclusive
slice, a bool mask, with a column selection; numeric and string
indexes), ``iloc`` (a position, a slice with a step, a list, negative
positions, a bool mask) over global row numbers across the shards,
``build_index`` (HashIndex, LinearIndex), ``encode_lookup_values``, the
DataFrame's ``loc`` / ``iloc``, and ``concat(axis=1)`` on an index column
and on the RangeIndex for every join, fed one host encoding made with
numpy from a fixed seed, at worlds 1 and 4.

Every comparison is exact, shard by shard and in order (``loc`` lists and
``iloc`` lists that reorder go through ``take``, whose output splits
evenly over the shards in both packages).
"""
import numpy as np
import pytest
import torch

import cylon_tpu as ct
import cylon_tpu_torch as ctt
from cylon_tpu.indexing import index as jindex
from cylon_tpu_torch.indexing import index as tindex
from test_torch_compute import both, tables_equal
from test_torch_shuffle_slice import NO_TIERS

torch.set_num_threads(1)


@pytest.fixture
def ref_env(monkeypatch):
    for k in NO_TIERS:
        monkeypatch.setenv(k, "1")


def _cols(rng, n):
    k = rng.integers(0, 40, n).astype(np.int64)
    s = rng.choice(["ant", "bee", "cat", "eel", "fox"], n).astype(object)
    s[rng.random(n) < 0.1] = None  # null index entries never match
    x = rng.normal(size=n)
    x[rng.random(n) < 0.1] = np.nan
    return {"k": k, "s": s, "x": x, "i": np.arange(n, dtype=np.int32)}


@pytest.mark.parametrize("world", [1, 4])
def test_loc_matches_reference(rng, world):
    jt, tt = both(world, _cols(rng, 160))
    jk, tk = jt.set_index("k"), tt.set_index("k")
    assert tk.index_name == "k" and tk.index.name == "k" and tk.get_index().name == "k"
    assert tk.reset_index().index.is_range() and tk.reset_index().index.size == 160
    for rows in (
        7, [3, 99, 7, 3, 12], [], [-1], slice(5, 17), slice(None, 9), slice(30, None),
        slice(4.5, 10.2), (slice(2, 8), ["x", "i"]), ([5, 5], "x"),
        np.arange(160) % 5 == 0,
    ):
        tables_equal(jk.loc[rows], tk.loc[rows])
    tables_equal(jk.loc[jk.project(["x"]) > 0], tk.loc[tk.project(["x"]) > 0])
    with pytest.raises(KeyError):
        tk.loc[[3.5]]  # an integer index refuses a label that is not an integer
    with pytest.raises(ValueError):
        tt.loc[3]  # the RangeIndex has no labels
    js, ts = jt.set_index("s"), tt.set_index("s")
    for rows in ("cat", ["eel", "zzz", "ant", "eel"], slice("b", "d"), slice("bee", "eel")):
        tables_equal(js.loc[rows], ts.loc[rows])


@pytest.mark.parametrize("world", [1, 4])
def test_iloc_matches_reference(rng, world):
    jt, tt = both(world, _cols(rng, 150))
    for rows in (
        0, 149, -1, 77, slice(10, 100), slice(None, None, 7), slice(-30, None),
        [0, 5, 9, 140], [9, 0, 9, -1], [], (slice(20, 60), ["s", "x"]),
        [True] * 75 + [False] * 75,
    ):
        tables_equal(jt.iloc[rows], tt.iloc[rows])
    tables_equal(jt.set_index("s").iloc[5:50], tt.set_index("s").iloc[5:50])


def test_built_indexes_match_reference(rng):
    jt, tt = both(1, _cols(rng, 120))
    for kind in ("hash", "linear"):
        jk, tk = jt.set_index("k"), tt.set_index("k")
        ji, ti = jk.build_index(kind), tk.build_index(kind)
        assert tk.build_index(kind) is ti and type(ti).__name__ == type(ji).__name__
        np.testing.assert_array_equal(ti.get_loc(7), ji.get_loc(7))
        assert (7 in ti) == (7 in ji) and (1000 in ti) == (1000 in ji)
        labels = [3, 7, 3] if kind == "linear" else [3, 99, 7, 3]
        np.testing.assert_array_equal(ti.loc_positions(labels), ji.loc_positions(labels))
        tables_equal(jk.loc[labels], tk.loc[labels])
        if kind == "linear":  # a missing label raises in a list lookup
            for idx, t in ((ji, jk), (ti, tk)):
                with pytest.raises(KeyError, match="99"):
                    idx.loc_positions([3, 99])
                with pytest.raises(KeyError):
                    t.loc[[3, 99]]
        # a nullable string index: null entries never match
        js, ts = jt.set_index("s"), tt.set_index("s")
        js_i, ts_i = js.build_index(kind), ts.build_index(kind)
        np.testing.assert_array_equal(ts_i.get_loc("cat"), js_i.get_loc("cat"))
        assert ("zzz" in ts_i) == ("zzz" in js_i) and ("eel" in ts_i) == ("eel" in js_i)
        np.testing.assert_array_equal(ts_i.loc_positions(["eel", "ant", "eel"]),
                                      js_i.loc_positions(["eel", "ant", "eel"]))
        tables_equal(js.loc[["eel", "ant", "eel"]], ts.loc[["eel", "ant", "eel"]])
    for dic, dt, vals in ((np.array(["a", "c"]), np.int32, ["c", "b"]),
                          (None, np.dtype(np.float32), [0.5, 0.1]),
                          (None, np.dtype(np.int64), [3, 4.0])):
        np.testing.assert_array_equal(tindex.encode_lookup_values(dic, dt, vals),
                                      jindex.encode_lookup_values(dic, dt, vals))
    with pytest.raises(KeyError):
        tindex.encode_lookup_values(None, np.dtype(np.int64), [2.5])
    assert tindex.PyRangeIndex(start=2, stop=11, step=3).index.tolist() == [2, 5, 8]


@pytest.mark.parametrize("world,join", [(1, "inner"), (1, "left"), (1, "right"), (1, "outer"),
                                        (4, "outer")])
def test_concat_axis1_matches_reference(rng, ref_env, world, join):
    """On index columns with different key sets (duplicates, misses on both
    sides, a string column in each table), for every join; and, for the
    inner and outer joins, on the RangeIndex (the global row number),
    three tables at once at world 1."""
    a = {"k": rng.permutation(40)[:30].astype(np.int64), "s": rng.choice(["p", "q"], 30).astype(object)}
    b = {"k": rng.integers(10, 50, 25).astype(np.int64), "v": rng.normal(size=25),
         "s": rng.choice(["q", "r"], 25).astype(object)}
    c = {"w": rng.normal(size=30).astype(np.float32)}
    (ja, ta), (jb, tb), (jc_, tc_) = both(world, a), both(world, b), both(world, c)
    dist = world > 1
    tables_equal(ct.Table.concat([ja.set_index("k"), jb.set_index("k")], axis=1, join=join,
                                 distributed=dist),
                 ctt.Table.concat([ta.set_index("k"), tb.set_index("k")], axis=1, join=join,
                                  distributed=dist))
    if join not in ("inner", "outer"):
        return
    # three tables at world 1; two at world 4, one distributed join
    rest = ([ja.project(["s"])], [ta.project(["s"])]) if world == 1 else ([], [])
    tables_equal(ct.Table.concat([ja, jc_] + rest[0], axis=1, join=join, distributed=dist),
                 ctt.Table.concat([ta, tc_] + rest[1], axis=1, join=join, distributed=dist))
    if join == "outer" and world == 1:  # the DataFrame forms call Table.concat
        jd = ct.DataFrame.concat([ct.DataFrame(_table=ja), ct.DataFrame(_table=jc_)], axis=1)
        td = ctt.DataFrame.concat([ctt.DataFrame(ta), ctt.DataFrame(tc_)], axis=1)
        tables_equal(jd.table, td.table)
        tables_equal(ct.frame.concat([ct.DataFrame(_table=ja)] * 2).table,
                     ctt.frame.concat([ctt.DataFrame(ta)] * 2).table)


@pytest.mark.parametrize("world", [1, 4])
def test_dataframe_indexing_matches_reference(rng, world):
    jt, tt = both(world, _cols(rng, 100))
    jd, td = ct.DataFrame(_table=jt).set_index("k"), ctt.DataFrame(tt).set_index("k")
    assert td.index.name == jd.index.name == "k"
    for j, t in ((jd.loc[[4, 8, 4]], td.loc[[4, 8, 4]]), (jd.loc[3:9], td.loc[3:9]),
                 (jd.iloc[10:40], td.iloc[10:40]), (jd.reset_index().iloc[[1, 0]],
                                                     td.reset_index().iloc[[1, 0]])):
        assert isinstance(t, ctt.DataFrame)
        tables_equal(j.table, t.table)
