"""The port's Table, Series and DataFrame surface against the JAX package
on the CPU: null handling (isnull/notnull/isna/notna, fillna with a number
and with a new string, dropna by rows and by columns), isin, astype both
ways through strings, where/mask, applymap, equals, select_rows, iterrows
and Row, from_numpy/from_list, to_numpy, to_string, shape and
column_count, the item operators, the Series operators and reductions,
and the DataFrame's selection, mask assignment, sort_values and
drop_duplicates under an env, fed one host encoding made with numpy from a
fixed seed. The ops that run shard by shard are held at world 1; those
with a distributed form or a per-rank host step (``equals`` unordered,
``applymap``, ``select_rows``, ``sort_values`` and ``drop_duplicates``
under an env) at worlds 1 and 4.

Every comparison is exact (bit for bit, the index included), shard by
shard and in order; the surface adds no float arithmetic but what
test_torch_compute.py holds.
"""
import numpy as np
import pytest
import torch

import jax

import cylon_tpu as ct
import cylon_tpu_torch as ctt
from cylon_tpu_torch.series import Series
from test_torch_compute import both, tables_equal
from test_torch_shuffle_slice import NO_TIERS, _contexts

torch.set_num_threads(1)


@pytest.fixture
def ref_env(monkeypatch):
    for k in NO_TIERS:
        monkeypatch.setenv(k, "1")


def _cols(rng, n):
    x = rng.normal(size=n)
    x[rng.random(n) < 0.2] = np.nan
    s = rng.choice(["bee", "cat", "dog"], n).astype(object)
    s[rng.random(n) < 0.2] = None
    b = (rng.random(n) < 0.5).astype(object)
    b[rng.random(n) < 0.1] = None
    return {"k": rng.integers(0, 7, n).astype(np.int32), "x": x, "s": s, "b": b,
            "f": rng.normal(size=n).astype(np.float32)}


@pytest.mark.parametrize("world", [1])
def test_null_handling_matches_reference(rng, world):
    jt, tt = both(world, _cols(rng, 120))
    jt, tt = jt.set_index("k"), tt.set_index("k")  # every op keeps the index
    for call in (
        lambda t: t.isnull(), lambda t: t.notnull(), lambda t: t.isna(), lambda t: t.notna(),
        lambda t: t.project(["x", "f"]).fillna(0.25),
        lambda t: t.project(["k", "s"]).fillna("ant"),   # a new string: the dictionary grows
        lambda t: t.project(["s"]).fillna("cat"),        # a string already in it
        lambda t: t.project(["b"]).fillna(True),
        lambda t: t.dropna(axis=1), lambda t: t.dropna(axis=1, how="all"),
        lambda t: t.dropna(axis=0), lambda t: t.project(["k", "f"]).dropna(axis=1, how="all"),
    ):
        tables_equal(call(jt), call(tt))
    got = ctt.Table(tt.ctx, tt._shards, tt._counts, index_name=tt.index_name)
    assert got.dropna(axis=1, inplace=True) is got
    tables_equal(jt.dropna(axis=1), got)


@pytest.mark.parametrize("world", [1])
def test_astype_where_mask_match_reference(rng, world):
    n = 100
    cols = _cols(rng, n)
    cols["num"] = rng.choice(["1.5", "-2", "30", "0.25"], n).astype(object)
    jt, tt = both(world, cols)
    for call in (
        lambda t: t.astype({"k": "int64", "f": "float64"}),
        lambda t: t.project(["k", "f"]).astype("float32"),
        lambda t: t.astype({"num": "float64"}),          # string -> number by the dictionary
        lambda t: t.astype({"k": str, "x": "str"}),      # number -> string
        lambda t: t.astype({"s": "string"}),
        lambda t: t.project(["x", "f"]).astype({"x": np.int32, "f": "int64"}),  # saturating
        lambda t: t.where(t.project(["x"]) > 0),
        lambda t: t.project(["k", "f", "s"]).where(t.project(["x"]) > 0, 0),
        lambda t: t.project(["s"]).where(t.project(["x"]) > 0, "zzz"),
        lambda t: t.project(["k", "x"]).mask(t.project(["x"]) > 0, 7),
        lambda t: t.project(["k", "s"]).mask(t.project(["f"]) < 0),
    ):
        tables_equal(call(jt), call(tt))
    edge = {"f": np.array([np.inf, -np.inf, 3e9, -3e9, 2.7, -2.7, 1e30], np.float32)}
    jt2, tt2 = both(world, edge)
    for dt in ("int32", "int64", "uint8", "bool"):
        tables_equal(jt2.astype(dt), tt2.astype(dt))


@pytest.mark.parametrize("world", [1, 4])
def test_row_functions_and_conversion_match_reference(rng, world):
    cols = _cols(rng, 60)
    jt, tt = both(world, cols)
    jt, tt = jt.set_index("k"), tt.set_index("k")
    fn = lambda v: None if v is None else (v * 2 if isinstance(v, (int, float)) else str(v) + "!")
    tables_equal(jt.project(["k", "s", "f"]).applymap(fn), tt.project(["k", "s", "f"]).applymap(fn))
    pred = lambda r: r["s"] == "cat" or (r.get("f") > 0.5 and r.row_index % 2 == 0)
    tables_equal(jt.select_rows(pred), tt.select_rows(pred))
    want, got = list(jt.iterrows()), list(tt.iterrows())
    assert len(got) == len(want) == 60
    for (wi, wr), (gi, gr) in zip(want, got):
        assert gi == wi and list(gr) == list(wr)
        for c in wr:
            assert (gr[c] == wr[c]) or (gr[c] is wr[c]) or (gr[c] != gr[c] and wr[c] != wr[c]), c
    assert list(ctt.table.Row({"a": np.arange(3)}, 2).keys()) == ["a"]
    np.testing.assert_array_equal(tt.project(["k", "x", "f"]).to_numpy(),
                                  jt.project(["k", "x", "f"]).to_numpy())
    assert tt.to_string() == jt.to_string() and tt.to_string(5) == jt.to_string(5)
    assert tt.shape == jt.shape and tt.column_count == jt.column_count == 5
    assert tt.dtype_of("f").type == jt.dtype_of("f").type and tt.context is tt.ctx
    jctx, tctx = _contexts(world)
    names, arrays = ["a", "b"], [np.arange(9, dtype=np.int32), np.linspace(0, 1, 9)]
    tables_equal(ct.Table.from_numpy(jctx, names, arrays), ctt.Table.from_numpy(tctx, names, arrays))
    lists = [[1, 2, 3], ["x", "y", "x"], [1.5, None, 2.5]]
    tables_equal(ct.Table.from_list(jctx, ["i", "s", "f"], lists),
                 ctt.Table.from_list(tctx, ["i", "s", "f"], lists))


@pytest.mark.parametrize("world", [1, 4])
def test_equals_matches_reference(rng, ref_env, world):
    cols = _cols(rng, 80)
    jt, tt = both(world, cols)
    perm = rng.permutation(80)
    jp, tp = both(world, {c: v[perm] for c, v in cols.items()})
    for a, b in ((jt, tt), (jp, tp)):
        assert a.equals(jt) == b.equals(tt)
        assert a.equals(jt, ordered=False) == b.equals(tt, ordered=False)
    assert tt.equals(tt) and not tp.equals(tt) and tp.equals(tt, ordered=False)
    jd, td = both(world, {**cols, "f": cols["f"] + 1})
    assert not td.equals(tt) and not td.equals(tt, ordered=False)
    assert jd.equals(jt) is False and jd.equals(jt, ordered=False) is False
    assert not tt.equals(tt.project(["k"]))


@pytest.mark.parametrize("world", [1])
def test_item_access_matches_reference(rng, world):
    jt, tt = both(world, _cols(rng, 50))
    for key in ("x", ["s", "k"], slice(3, 40, 4), np.arange(50) % 3 == 0):
        tables_equal(jt[key], tt[key])
    tables_equal(jt[jt.project(["f"]) > 0], tt[tt.project(["f"]) > 0])
    for t in (jt, tt):
        t["c"] = np.arange(50) * 2
        t["z"] = 1.5
        t[t.project(["k"]) > 3] = 0
    tables_equal(jt, tt)
    with pytest.raises(ValueError):
        bool(tt)


@pytest.mark.parametrize("world", [1])
def test_series_matches_reference(rng, ref_env, world):
    jt, tt = both(world, _cols(rng, 70))
    js = {c: ct.Series(_table=jt.project([c])) for c in jt.column_names}
    ts = {c: Series(_table=tt.project([c])) for c in tt.column_names}
    for call in (
        lambda s: s["k"] > 3, lambda s: s["x"] <= 0, lambda s: s["k"] == s["k"],
        lambda s: s["k"] != 2, lambda s: s["f"] >= 0, lambda s: s["s"] < "cat",
        lambda s: s["k"] + 2, lambda s: s["k"] - s["k"], lambda s: s["f"] * 2.5,
        lambda s: s["k"] / 2, lambda s: s["k"] % 3, lambda s: s["k"] ** 2, lambda s: -s["f"],
        lambda s: ~(s["k"] > 2), lambda s: (s["k"] > 2) & (s["k"] < 5),
        lambda s: (s["k"] > 2) | (s["f"] > 0), lambda s: s["x"].abs(),
        lambda s: s["k"].isin([1, 2, 9]), lambda s: s["x"].isnull(), lambda s: s["x"].notnull(),
        lambda s: s["s"].fillna("eel"), lambda s: s["k"].astype("float64"),
        lambda s: s["s"].unique(), lambda s: s["f"].sort_values(ascending=False),
        lambda s: s["k"][s["f"] > 0], lambda s: s["k"][2:9],
    ):
        tables_equal(call(js)._table, call(ts)._table)
    for c in ("k", "x", "f"):
        for op in ("sum", "min", "max", "count", "mean", "nunique"):
            # float32 sums add in another order (the aggregates' tolerance)
            rel = 1e-5 if c == "f" else 1e-12
            assert getattr(ts[c], op)() == pytest.approx(getattr(js[c], op)(), rel=rel), (c, op)
    assert ts["k"].shape == js["k"].shape and len(ts["k"]) == 70 and ts["s"].name == "s"
    assert ts["k"][3] == js["k"][3] and ts["k"].id == "k"
    assert ts["x"].dtype.type == js["x"].dtype.type
    np.testing.assert_array_equal(ts["k"].to_numpy(), js["k"].to_numpy())


def _frames(world, cols):
    jt, tt = both(world, cols)
    return ct.DataFrame(_table=jt), ctt.DataFrame(tt)


@pytest.mark.parametrize("world", [1, 4])
def test_dataframe_surface_matches_reference(rng, ref_env, world):
    cols = _cols(rng, 90)
    jd, td = _frames(world, cols)
    jenv = ct.CylonEnv(config=ct.TPUConfig(devices=jax.devices()[:world]))
    tenv = ctt.CylonEnv(config=ctt.GPUConfig(device="cpu", world_size=world))
    shard_by_shard = (  # ops with no distributed form: held at world 1
        lambda d: d[d["f"] > 0.5], lambda d: d[["s", "k"]], lambda d: d.isna(),
        lambda d: d.notna(), lambda d: d.fillna(0.5).drop(["s", "b"]),
        lambda d: d.astype({"k": "int64"}), lambda d: d.where(d["f"] > 0),
        lambda d: d.mask(d["f"] > 0, 1), lambda d: d.rename({"k": "kk"}),
        lambda d: d.add_prefix("p_"), lambda d: d.add_suffix("_q"),
        lambda d: d.set_index("k").reset_index(),
    )
    for call in shard_by_shard if world == 1 else ():
        tables_equal(call(jd).table, call(td).table)
    # per shard: at world 4 the same local sort and unique run inside
    # distributed_sort and distributed_unique (test_torch_sort, test_torch_setops)
    local_sorts = (
        lambda d: d.sort_values(["k", "f"], ascending=[True, False]),
        lambda d: d.drop_duplicates(["k"], keep="last"), lambda d: d.drop_duplicates(),
    )
    for call in (lambda d: d[["k", "f"]].applymap(lambda v: v + 1),) + (
            local_sorts if world == 1 else ()):
        tables_equal(call(jd).table, call(td).table)
    tables_equal(jd.sort_values("k", env=jenv).table, td.sort_values("k", env=tenv).table)
    tables_equal(jd.drop_duplicates(["k"], keep="last", env=jenv).table,
                 td.drop_duplicates(["k"], keep="last", env=tenv).table)
    for op in ("sum", "min", "max", "count", "mean"):
        want, got = getattr(jd[["k", "f"]], op)(), getattr(td[["k", "f"]], op)()
        assert list(got) == list(want) and all(
            got[c] == pytest.approx(want[c], rel=1e-6) for c in want), op
    np.testing.assert_array_equal(td[["k", "f"]].to_numpy(), jd[["k", "f"]].to_numpy())
    for j, t in ((jd, td),):
        j["x2"] = j["f"] * 2.0 + j["k"]
        t["x2"] = t["f"] * 2.0 + t["k"]
        j[j["k"] > 4] = 0
        t[t["k"] > 4] = 0
        j["c"] = 3
        t["c"] = 3
    tables_equal(jd.table, td.table)
    assert td.is_cpu() and td.to_cpu() is td and td.to_device() is td and td.is_device("cpu")
    assert [r[0] for r in td.iterrows()] == [r[0] for r in jd.iterrows()]
    with pytest.raises(TypeError):
        td[3]


def _tuned_trigger(t):
    """The round schedule under the feedback re-coster's tuned skew
    trigger (A9)."""
    from cylon_tpu_torch.parallel import spill

    spill.plan_schedule(np.full((2, 2), 64, np.int64), 8, 2, 1 << 20, trigger=4)


@pytest.mark.parametrize("call", [
    lambda t: t.lazy().groupby("k", {"k": "count"}).dispatch(),
    lambda t: t.lazy().dispatch(), _tuned_trigger, lambda t: t.lazy().collect_async(),
    lambda t: ctt.DataFrame(t).lazy().dispatch(),
    lambda t: ctt.DataFrame(t).lazy().collect_async(), lambda t: ctt.DataFrame(t).collect_async(),
])
def test_left_out_surface_raises_naming_its_item(call):
    tctx = _contexts(1)[1]
    t = ctt.Table.from_pydict(tctx, {"k": np.arange(4, dtype=np.int32)})
    with pytest.raises(NotImplementedError, match=r"ROADMAP.md: A[4-9]"):
        call(t)


def _same_files(tmp, write_j, write_t, world=None):
    """Both writers' CSV output, byte for byte: one file, or one a shard."""
    names = ["x"] if world is None else [f"x{s}" for s in range(world)]
    write_j([str(tmp / f"j{n}.csv") for n in names] if world else str(tmp / "jx.csv"))
    write_t([str(tmp / f"t{n}.csv") for n in names] if world else str(tmp / "tx.csv"))
    for n in names:
        assert (tmp / f"t{n}.csv").read_bytes() == (tmp / f"j{n}.csv").read_bytes(), n


def _same_arrow(got, want):
    assert got.equals(want), (got.schema, want.schema)


IO_SURFACE = {  # (JAX table, port's table, tmp_path, world) -> None
    "to_arrow": lambda j, t, tmp, w: _same_arrow(t.to_arrow(), j.to_arrow()),
    "to_csv": lambda j, t, tmp, w: _same_files(tmp, j.to_csv, t.to_csv),
    "to_arrow_shard": lambda j, t, tmp, w: [
        _same_arrow(t.to_arrow(shard=s), j.to_arrow(shard=s)) for s in range(w)],
    "frame_to_csv_options": lambda j, t, tmp, w: _same_files(
        tmp, lambda p: ct.DataFrame(_table=j).to_csv(p, csv_write_options={}),
        lambda p: ctt.DataFrame(t).to_csv(p, csv_write_options={})),
    "from_arrow": lambda j, t, tmp, w: tables_equal(
        ct.Table.from_arrow(j.ctx, j.to_arrow()), ctt.Table.from_arrow(t.ctx, j.to_arrow())),
    "frame_to_arrow": lambda j, t, tmp, w: _same_arrow(
        ctt.DataFrame(t).to_arrow(), ct.DataFrame(_table=j).to_arrow()),
    "frame_to_csv": lambda j, t, tmp, w: _same_files(
        tmp, ct.DataFrame(_table=j).to_csv, ctt.DataFrame(t).to_csv, world=w),
}


@pytest.mark.parametrize("call", list(IO_SURFACE))
def test_io_surface_gives_the_jax_packages_results(tmp_path, rng, call):
    """The surface that raised until the I/O layers were ported (A8), each
    call against the JAX package's on the same table at world 4: Arrow
    tables equal, CSV files byte for byte."""
    jt, tt = both(4, _cols(rng, 90))
    IO_SURFACE[call](jt, tt, tmp_path, 4)
