"""The port's remaining groupby aggregations against the JAX package on the
CPU: var, std, nunique and quantile/median (with ``ddof`` and
``quantile``), as lists of ops per column, through ``Table.groupby`` at
world 1 and ``distributed_groupby`` at world 4 (no pre-combine: the raw
rows are shuffled), ``GroupByView.std/var/nunique``, and
``pipeline_groupby`` / ``distributed_pipeline_groupby``, fed one host
encoding made with numpy from a fixed seed.

Tolerances: var and std within rtol 1e-9 and atol 1e-12 in float64 (both
packages add the sums of squares in their own order); every other column
exactly (nunique and the quantile bit for bit, the keys, counts and
validity), shard by shard and in order.
"""
import numpy as np
import pandas as pd
import pytest
import torch

import cylon_tpu as ct
import cylon_tpu_torch as ctt
from cylon_tpu_torch.dtypes import DataType, Type
from test_torch_compute import same_values, shard_column
from test_torch_shuffle_slice import NO_TIERS, _contexts, _encode

torch.set_num_threads(1)


@pytest.fixture
def ref_env(monkeypatch):
    for k in NO_TIERS:
        monkeypatch.setenv(k, "1")


def groupby_equal(jt, tt):
    """Shard by shard; ``*_var`` / ``*_std`` within rtol 1e-9, atol 1e-12."""
    assert tt.column_names == jt.column_names
    np.testing.assert_array_equal(tt.row_counts, jt.row_counts)
    for s in range(len(jt.row_counts)):
        for c in jt.column_names:
            gd, gm = shard_column(tt, c, s, True)
            wd, wm = shard_column(jt, c, s, False)
            np.testing.assert_array_equal(gm, wm, err_msg=f"{c} valid, shard {s}")
            if c.endswith(("_var", "_std")):
                assert gd.dtype == wd.dtype == np.float64, c
                np.testing.assert_allclose(gd, wd, rtol=1e-9, atol=1e-12, err_msg=c)
            else:
                same_values(gd, wd, (c, s))


def _data(rng, n=400, groups=23):
    v = rng.normal(size=n) * 10
    v[rng.random(n) < 0.15] = np.nan  # nulls
    v[:6] = [1.0, 1.0, -0.0, 0.0, 2.5, 2.5]  # repeated values, signed zeros
    f = rng.normal(size=n).astype(np.float32)
    f[rng.random(n) < 0.1] = np.nan  # NaN values, not nulls (see _encoded)
    k = rng.integers(0, groups, n).astype(np.int32)
    k[-3:] = groups  # a group of three rows
    k[-1] = groups + 1  # a group of one row: var null at ddof 1
    v[-1] = 4.0
    s = rng.choice(["ant", "bee", "cat", "dog", "eel"], n).astype(object)
    s[rng.random(n) < 0.1] = None
    return {"k": k, "v": v, "f": f, "i": rng.integers(-50, 50, n).astype(np.int64), "s": s}


def _encoded(cols):
    """The host encoding, with ``f``'s NaN kept as values (a float column
    with no validity mask), so nunique meets NaN."""
    enc = _encode({c: x for c, x in cols.items() if c != "f"})
    enc["f"] = (cols["f"], None, DataType(Type.FLOAT), None)
    return {c: enc[c] for c in cols}


def _both(world, cols):
    jctx, tctx = _contexts(world)
    enc = _encoded(cols)
    return ct.Table.from_encoded(jctx, enc), ctt.Table.from_encoded(tctx, enc)


AGG = {"v": ["var", "std", "nunique", "median", "quantile"], "f": ["nunique", "median"],
       "s": "nunique", "i": ["var", "median", "std"]}


@pytest.mark.parametrize("world", [1, 4])
def test_var_std_nunique_quantile_match_reference(rng, ref_env, world):
    jt, tt = _both(world, _data(rng))
    groupby_equal(jt.distributed_groupby("k", AGG), tt.distributed_groupby("k", AGG))
    if world > 1:
        return  # past the raw-row shuffle each shard runs world 1's local groupby
    kw, agg = {"ddof": 0, "quantile": 0.25}, {"v": ["std", "quantile"]}
    groupby_equal(jt.distributed_groupby("k", agg, **kw), tt.distributed_groupby("k", agg, **kw))
    # two keys, one of them a nullable string
    agg2 = {"v": ["std", "median"], "i": "nunique"}
    groupby_equal(jt.distributed_groupby(["s", "k"], agg2), tt.distributed_groupby(["s", "k"], agg2))


def test_nunique_counts_nan_as_zero_like_reference(rng):
    """A NaN value and a 0.0 of one group are one value (the JAX package's
    quirk, reproduced)."""
    cols = {"k": np.array([0, 0, 0, 1, 1, 1], np.int32),
            "f": np.array([np.nan, 0.0, 1.0, np.nan, np.nan, 2.0], np.float32)}
    jctx, tctx = _contexts(1)
    enc = {"k": _encode(cols)["k"], "f": (cols["f"], None, DataType(Type.FLOAT), None)}
    jt, tt = ct.Table.from_encoded(jctx, enc), ctt.Table.from_encoded(tctx, enc)
    got = tt.groupby("k", {"f": "nunique"})
    groupby_equal(jt.groupby("k", {"f": "nunique"}), got)
    assert got.column("f_nunique").data.tolist() == [2, 2]


def test_groupby_view_std_var_nunique_match_reference(rng):
    cols = _data(rng, 200)
    data = {"k": cols["k"], "v": cols["v"], "i": cols["i"]}
    jd = ct.DataFrame(pd.DataFrame(data), ctx=ct.CylonContext.init())
    td = ctt.DataFrame(pd.DataFrame(data),
                       ctx=ctt.CylonContext.init_distributed(ctt.GPUConfig(device="cpu")))
    for op in ("std", "var", "nunique"):
        groupby_equal(getattr(jd.groupby("k"), op)().table, getattr(td.groupby("k"), op)().table)


@pytest.mark.parametrize("world", [1, 4])
def test_pipeline_groupby_matches_reference(rng, ref_env, world):
    """Over input sorted by the keys, and the distributed form (a range
    shuffle, the local sort, then the run detection)."""
    jt, tt = _both(world, _data(rng, 300))
    agg = {"v": ["sum", "median"], "i": ["count", "var"]}
    groupby_equal(jt.distributed_pipeline_groupby("k", agg),
                  tt.distributed_pipeline_groupby("k", agg))
    if world == 1:
        js, ts = jt.sort(["k", "s"]), tt.sort(["k", "s"])
        groupby_equal(js.pipeline_groupby(["k", "s"], agg), ts.pipeline_groupby(["k", "s"], agg))
        # the groups are the input's runs, in the input's order
        u = tt.take([5, 5, 1, 1, 5]).pipeline_groupby("k", {"i": "count"})
        assert u.column("i_count").data.tolist() == [2, 2, 1]
