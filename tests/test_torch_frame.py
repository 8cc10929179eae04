"""The port's DataFrame API against the JAX package's, on the CPU: the flow
of examples/join_groupby.py (``DataFrame.merge(on="cust")`` then
``groupby("segment").agg({"price": "sum"})`` through a ``CylonEnv``) at a
small size, at worlds 1 and 4, plus ``merge(algorithm="pallas_pk")`` and
``join`` with suffixes.

Both packages get the same numpy data from a fixed seed. The frames are
built on a one-device context and moved to the env's context by
``merge(env=...)``, as in the example. Joins are compared exactly in row
order (at world 4 the shards concatenate in order, and the sort join puts
the same rows in the same order on every shard); the float64 price sums
add in another order in the two packages' segment reductions, so they are
compared at rtol 1e-6. World 4 runs the reference with the shuffle tiers
the port has not ported switched off (tests/test_torch_shuffle_slice.py).
"""
import numpy as np
import pandas as pd
import pytest
import torch

import jax

import cylon_tpu as ct
import cylon_tpu_torch as ctt
from cylon_tpu_torch import frame as tframe
from cylon_tpu_torch.ops import pk_join
from test_torch_shuffle_slice import NO_TIERS
from test_torch_slice import _frames_equal_agg

torch.set_num_threads(1)


@pytest.fixture
def ref_env(monkeypatch):
    for k in NO_TIERS:
        monkeypatch.setenv(k, "1")


def _envs(world):
    return (
        ct.CylonEnv(config=ct.TPUConfig(devices=jax.devices()[:world])),
        ctt.CylonEnv(config=ctt.GPUConfig(device="cpu", world_size=world)),
    )


def _local():
    return ct.CylonContext.init(), ctt.CylonContext.init_distributed(ctt.GPUConfig(device="cpu"))


def _frames(data):
    """The same host data as a DataFrame of each package, on one device."""
    jctx, tctx = _local()
    return ct.DataFrame(pd.DataFrame(data), ctx=jctx), ctt.DataFrame(pd.DataFrame(data), ctx=tctx)


def _orders_customers(rng, n=2000, n_cust=300):
    orders = {"cust": rng.integers(0, n_cust, n), "price": rng.gamma(2.0, 50.0, n)}
    customers = {"cust": np.arange(n_cust),
                 "segment": rng.choice(["consumer", "corporate", "home"], n_cust)}
    return orders, customers


@pytest.mark.parametrize("world", [1, 4])
def test_join_groupby_example_flow_matches_reference(rng, ref_env, world):
    orders, customers = _orders_customers(rng)
    (jo, to), (jc, tc) = _frames(orders), _frames(customers)
    jenv, tenv = _envs(world)
    jm = jo.merge(jc, on="cust", env=jenv)
    tm = to.merge(tc, on="cust", env=tenv)
    assert tm.columns == jm.columns == ["cust", "price", "segment"]
    assert tm.shape == jm.shape and len(tm) == len(jm) == 2000
    assert tm.table.world_size == world
    pd.testing.assert_frame_equal(tm.to_pandas(), jm.to_pandas(), check_exact=True)
    jg = jm.groupby("segment", env=jenv).agg({"price": "sum"})
    tg = tm.groupby("segment", env=tenv).agg({"price": "sum"})
    _frames_equal_agg(tg.to_pandas(), jg.to_pandas())
    assert list(tg.to_dict()) == ["segment", "price_sum"]


def test_merge_pallas_pk_matches_reference(rng):
    rk = rng.permutation(4000)[:300].astype(np.int32)
    left = {"k": rng.choice(rk, 300), "v": rng.normal(size=300)}
    right = {"k": rk, "w": rng.normal(size=300).astype(np.float32)}
    (jl, tl), (jr, tr) = _frames(left), _frames(right)
    jenv, tenv = _envs(1)
    before = pk_join.COUNTS["fallback"]
    got = tl.merge(tr, on="k", algorithm="pallas_pk", env=tenv).to_pandas()
    want = jl.merge(jr, on="k", algorithm="pallas_pk", env=jenv).to_pandas()
    assert pk_join.COUNTS["fallback"] == before
    pd.testing.assert_frame_equal(got, want, check_exact=True)


@pytest.mark.parametrize("how", ["inner", "left", "outer"])
def test_join_with_suffixes_matches_reference(rng, how):
    left = {"k": rng.integers(0, 50, 200), "v": rng.normal(size=200)}
    right = {"k": rng.integers(25, 75, 150), "v": rng.normal(size=150)}
    (jl, tl), (jr, tr) = _frames(left), _frames(right)
    got = tl.join(tr, on="k", how=how, lsuffix="a", rsuffix="b")
    want = jl.join(jr, on="k", how=how, lsuffix="a", rsuffix="b")
    assert got.columns == ["k_a", "v_a", "k_b", "v_b"]
    pd.testing.assert_frame_equal(got.to_pandas(), want.to_pandas(), check_exact=True)
    # merge coalesces the key: the right one where the left is missing
    got_m = tl.merge(tr, on="k", how=how).to_pandas()
    pd.testing.assert_frame_equal(got_m, jl.merge(jr, on="k", how=how).to_pandas(), check_exact=True)


def test_groupby_view_shortcuts_match_reference(rng):
    data = {"g": rng.integers(0, 7, 120), "x": rng.normal(size=120), "y": rng.integers(0, 9, 120)}
    jd, td = _frames(data)
    for op in ("sum", "min", "max", "mean", "count"):
        got = getattr(td.groupby("g"), op)().to_pandas()
        want = getattr(jd.groupby("g"), op)().to_pandas()
        _frames_equal_agg(got, want)


def test_unported_and_device_rules(monkeypatch):
    jd, td = _frames({"k": np.arange(6), "v": np.ones(6)})
    env = ctt.CylonEnv(config=ctt.GPUConfig(device="cpu", world_size=4))
    # the fused mode needs a distributed env, as in the JAX package, and
    # under one gives the eager merge's rows
    with pytest.raises(ValueError, match="distributed env"):
        td.merge(td, on="k", mode="fused")
    fused = td.merge(td, on="k", env=env, mode="fused").to_pandas()
    eager = td.merge(td, on="k", env=env).to_pandas()
    assert fused.sort_values(list(fused.columns)).reset_index(drop=True).equals(
        eager.sort_values(list(eager.columns)).reset_index(drop=True))
    with pytest.raises(ValueError, match="unknown join mode"):
        td.join(td, on="k", mode="lazy")
    # std/var/nunique: test_torch_groupby_aggs
    # collect_async and the lazy dispatch, ported with serving (A9c): the
    # JAX package's collect
    assert td.collect_async().result(60).to_pandas().equals(jd.lazy().collect().to_pandas())
    assert td.to_arrow().equals(jd.to_arrow())  # ported with the I/O layers (A8)
    assert td.lazy().dispatch().to_pandas().equals(jd.lazy().dispatch().to_pandas())
    assert "== Analyzed plan (executed) ==" in td.lazy().explain(analyze=True)  # test_torch_obs
    local = ctt.CylonEnv(config=ctt.GPUConfig(device="cpu", world_size=4), distributed=False)
    assert local.world_size == 1 and not local.is_distributed and env.is_distributed
    assert env.rank == 0
    # without a context a DataFrame goes to the card, never the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tframe, "_default_local_ctx", None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ctt.DataFrame({"k": np.arange(3)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ctt.CylonEnv()
