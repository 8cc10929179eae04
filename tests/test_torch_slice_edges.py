"""The port's main path against the JAX package on the CPU, edge cases:
nullable and two-column keys, string keys and payloads, float64 keys with
NaN (the radix engine declines them), one hot key, empty sides. The
harness, the JAX configuration and the tolerances are those of
tests/test_torch_slice.py.
"""
import numpy as np
import pytest

import cylon_tpu as ct
import cylon_tpu_torch as ctt

from test_torch_slice import AGG, _run_both, _sides, jctx, pallas_env, tctx  # noqa: F401

def test_join_nullable_int64_key(jctx, tctx, rng, pallas_env):
    left, right = _sides(rng, 600, 600, 900, np.int64)
    for side, n_null in ((left, 12), (right, 6)):  # null keys match each other
        k = side["k"].astype(object)
        k[rng.choice(len(k), n_null, replace=False)] = None  # int64 + validity
        side["k"] = k
    _run_both(jctx, tctx, left, right, {"on": "k", "how": "left"}, "k_x", AGG)


def test_join_two_column_key_string_payload(jctx, tctx, rng, pallas_env):
    left, right = _sides(rng, 600, 700, 40)
    left["k2"] = rng.integers(0, 30, 600).astype(np.int32)
    right["k2"] = rng.integers(0, 30, 700).astype(np.int32)
    right["s"] = rng.choice(["ash", "birch", "cedar", "elm"], 700).astype(object)
    _run_both(jctx, tctx, left, right, {"on": ["k", "k2"], "how": "inner"}, ["k_x", "k2_x"],
              {"w": "sum", "v": "max"})


def test_join_string_key_unified_dictionaries(jctx, tctx, rng, pallas_env):
    words = np.array([f"w{i:04d}" for i in range(1500)], dtype=object)
    left, right = _sides(rng, 600, 600, 10)
    left["k"] = words[rng.integers(0, 1000, 600)]
    right["k"] = words[rng.integers(500, 1500, 600)]  # another dictionary
    _run_both(jctx, tctx, left, right, {"on": "k", "how": "outer"}, "k_y",
              {"w": ["sum", "count"], "a": "min"})


def test_join_float64_nan_key_declines_radix(jctx, tctx, rng, pallas_env):
    """A float64 key sorts through torch.sort (the JAX package through
    lax.sort): the decline is counted."""
    from cylon_tpu_torch.ops import radix as trx

    left, right = _sides(rng, 600, 600, 500, np.float64)
    left["k"][rng.random(600) < 0.05] = np.nan  # NaN keys become null keys
    before = trx.COUNTS["declined"]
    _run_both(jctx, tctx, left, right, {"on": "k", "how": "inner"}, "k_x", AGG)
    assert trx.COUNTS["declined"] > before


def test_join_one_hot_key(jctx, tctx, rng, pallas_env):
    left, right = _sides(rng, 600, 600, 50_000)
    left["k"][rng.choice(600, 15, replace=False)] = 7
    right["k"][rng.choice(600, 15, replace=False)] = 7
    t = _run_both(jctx, tctx, left, right, {"on": "k", "how": "inner"}, "k_x", AGG)
    assert t.row_count >= 225


@pytest.mark.parametrize(
    "n_l,n_r,key_dtype,how,by",
    [(0, 600, np.int32, "inner", "k_x"), (0, 600, np.int32, "outer", "k_y"),
     (600, 0, np.int64, "left", "k_x")],
)
def test_join_empty_side(jctx, tctx, rng, pallas_env, n_l, n_r, key_dtype, how, by):
    left, right = _sides(rng, n_l, n_r, 100, key_dtype)
    _run_both(jctx, tctx, left, right, {"on": "k", "how": how}, by, {"w": "sum", "a": "max"})


@pytest.mark.parametrize("world", [1, 4])
def test_bool_value_column_aggregates_like_reference(rng, world):
    """A bool value column: sum raises TypeError and min/max ValueError in
    both packages, through groupby and distributed_groupby; count and mean
    agree."""
    from test_torch_shuffle_slice import _contexts, _encode, _shards_equal

    jctx, tctx = _contexts(world)
    enc = _encode({"k": rng.integers(0, 20, 400).astype(np.int32), "x": rng.random(400) < 0.4})
    jt, tt = ct.Table.from_encoded(jctx, enc), ctt.Table.from_encoded(tctx, enc)
    for op, err in (("sum", TypeError), ("min", ValueError), ("max", ValueError)):
        for t in (jt, tt):
            for call in (t.groupby, t.distributed_groupby):
                with pytest.raises(err):
                    call("k", {"x": op})
    agg = {"x": ["count", "mean"]}
    _shards_equal(jt.groupby("k", agg), tt.groupby("k", agg))
    _shards_equal(jt.distributed_groupby("k", agg), tt.distributed_groupby("k", agg))
