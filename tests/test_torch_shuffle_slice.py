"""The port's world > 1 path against the JAX package, on the CPU:
``Table.from_encoded`` -> ``shuffle`` / ``distributed_join`` ->
``distributed_groupby`` in cylon_tpu_torch at ``GPUConfig(device="cpu",
world_size=W)`` and in cylon_tpu on ``TPUConfig(devices=jax.devices()[:W])``
(the 8 virtual CPU devices of tests/conftest.py), fed one host encoding
made with numpy from a fixed seed.

The murmur3 hash is the same in both packages, so every row lands on the
same shard: outputs are compared shard by shard, the same rows in the same
order, and so are ``row_counts``. The JAX side runs with its shuffle tiers
switched off: ``CYLON_TPU_NO_SEMI_FILTER``, ``CYLON_TPU_NO_LANE_PACK``,
``CYLON_TPU_NO_QUANT`` and ``CYLON_TPU_NO_TOPO``, and the port with
its two, ``CYLON_TPU_TORCH_NO_SEMI_FILTER`` and
``CYLON_TPU_TORCH_NO_LANE_PACK``, so the comparison stays like for like
(tests/test_torch_semi_filter.py and test_torch_lane_pack.py hold both
packages with these tiers on); both run the skew split at its default
(tests/test_torch_skew.py). Its sort and emit
are the defaults, not the forced Pallas radix pass and windowed expand of
tests/test_torch_slice.py: at world > 1 the forced configuration trips the
reference fault recorded in ROADMAP.md C (an outer or null-key join whose
output passes the speculative capacity fails in the exact-join fallback).
Both configurations give the same output (stable sorts, the same emit
order), so the comparison holds the port to the same answer.

Tolerances are those of tests/test_torch_slice.py: shuffles, joins, keys
and integer aggregates exact; float sums and means at rtol 1e-6 (float64)
and 1e-5 (float32), since the segment reductions add in another order.
"""
import numpy as np
import pandas as pd
import pytest
import torch

import jax

import cylon_tpu as ct
import cylon_tpu_torch as ctt
from cylon_tpu_torch.parallel import shuffle as tsh
from test_torch_slice import _frames_equal_agg, _frames_equal_exact

torch.set_num_threads(1)

#: the port's kill switches of the same two tiers
PORT_NO_TIERS = ("CYLON_TPU_TORCH_NO_SEMI_FILTER", "CYLON_TPU_TORCH_NO_LANE_PACK")
NO_TIERS = ("CYLON_TPU_NO_SEMI_FILTER", "CYLON_TPU_NO_LANE_PACK", "CYLON_TPU_NO_QUANT",
            "CYLON_TPU_NO_TOPO") + PORT_NO_TIERS

_CTX = {}


def _contexts(world):
    if world not in _CTX:
        _CTX[world] = (
            ct.CylonContext.init_distributed(ct.TPUConfig(devices=jax.devices()[:world])),
            ctt.CylonContext.init_distributed(ctt.GPUConfig(device="cpu", world_size=world)),
        )
    return _CTX[world]


@pytest.fixture
def ref_env(monkeypatch):
    for k in NO_TIERS:
        monkeypatch.setenv(k, "1")


@pytest.fixture
def budget(monkeypatch):
    """Set the per-round shuffle byte budget of both packages' contexts."""
    touched = []

    def set_budget(world, n):
        for c in _contexts(world):
            c.add_config("shuffle_byte_budget", str(n))
        touched.append(world)

    yield set_budget
    for world in touched:
        for c in _contexts(world):
            c.add_config("shuffle_byte_budget", "")


@pytest.fixture
def rounds(monkeypatch):
    """Every (bucket_cap, n_rounds) the port plans."""
    plans = []
    orig = tsh.plan_rounds

    def rec(*args, **kw):
        plans.append(orig(*args, **kw))
        return plans[-1]

    monkeypatch.setattr(tsh, "plan_rounds", rec)
    return plans


def _encode(cols):
    return {k: ct.Column.encode_host(np.asarray(v)) for k, v in cols.items()}


def _shard_frame(table, s, port):
    cols = {}
    for c in table.column_names:
        col = table._shards[s][c] if port else table._columns[c]
        cols[c] = col.decode_host(*table._host_physical_shard(c, s))
    return pd.DataFrame(cols)


def _shards_equal(jt, tt, agg=False):
    assert tt.column_names == jt.column_names
    np.testing.assert_array_equal(tt.row_counts, jt.row_counts)
    for s in range(len(jt.row_counts)):
        got, want = _shard_frame(tt, s, True), _shard_frame(jt, s, False)
        (_frames_equal_agg if agg else _frames_equal_exact)(got, want)


def _run_both(world, left, right, join_kw, by, agg):
    jctx, tctx = _contexts(world)
    l_enc, r_enc = _encode(left), _encode(right)
    jl, jr = ct.Table.from_encoded(jctx, l_enc), ct.Table.from_encoded(jctx, r_enc)
    tl, tr = ctt.Table.from_encoded(tctx, l_enc), ctt.Table.from_encoded(tctx, r_enc)
    _shards_equal(jl, tl)
    jj, tj = jl.distributed_join(jr, **join_kw), tl.distributed_join(tr, **join_kw)
    _shards_equal(jj, tj)
    _shards_equal(jj.distributed_groupby(by, agg), tj.distributed_groupby(by, agg), agg=True)


def _sides(rng, n_l, n_r, keyspace, l_dtype=np.int32, r_dtype=np.int32):
    left = {
        "k": rng.integers(0, keyspace, n_l).astype(l_dtype),
        "v": rng.normal(size=n_l).astype(np.float32),
        "a": rng.integers(-50, 50, n_l).astype(np.int32),
    }
    right = {"k": rng.integers(0, keyspace, n_r).astype(r_dtype), "w": rng.normal(size=n_r)}
    return left, right


AGG_COMBINE = {"v": "sum", "a": "min", "w": "max"}          # pre-combined per shard
AGG_FULL = {"v": ["sum", "mean"], "a": ["count", "max"], "w": "sum"}  # shuffled raw


def test_shuffle_matches_reference(rng, ref_env, rounds):
    """Table.shuffle at one round and, through a small byte budget, several;
    on an int32 key and on (int32, string) keys."""
    world = 4
    jctx, tctx = _contexts(world)
    left, _ = _sides(rng, 1200, 0, 900)
    left["s"] = rng.choice(["x", "yy", "zzz", "w"], 1200).astype(object)
    enc = _encode(left)
    jt, tt = ct.Table.from_encoded(jctx, enc), ctt.Table.from_encoded(tctx, enc)
    for budget, keys in ((None, ["k"]), (world * 64 * 16, ["k", "s"])):
        rounds.clear()
        got = tt.shuffle(keys, byte_budget=budget)
        _shards_equal(jt.shuffle(keys, byte_budget=budget), got)
        assert (rounds[0][1] > 1) == (budget is not None), rounds
        assert got.row_count == 1200


@pytest.mark.parametrize(
    "world,how,case,agg",
    [
        (4, "inner", "int32_x_int64_keys", AGG_COMBINE),
        (4, "left", "null_keys", AGG_FULL),
        (2, "right", "string_key", AGG_FULL),
        (4, "outer", "empty_shard", AGG_COMBINE),
        (3, "inner", "several_rounds", AGG_COMBINE),
        (2, "inner", "empty_side", AGG_FULL),
    ],
    ids=lambda v: "combine" if v is AGG_COMBINE else "full" if v is AGG_FULL else None,
)
def test_join_groupby_matches_reference(rng, ref_env, budget, rounds, world, how, case, agg):
    """distributed_join -> distributed_groupby. AGG_COMBINE pre-combines per
    shard before the groupby's shuffle; AGG_FULL (mean, count) shuffles the
    joined rows themselves."""
    n_l, n_r = 800, 700
    l_dt, r_dt = (np.int32, np.int64) if case == "int32_x_int64_keys" else (np.int32, np.int32)
    if case == "empty_shard":
        n_r = world - 1  # the last right shard holds no rows
    if case == "empty_side":
        n_r = 0
    left, right = _sides(rng, n_l, n_r, 1000, l_dt, r_dt)
    by = "k_y" if how == "right" else "k_x"
    if case == "null_keys":
        for side, n_null in ((left, 20), (right, 10)):
            k = side["k"].astype(object)
            k[rng.choice(len(k), n_null, replace=False)] = None
            side["k"] = k
    if case == "string_key":
        words = np.array([f"w{i:04d}" for i in range(1500)], dtype=object)
        left["k"] = words[rng.integers(0, 1000, n_l)]
        right["k"] = words[rng.integers(500, 1500, n_r)]  # another dictionary
    if case == "several_rounds":
        budget(world, world * 32 * 16)
    _run_both(world, left, right, {"on": "k", "how": how}, by, agg)
    if case == "several_rounds":
        assert all(k > 1 for _bc, k in rounds[:2]), rounds


@pytest.mark.slow
@pytest.mark.parametrize("how", ["inner", "left", "right", "outer"])
def test_world8_sweep_matches_reference(rng, ref_env, how):
    left, right = _sides(rng, 1600, 1500, 2000, np.int64, np.int64)
    by = "k_y" if how == "right" else "k_x"
    _run_both(8, left, right, {"on": "k", "how": how}, by, AGG_COMBINE)
