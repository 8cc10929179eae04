"""The port's set operations against the JAX package on the CPU: ``union``,
``subtract``, ``intersect`` and ``unique`` and their ``distributed_*``
forms, fed one host encoding made with numpy from a fixed seed.

Every comparison is exact and in order. World 1 compares whole tables in
first-occurrence order, with the JAX side's sorts forced through its
Pallas radix pass. Worlds 2 and 4 compare shard by shard, in order: the
hash shuffle on all columns (on the key columns for ``distributed_unique``)
sends every row to the same shard in both packages, in the same arrival
order, and the local op keeps rows in that order (the global row id
decides keep='first'/'last' in ``distributed_unique``). The JAX side runs
as in tests/test_torch_shuffle_slice.py, with the semi-join filter off
(ROADMAP.md C).
"""
import numpy as np
import pytest
import torch

import cylon_tpu as ct
import cylon_tpu_torch as ctt
from test_torch_shuffle_slice import (  # noqa: F401
    _contexts, _shards_equal, budget, ref_env, rounds,
)

torch.set_num_threads(1)

WORDS = np.array([f"w{i:03d}" for i in range(60)], dtype=object)


@pytest.fixture
def pallas_sort(monkeypatch):
    monkeypatch.setenv("CYLON_TPU_SORT_IMPL", "radix_pallas")


def _side(rng, n, words):
    """Few distinct rows, so every op keeps and drops some: a small int key,
    a float with NaN, -0.0 and nulls apart from the NaNs, a string column."""
    return {
        "k": rng.integers(0, 12, n).astype(np.int32),
        "f": (rng.choice([0.5, -0.0, 0.0, 1.5, np.nan], n), rng.random(n) > 0.05),
        "s": rng.choice(words, n),
    }


def _pair(rng, n_l, n_r):
    # the right side draws from another range of words: another dictionary
    return _side(rng, n_l, WORDS[:40]), _side(rng, n_r, WORDS[20:])


def _encode_side(cols):
    """Host encoding; a (values, valid) pair is a nullable float64 column
    whose NaN values stay values."""
    f64 = ct.Column.encode_host(np.zeros(1))[2]
    return {k: (v[0], v[1], f64, None) if isinstance(v, tuple) else ct.Column.encode_host(v)
            for k, v in cols.items()}


def _tables(world, left, right):
    jctx, tctx = _contexts(world)
    le, re = _encode_side(left), _encode_side(right)
    return (ct.Table.from_encoded(jctx, le), ct.Table.from_encoded(jctx, re),
            ctt.Table.from_encoded(tctx, le), ctt.Table.from_encoded(tctx, re))


OPS = ["union", "subtract", "intersect"]


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("n_l,n_r", [(700, 600), (0, 300), (300, 0)])
def test_setops_match_reference(rng, ref_env, pallas_sort, op, n_l, n_r):
    left, right = _pair(rng, n_l, n_r)
    if not (n_l and n_r):
        # the JAX package cannot unify an empty side's empty dictionary
        # (ROADMAP.md C): the empty cases leave the string column out
        del left["s"], right["s"]
    jl, jr, tl, tr = _tables(1, left, right)
    got = getattr(tl, op)(tr)
    _shards_equal(getattr(jl, op)(jr), got)
    if n_l and n_r:
        assert 0 < got.row_count < n_l + n_r


@pytest.mark.parametrize("keep", ["first", "last"])
@pytest.mark.parametrize("columns", [None, ["k"], ["s", "f"]])
def test_unique_matches_reference(rng, ref_env, pallas_sort, keep, columns):
    jl, _jr, tl, _tr = _tables(1, *_pair(rng, 800, 0))
    _shards_equal(jl.unique(columns, keep), tl.unique(columns, keep))


def test_union_of_mixed_dtypes_matches_reference(rng, ref_env):
    """An int32 and an int64 column: the union goes through concat's
    promotion and a unique, as in the JAX package."""
    left, right = _pair(rng, 500, 400)
    right["k"] = right["k"].astype(np.int64) + 6
    jl, jr, tl, tr = _tables(1, left, right)
    got = tl.union(tr)
    _shards_equal(jl.union(jr), got)
    assert got.to_pandas()["k"].dtype == np.int64


def test_setop_schema_mismatch_raises(rng):
    _jl, _jr, tl, tr = _tables(1, *_pair(rng, 10, 10))
    with pytest.raises(ValueError, match="identical schemas"):
        tl.union(tr.project(["k", "s"]))
    with pytest.raises(ValueError, match="string"):
        tl.subtract(tr.project(["s", "f", "k"]).rename(["k", "f", "s"]))


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("op", OPS)
def test_distributed_setops_match_reference(rng, ref_env, world, op):
    jl, jr, tl, tr = _tables(world, *_pair(rng, 900, 700))
    op = "distributed_" + op
    _shards_equal(getattr(jl, op)(jr), getattr(tl, op)(tr))


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("keep", ["first", "last"])
def test_distributed_unique_matches_reference(rng, ref_env, budget, rounds, world, keep):
    """The global row id rides the shuffle, through several rounds."""
    jl, _jr, tl, _tr = _tables(world, *_pair(rng, 900, 0))
    budget(world, world * 64 * 16)
    _shards_equal(jl.distributed_unique(["k", "s"], keep), tl.distributed_unique(["k", "s"], keep))
    assert rounds[0][1] > 1, rounds


def test_distributed_unique_keeps_the_global_first_and_last(rng):
    """Against numpy: the kept row of each key is its first (last)
    occurrence in table order, wherever the shuffle put it."""
    tctx = _contexts(4)[1]
    k = rng.integers(0, 50, 3000).astype(np.int32)
    t = ctt.Table.from_pydict(tctx, {"k": k, "row": np.arange(3000)})
    for keep, rows in (("first", np.unique(k, return_index=True)[1]),
                       ("last", 2999 - np.unique(k[::-1], return_index=True)[1])):
        got = t.distributed_unique(["k"], keep).to_pydict()
        np.testing.assert_array_equal(np.sort(got["row"]), np.sort(rows))
        np.testing.assert_array_equal(got["k"], k[got["row"]])


def test_global_rowid_is_int32_and_refuses_past_int32():
    tctx = _contexts(4)[1]
    t = ctt.Table.from_pydict(tctx, {"k": np.arange(10)})
    ids = t._global_rowid_column()
    assert [c.data.tolist() for c in ids] == [[0, 1, 2], [3, 4, 5], [6, 7], [8, 9]]
    assert all(c.data.dtype == torch.int32 for c in ids)
    big = ctt.Table(tctx, t._shards, [2**29, 2**29, 2**29, 2**29])  # counts only
    with pytest.raises(ValueError, match="int32"):
        big._global_rowid_column()
