"""The port's selection surface against the JAX package on the CPU:
``project``, ``drop``, ``add_prefix``, ``add_suffix``, ``add_column``,
``filter``, ``select``, ``take``, ``hash_partition`` and ``concat`` /
``merge``, fed one host encoding made with numpy from a fixed seed, at
worlds 1 and 4.

Every comparison is exact and shard by shard, in order: these ops keep rows
in table order within each shard (``take`` re-splits its output evenly, in
both packages), and ``hash_partition`` routes by the same murmur3 hash.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cylon_tpu as ct
import cylon_tpu_torch as ctt
from cylon_tpu_torch.dtypes import numpy_dtype, promote_concat_dtypes
from test_torch_shuffle_slice import _contexts, _encode, _shards_equal

torch.set_num_threads(1)

WORLDS = [1, 4]


def _cols(rng, n, words=("ant", "bee", "cat", "dog")):
    b = rng.random(n) < 0.5
    b_obj = b.astype(object)
    b_obj[rng.random(n) < 0.1] = None  # a nullable bool mask column
    return {
        "k": rng.integers(0, 9, n).astype(np.int32),
        "x": np.where(rng.random(n) < 0.1, np.nan, rng.normal(size=n)),  # nullable float64
        "s": rng.choice(list(words), n).astype(object),
        "b": b_obj,
    }


def _both(world, cols):
    jctx, tctx = _contexts(world)
    enc = _encode(cols)
    return ct.Table.from_encoded(jctx, enc), ctt.Table.from_encoded(tctx, enc)


@pytest.mark.parametrize("world", WORLDS)
def test_column_surface_matches_reference(rng, world):
    jt, tt = _both(world, _cols(rng, 300))
    for call in (
        lambda t: t.project(["s", "k"]),
        lambda t: t.project([2, 0]),
        lambda t: t.drop(["x", "b"]),
        lambda t: t.add_prefix("p_"),
        lambda t: t.add_suffix("_q").project(["k_q"]),
    ):
        _shards_equal(call(jt), call(tt))
    want = jt.add_column("k2", jt.column("k"))
    _shards_equal(want, tt.add_column("k2", tt.column("k")))  # one Column over all rows
    per_shard = [sh["x"] for sh in tt._shards]
    _shards_equal(jt.add_column("k", jt.column("x")), tt.add_column("k", per_shard))
    with pytest.raises(TypeError):
        tt.add_column("h", np.zeros(300))
    with pytest.raises(ValueError):
        tt.add_column("h", tt.take([0]).column("k"))


@pytest.mark.parametrize("world", WORLDS)
def test_filter_and_select_match_reference(rng, world):
    """Every mask form: a nullable bool Column (a null drops the row), a
    one-column Table, a host mask, a bool tensor per shard, a predicate."""
    jt, tt = _both(world, _cols(rng, 400))
    _shards_equal(jt.filter(jt.column("b")), tt.filter(tt.column("b")))
    _shards_equal(jt.filter(jt.project(["b"])), tt.filter(tt.project(["b"])))
    host = rng.random(400) < 0.3
    want = jt.filter(host)
    _shards_equal(want, tt.filter(host))
    _shards_equal(want, tt.filter(list(host)))
    _shards_equal(want, tt.filter(tt._split_rows(torch.from_numpy(host))))
    _shards_equal(jt.select(lambda e: e["k"] > 4), tt.select(lambda e: e["k"] > 4))
    _shards_equal(jt.filter(np.zeros(400, bool)), tt.filter(np.zeros(400, bool)))
    with pytest.raises(ValueError):
        tt.filter(host[:-1])


@pytest.mark.parametrize("world", WORLDS)
def test_take_matches_reference(rng, world):
    jt, tt = _both(world, _cols(rng, 250))
    for idx in ([0, -1, 7, 7, 249, 3, -250], rng.integers(-250, 250, 90), []):
        _shards_equal(jt.take(idx), tt.take(idx))
    for bad in ([250], [-251]):
        with pytest.raises(IndexError):
            tt.take(bad)


@pytest.mark.parametrize("world", WORLDS)
def test_hash_partition_matches_reference(rng, world):
    jt, tt = _both(world, _cols(rng, 300))
    for keys, k in ((["k"], 3), (["s", "k"], 4)):
        jp, tp = jt.hash_partition(keys, k), tt.hash_partition(keys, k)
        assert sorted(tp) == sorted(jp) == list(range(k))
        for p in range(k):
            _shards_equal(jp[p], tp[p])
        assert sum(t.row_count for t in tp.values()) == 300


@pytest.mark.parametrize("world", WORLDS)
def test_concat_matches_reference(rng, world):
    """Three tables with their own string dictionaries, an int32 column
    against an int64 one (the JAX package's promotion), a validity mask
    on one side only."""
    a = _cols(rng, 120)
    b = _cols(rng, 90, ("cat", "eel", "fox"))
    c = _cols(rng, 70, ("gnu",))
    b["k"] = b["k"].astype(np.int64) * 1000
    c["x"] = rng.normal(size=70)  # no nulls: no validity
    jctx, tctx = _contexts(world)
    encs = [_encode(t) for t in (a, b, c)]
    jts = [ct.Table.from_encoded(jctx, e) for e in encs]
    tts = [ctt.Table.from_encoded(tctx, e) for e in encs]
    got = ctt.Table.concat(tts)
    _shards_equal(ct.Table.concat(jts), got)
    assert got.row_count == 280 and got.to_pandas()["k"].dtype == np.int64
    _shards_equal(ct.Table.merge(jts[:2]), ctt.Table.merge(tts[:2]))
    assert ctt.Table.concat(tts[:1]) is tts[0]
    for bad in ([], [tts[0], "x"]):
        with pytest.raises(ValueError):
            ctt.Table.concat(bad)
    with pytest.raises(ValueError, match="identical schemas"):
        ctt.Table.concat([tts[0], tts[1].project(["k"])])
    with pytest.raises(ValueError, match="axis"):
        ctt.Table.concat(tts, axis=2)


DTYPES = [torch.bool, torch.uint8, torch.int8, torch.int16, torch.uint16, torch.int32,
          torch.uint32, torch.int64, torch.uint64, torch.float16, torch.float32, torch.float64]


def test_concat_promotion_is_the_reference_lattice():
    for a, b in itertools.product(DTYPES, DTYPES):
        want = jnp.promote_types(numpy_dtype(a), numpy_dtype(b))
        assert numpy_dtype(promote_concat_dtypes(a, b)) == np.dtype(want), (a, b)
