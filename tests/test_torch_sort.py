"""The port's sorts against the JAX package on the CPU: ``Table.sort``,
``range_partition_ids`` and ``distributed_sort``, fed one host encoding made
with numpy from a fixed seed.

Every comparison is exact (a stable sort has one answer; the range bins are
integer functions of float64 arithmetic done in the same order). World 1
compares whole tables in order, with the JAX side's sorts forced through
its Pallas radix pass (``CYLON_TPU_SORT_IMPL=radix_pallas``, interpret
mode here). World > 1 compares shard by shard, in order: the range shuffle
sends every row to the same shard in both packages, in the same
(round, source shard, row) arrival order, and the local sort is stable.
There the JAX side runs its default sort with the shuffle tiers the port
has not ported switched off, as in tests/test_torch_shuffle_slice.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cylon_tpu as ct
import cylon_tpu_torch as ctt
from cylon_tpu.ops import partition as jpart
from cylon_tpu_torch.ops import partition as tpart
from test_torch_shuffle_slice import (  # noqa: F401
    _contexts, _encode, _shards_equal, budget, ref_env, rounds,
)

torch.set_num_threads(1)


@pytest.fixture
def pallas_sort(monkeypatch):
    monkeypatch.setenv("CYLON_TPU_SORT_IMPL", "radix_pallas")


def _with_nulls(rng, values, n_null):
    out = values.astype(object)
    out[rng.choice(len(out), n_null, replace=False)] = None
    return out


def _sort_table(rng, n):
    """Keys with ties, nulls, NaN, +-0.0 and +-inf, a string key, and a
    payload that tells equal-key rows apart (stability)."""
    f = rng.choice([-1.5, -0.0, 0.0, 2.5, np.inf, -np.inf, np.nan], n)
    return {
        "a": rng.integers(0, 6, n).astype(np.int32),
        "b": _with_nulls(rng, rng.integers(-20, 20, n), max(n // 20, 0)),  # int64 + validity
        "f32": f.astype(np.float32),
        "f64": rng.choice([-3.0, -0.0, 0.0, 1.0, np.inf, np.nan], n),
        "s": rng.choice(["pear", "fig", "apple", "kiwi"], n).astype(object),
        "u": rng.integers(0, 2**63, n, dtype=np.uint64),
        "pay": np.arange(n, dtype=np.int32),
    }


@pytest.mark.parametrize(
    "n,order_by,ascending",
    [
        (900, ["a", "b"], [True, False]),           # multi-key, nullable int64
        (900, ["f32", "a"], [False, True]),         # NaN, +-0, +-inf, descending
        (900, "f64", True),                         # float64 declines the radix engine
        (900, ["s", "f64", "u"], [False, True, False]),  # string, uint64
        (0, ["a", "s"], True),
        (1, ["b", "f32"], False),
    ],
)
def test_sort_matches_reference(rng, ref_env, pallas_sort, n, order_by, ascending):
    jctx, tctx = _contexts(1)
    enc = _encode(_sort_table(rng, n))
    jt, tt = ct.Table.from_encoded(jctx, enc), ctt.Table.from_encoded(tctx, enc)
    _shards_equal(jt.sort(order_by, ascending), tt.sort(order_by, ascending))


def _pid_cases(rng, n):
    big = rng.integers(2**53, 2**62, n)  # past float64's exact integers
    f = rng.normal(size=n) * 1e6
    f[rng.random(n) < 0.1] = np.nan
    return {
        "int32": (rng.integers(-1000, 1000, n).astype(np.int32), None),
        "int64_past_2^53": (big, None),
        "uint64": (rng.integers(0, 2**64, n, dtype=np.uint64), None),
        "float64_nan": (f, None),
        "float32_inf": (np.where(rng.random(n) < 0.05, np.inf, f).astype(np.float32), None),
        "int32_nulls": (rng.integers(0, 50, n).astype(np.int32), rng.random(n) > 0.2),
        "all_equal": (np.full(n, 7, np.int64), None),
    }


@pytest.mark.parametrize("case", list(_pid_cases(np.random.default_rng(0), 8)))
@pytest.mark.parametrize("ascending", [True, False])
def test_range_partition_ids_match_reference(case, ascending):
    """Pid for pid against the JAX function in its local mode on all rows:
    lo, hi and the histogram are global, so a row's pid does not depend on
    the shard it lies in, and the port's four shards (through
    ``all_reduce``) must give the JAX pids of the whole column."""
    rng = np.random.default_rng(7)
    data, valid = _pid_cases(rng, 1000)[case]
    P, nb = 4, 37
    want = np.asarray(jpart.range_partition_ids(
        (jnp.asarray(data), None if valid is None else jnp.asarray(valid)),
        len(data), P, num_bins=nb, ascending=ascending,
    ))
    tctx = _contexts(4)[1]
    cuts = [0, 100, 100, 640, 1000]  # an empty shard too
    keys = [
        (torch.from_numpy(data[lo:hi].copy()),
         None if valid is None else torch.from_numpy(valid[lo:hi].copy()))
        for lo, hi in zip(cuts, cuts[1:])
    ]
    got = tpart.range_partition_ids(keys, P, tctx.comm, nb, ascending)
    assert all(g.dtype == torch.int32 for g in got)
    np.testing.assert_array_equal(torch.cat(got).numpy(), want)
    # an infinite key makes the span infinite and every bin 0, in both
    # packages: one partition takes every row (ROADMAP.md C)
    assert (len(np.unique(want)) == 1) == (case in ("all_equal", "float32_inf"))


def test_all_reduce_over_shards():
    comm = _contexts(4)[1].comm
    parts = [torch.tensor([s, 10 - s, 3], dtype=torch.int64) for s in range(4)]
    for op, want in (("sum", [6, 34, 12]), ("min", [0, 7, 3]), ("max", [3, 10, 3])):
        got = comm.all_reduce(parts, op)
        assert len(got) == 4 and all(g.tolist() == want for g in got)
    with pytest.raises(ValueError):
        comm.all_reduce(parts, "prod")


@pytest.mark.parametrize("world", [1, 2, 4, 8])
def test_distributed_sort_matches_reference(rng, ref_env, budget, rounds, world):
    """The range shuffle on the first key, then the local sort; the second
    call descends on a nullable first key at a small byte budget (several
    rounds), with num_bins given."""
    jctx, tctx = _contexts(world)
    enc = _encode(_sort_table(rng, 1200))
    jt, tt = ct.Table.from_encoded(jctx, enc), ctt.Table.from_encoded(tctx, enc)
    got = tt.distributed_sort(["f32", "pay"])
    _shards_equal(jt.distributed_sort(["f32", "pay"]), got)
    assert got.row_count == 1200
    budget(world, world * 64 * 32)
    rounds.clear()
    got = tt.distributed_sort(["b", "s"], [False, True], num_bins=50)
    _shards_equal(jt.distributed_sort(["b", "s"], [False, True], num_bins=50), got)
    assert world == 1 or rounds[0][1] > 1, rounds


def test_distributed_sort_routes_through_range_pids(rng, monkeypatch):
    """Every row of a world > 1 distributed_sort goes through
    range_partition_ids and B2a's pid mode, and the shards come out in
    global order."""
    from cylon_tpu_torch.ops import cuda_codec

    seen = []
    orig = cuda_codec.pack_hist
    monkeypatch.setattr(cuda_codec, "pack_hist", lambda *a, pid=None: (
        seen.append(pid), orig(*a, pid=pid))[1])
    tctx = _contexts(4)[1]
    k = rng.normal(size=2000)
    t = ctt.Table.from_pydict(tctx, {"k": k})
    out = t.distributed_sort("k")
    assert len(seen) == 4 and all(p is not None for p in seen)
    assert sum(p.shape[0] for p in seen) == 2000
    np.testing.assert_array_equal(out.to_pydict()["k"], np.sort(k))
    assert min(out.row_counts) > 0
