"""The port's lazy query planner against the JAX package's, on the CPU:
``Table.lazy()`` -> ``filter`` / ``select`` / ``join`` / ``groupby`` /
``sort`` / ``union`` / ``limit`` -> ``explain()`` and ``collect()`` in
cylon_tpu_torch and in cylon_tpu, over one host encoding made with numpy
from a fixed seed.

For every plan the port's ``explain()`` text (the logical plan, the
optimized plan with each node's derived order, the rules that fired) equals
the JAX package's character for character, and so do the ``plan.rule.*``
and ``ordering.*`` counters a collect bumps. Results compare shard by shard
at worlds 1 and 4: keys and counts exactly, in the order the plan defines
(a groupby's key order, a sort); float32 sums at rtol 1e-5 and float64 at
rtol 1e-6 (tests/test_torch_slice.py), since segment sums add in another
order. Both packages run with their shuffle tiers off: the JAX side under
``CYLON_TPU_NO_SEMI_FILTER``, ``CYLON_TPU_NO_LANE_PACK`` and the other
tiers' switches, the port under ``CYLON_TPU_TORCH_NO_SEMI_FILTER`` and
``CYLON_TPU_TORCH_NO_LANE_PACK`` (tests/test_torch_semi_filter.py holds
the ``semi_filter`` rule and the ``-- stats:`` text with both on). The JAX
side's sort and emit are its defaults, as in
tests/test_torch_shuffle_slice.py: with its sort forced through the Pallas
radix pass in interpret mode, its fused join-sum kernel fails on a key
that carries a validity mask (every filtered key does, in the JAX package),
the reference fault of ROADMAP.md C. Both configurations give the same
output.
"""
import numpy as np
import pandas as pd
import pytest
import torch

import cylon_tpu as ct
import cylon_tpu_torch as ctt
from cylon_tpu.plan import rules as jrules
from cylon_tpu.utils import tracing as jtr
from cylon_tpu_torch.plan import rules as trules
from cylon_tpu_torch.utils import tracing as ttr
from test_torch_shuffle_slice import _contexts, _shard_frame, _shards_equal

torch.set_num_threads(1)

REF_ENV = ("CYLON_TPU_NO_SEMI_FILTER", "CYLON_TPU_NO_LANE_PACK", "CYLON_TPU_NO_QUANT",
           "CYLON_TPU_NO_TOPO", "CYLON_TPU_NO_AUTOTUNE",
           "CYLON_TPU_TORCH_NO_SEMI_FILTER", "CYLON_TPU_TORCH_NO_LANE_PACK")


@pytest.fixture
def ref(monkeypatch):
    for k in REF_ENV:
        monkeypatch.setenv(k, "1")


def _encode(cols):
    return {k: ct.Column.encode_host(np.asarray(v)) for k, v in cols.items()}


def _data(seed=0, n=600):
    """A left side with repeated keys and a right side of unique keys, so
    that a join's output stays inside the JAX package's speculative
    capacity (past it, its key-order emit falls back to left order with no
    descriptor, a path the port does not have: ROADMAP.md C)."""
    rng = np.random.default_rng(seed)
    a = {"k": rng.integers(0, n // 2, n).astype(np.int32),
         "v": rng.normal(size=n).astype(np.float32),
         "extra": rng.normal(size=n)}
    b = {"rk": rng.permutation(n // 2).astype(np.int32),
         "w": rng.normal(size=n // 2).astype(np.float32)}
    return a, b


def _both(world, *sides):
    """Each side as (JAX table, port table) on the world's contexts."""
    jctx, tctx = _contexts(world)
    out = []
    for cols in sides:
        enc = _encode(cols)
        out.append((ct.Table.from_encoded(jctx, enc), ctt.Table.from_encoded(tctx, enc)))
    return out


def _run(build, tables, agg=True):
    """``build(pkg, *tables)`` -> LazyFrame in each package: the explain
    texts and the plan/ordering counters of one collect are equal, and the
    results equal shard by shard. Returns the port's result."""
    lj = build(ct, *[j for j, _t in tables])
    lt = build(ctt, *[t for _j, t in tables])
    assert lt.explain() == lj.explain()
    world = lt._ctx.world_size  # the rules fire in the same order too
    assert trules.optimize(lt.plan, world)[1] == jrules.optimize(lj.plan, world)[1]
    jtr.reset_trace()
    ttr.reset_trace()
    want, got = lj.collect(), lt.collect()
    for prefix in ("plan.rule.", "ordering."):
        assert {k: v["count"] for k, v in ttr.report(prefix).items()} == {
            k: v["count"] for k, v in jtr.report(prefix).items()}, prefix
    _shards_equal(want, got, agg=agg)
    return got


def _q3(pkg, a, b):
    return a.lazy().join(b.lazy(), left_on="k", right_on="rk").groupby("k", {"v": "sum"})


def _acceptance(pkg, a, b):
    return (a.lazy().join(b.lazy(), left_on="k", right_on="rk")
            .filter(pkg.col("w") > 0.0).groupby("k", {"v": "sum"}))


def _multi_agg(pkg, a, b):
    return a.lazy().join(b.lazy(), left_on="k", right_on="rk").groupby("k", {"v": ["sum", "mean"]})


@pytest.mark.parametrize("world", [1, 4])
def test_acceptance_filter_join_groupby_sum(ref, world):
    """plan_bench.py's query: filter pushdown below the join's right side,
    the fused join-sum, projection pushdown, and at world 4 the groupby's
    shuffle eliminated; equal to the eager join -> filter -> groupby."""
    (a, b) = _both(world, *_data())
    got = _run(_acceptance, [a, b])
    text = _acceptance(ctt, *[t for _j, t in (a, b)]).explain()
    rules = [trules.FILTER_PUSHDOWN, trules.PROJECTION_PUSHDOWN, trules.FUSED_JOIN_GROUPBY]
    if world > 1:
        rules.append(trules.SHUFFLE_ELIM)
    for rule in rules:
        assert rule in text
    ta, tb = a[1], b[1]
    j = ta.distributed_join(tb, left_on="k", right_on="rk")
    eager = j.filter(j._per_shard(lambda s: j._shards[s]["w"].data > 0.0)).distributed_groupby(
        "k", {"v": "sum"})
    e = eager.to_pandas().sort_values("k", kind="stable")
    g = got.to_pandas().sort_values("k", kind="stable")
    np.testing.assert_array_equal(g["k"].to_numpy(), e["k"].to_numpy())
    np.testing.assert_allclose(g["v_sum"], e["v_sum"], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("world", [1, 4])
def test_lazy_q3_matches_reference_shard_by_shard(ref, world):
    (a, b) = _both(world, *_data())
    got = _run(_q3, [a, b])
    assert got.ordering.keys == ("k",) and got.ordering.canonical


@pytest.mark.parametrize("world", [1, 4])
def test_order_reuse_multi_aggregate(ref, world):
    """A groupby the fused rule does not take (two aggregates): order_reuse
    flips the join to the key-order emit and the groupby run-detects."""
    (a, b) = _both(world, *_data())
    _run(_multi_agg, [a, b])
    assert ttr.get_count("plan.rule.order_reuse") == 1
    assert ttr.get_count("ordering.groupby_run_detect") == 1
    assert ttr.get_count("ordering.join_key_order_emit") == 1


@pytest.mark.parametrize("world", [1, 4])
def test_sort_limit_union(ref, world):
    """At world 4 a sort (a range shuffle, then the local sort: a global
    order); at world 1 a sort elided over a sorted scan, head, and union."""
    (a, b) = _both(world, *_data())
    if world > 1:
        def sort_desc(pkg, a, b):
            return a.lazy().filter(pkg.col("v") > 0.0).sort(["k", "v"], [True, False]).select("k")

        got = _run(sort_desc, [a, b], agg=False)
        k = got.to_pandas()["k"].to_numpy()
        assert (np.diff(k) >= 0).all() and "Shuffle range [k]" in sort_desc(ctt, a[1], b[1]).explain()
        return

    def union(pkg, a, b):
        lo = a.lazy().select(["k", "v"]).filter(pkg.col("v") > 0.5)
        return lo.union(a.lazy().select(["k", "v"])).filter(pkg.col("k") < 30)

    _run(union, [a, b], agg=False)
    sa = (a[0].sort("k"), a[1].sort("k"))

    def elided(pkg, s, b):
        return s.lazy().sort("k").head(25)

    got = _run(elided, [sa, b], agg=False)
    assert got.row_count == 25
    assert trules.ORDER_REUSE in elided(ctt, sa[1], None).explain()


def test_string_key_join_and_string_literal_filter(ref):
    rng = np.random.default_rng(3)
    words = np.array([f"s{i:02d}" for i in range(30)], dtype=object)
    left = {"s": rng.choice(words, 400), "v": rng.normal(size=400).astype(np.float32)}
    right = {"s": rng.permutation(words[5:]), "w": rng.normal(size=25)}
    (a, b) = _both(1, left, right)

    def q(pkg, a, b):
        return (a.lazy().filter(pkg.col("s") >= "s10")
                .join(b.lazy().filter(pkg.lit("s20") != pkg.col("s")), on="s")
                .groupby("s_x", {"w": "sum"}))

    _run(q, [a, b])


def test_dataframe_lazy(ref):
    a, b = _data(1, n=300)
    jctx, tctx = _contexts(1)
    jd = ct.DataFrame(pd.DataFrame(a), ctx=jctx)
    td = ctt.DataFrame(pd.DataFrame(a), ctx=tctx)
    jb = ct.Table.from_encoded(jctx, _encode(b))
    tb = ctt.Table.from_encoded(tctx, _encode(b))
    _run(_q3, [(jd, td), (jb, tb)])


def test_plan_cache_hit_and_no_stale_alias(ref):
    """A second collect of the same plan, and of a fresh plan of the same
    shape over fresh tables, hits the cache; a scan whose table was changed
    in place (its order descriptor dropped) gets its own entry."""
    (a, b) = _both(1, *_data())
    ta, tb = a[1], b[1]
    ttr.reset_trace()
    first = _acceptance(ctt, ta, tb).collect()
    hits = ttr.get_count("plan.cache.hit")
    _acceptance(ctt, ta, tb).collect()
    (a2, b2) = _both(1, *_data(seed=7))
    third = _acceptance(ctt, a2[1], b2[1]).collect()
    assert ttr.get_count("plan.cache.hit") == hits + 2
    assert third.column_names == first.column_names
    s = ta.sort("k")
    lf = s.lazy().sort("k")
    assert trules.ORDER_REUSE in lf.explain()
    lf.collect()
    hits = ttr.get_count("plan.cache.hit")
    s["k"] = np.random.default_rng(1).permutation(s.to_pandas()["k"].to_numpy())
    assert s.ordering is None and trules.ORDER_REUSE not in lf.explain()
    out = lf.collect().to_pandas()["k"].to_numpy()
    assert ttr.get_count("plan.cache.hit") == hits
    assert (np.diff(out) >= 0).all(), "a stale scan descriptor elided a needed sort"


def test_filter_stays_above_outer_join(ref):
    (a, b) = _both(1, *_data())

    def q(pkg, a, b):
        return a.lazy().join(b.lazy(), left_on="k", right_on="rk", how="outer").filter(
            pkg.col("w") > 0.0)

    text = q(ctt, a[1], b[1]).explain()
    assert trules.FILTER_PUSHDOWN not in text
    _run(q, [a, b], agg=False)


def test_chained_join_no_subset_elision(ref):
    """A join on (k, j) then a join on k alone: the first output is placed
    by (k, j), which co-locates equal k but routes them elsewhere than a
    hash of k, so the second join's shuffle stays."""
    rng = np.random.default_rng(5)
    x = {"k": rng.integers(0, 40, 300).astype(np.int32), "j": rng.integers(0, 3, 300).astype(np.int32),
         "v": rng.normal(size=300).astype(np.float32)}
    pairs = rng.permutation(120)
    y = {"k": (pairs // 3).astype(np.int32), "j": (pairs % 3).astype(np.int32)}
    z = {"k": rng.permutation(40).astype(np.int32), "u": rng.normal(size=40)}
    (a, b, c) = _both(4, x, y, z)

    def q(pkg, a, b, c):
        return a.lazy().join(b.lazy(), on=["k", "j"]).join(c.lazy(), left_on="k_x", right_on="k")

    text = q(ctt, a[1], b[1], c[1]).explain()
    assert text == q(ct, a[0], b[0], c[0]).explain()
    assert text.split("== Optimized plan ==")[1].count("Shuffle hash") == 4
    # the eager joins stand for the JAX side's collect here (held against
    # it shard by shard in tests/test_torch_shuffle_slice.py), which would
    # compile four more shuffles
    want = a[1].distributed_join(b[1], on=["k", "j"]).distributed_join(
        c[1], left_on="k_x", right_on="k")
    got = q(ctt, a[1], b[1], c[1]).collect()
    np.testing.assert_array_equal(got.row_counts, want.row_counts)
    for sh in range(4):
        pd.testing.assert_frame_equal(_shard_frame(got, sh, True), _shard_frame(want, sh, True))


def test_integer_sum_does_not_fuse(ref):
    """The fused join-sum takes float32 left values only: an int32 sum keeps
    the join and the groupby (order_reuse flips the join instead)."""
    a, b = _data(4, n=300)
    a["v"] = (a["v"] * 100).astype(np.int32)
    (ja, jb) = _both(1, a, b)
    _run(_q3, [ja, jb])
    assert ttr.get_count("plan.rule.fused_join_groupby") == 0
    assert ttr.get_count("plan.rule.order_reuse") == 1


def test_tracing_rollup_matches_reference():
    """The counter and span rollup of both packages: counts by name and
    prefix, a span's count and host seconds, and a reset."""
    for tr in (jtr, ttr):
        tr.reset_trace()
        tr.bump("plan.rule.x")
        tr.bump("plan.rule.x")
        with tr.span("plan.unit"):
            pass
    for tr in (jtr, ttr):
        assert tr.get_count("plan.rule.x") == 2 and tr.get_count("plan.unit") == 1
        assert set(tr.report("plan.rule.")) == {"plan.rule.x"}
        assert tr.report("plan.unit")["plan.unit"]["total_s"] >= 0.0
        tr.reset_trace()
        assert tr.get_count("plan.rule.x") == 0 and tr.report("plan.") == {}
