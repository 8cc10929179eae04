"""The port's semi-join sketch filter (ops/sketch.py, table._pair_sketches,
the shuffle's semi gate, the planner's ``semi_filter`` rule) against the
JAX package's, on the CPU, both packages at their defaults for the semi
filter and lane packing, and the skew split on in both (its default). The
JAX side keeps the tiers the port has not ported off (``CYLON_TPU_NO_TOPO``,
``NO_AUTOTUNE``), and ``CYLON_TPU_NO_QUANT``.

The sketch words are compared bit for bit: each side's local sketch
(``build_local``), the combined sketch of a world (``combine_pair``; the
JAX one under ``jax.vmap`` with an axis name, which gives its
``all_gather``), and the probe masks, for int32, int64, dictionary and
nullable keys. Whole operations compare shard by shard, exactly (the
murmur3 routing and the round plans are the same), with the
``shuffle.semi_filter.*`` and ``lane_pack.*`` counters.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cylon_tpu as ct
import cylon_tpu_torch as ctt
from cylon_tpu.ops import sketch as jsk
from cylon_tpu.plan import lazy as jlazy
from cylon_tpu.utils import tracing as jtr
from cylon_tpu_torch import ordering as tord
from cylon_tpu_torch.ops import sketch as tsk
from cylon_tpu_torch.ops import stats as tst
from cylon_tpu_torch.plan import lazy as tlazy
from cylon_tpu_torch.utils import tracing as ttr
from test_torch_shuffle_slice import _contexts, _encode, _shards_equal

torch.set_num_threads(1)

#: the JAX package's tiers the port has not ported, off on its side
UNPORTED = ("CYLON_TPU_NO_QUANT", "CYLON_TPU_NO_TOPO", "CYLON_TPU_NO_AUTOTUNE")
#: the two default-on tiers of both packages, left at their defaults
TIERS = ("CYLON_TPU_NO_SEMI_FILTER", "CYLON_TPU_NO_LANE_PACK",
         "CYLON_TPU_TORCH_NO_SEMI_FILTER", "CYLON_TPU_TORCH_NO_LANE_PACK")
COUNTERS = ("shuffle.semi_filter.", "semi_filter.", "lane_pack.")


@pytest.fixture
def defaults(monkeypatch):
    for k in UNPORTED:
        monkeypatch.setenv(k, "1")
    for k in TIERS:
        monkeypatch.delenv(k, raising=False)
    jtr.reset_trace()
    ttr.reset_trace()


def counters(rep):
    """{name: (count, rows)} of the tier counters in a rollup report."""
    out = {}
    for prefix in COUNTERS:
        for k, v in rep(prefix).items():
            out[k] = (int(v["count"]), int(v.get("rows", 0)))
    return out


def counters_equal():
    got, want = counters(ttr.report), counters(jtr.report)
    assert got == want
    return got


def _gauge(rep, name):
    return rep(name).get(name, {}).get("total_s")


# ----------------------------------------------------------------------
# the sketch words, bit for bit
# ----------------------------------------------------------------------

def _key_cases(rng, n):
    k32 = rng.integers(-5000, 20000, n).astype(np.int32)
    return {
        "int32": (k32, None),
        "int64": (rng.integers(-(2**40), 2**40, n).astype(np.int64), None),
        "dictionary": (rng.integers(0, 300, n).astype(np.int32), None),  # codes
        "nullable": (k32, rng.random(n) > 0.2),
    }


@pytest.mark.parametrize("case", ["int32", "int64", "dictionary", "nullable"])
def test_sketch_words_and_probe_masks_match_reference(case):
    rng = np.random.default_rng(7)
    world, n, bits = 4, 900, 1 << 12
    data, valid = _key_cases(rng, n)[case]
    blocks = np.array_split(np.arange(n), world)

    def jcols(idx):
        return [(jnp.asarray(data[idx]), None if valid is None else jnp.asarray(valid[idx]))]

    def tcols(idx):
        return [(torch.from_numpy(data[idx]), None if valid is None else torch.from_numpy(valid[idx]))]

    for use_range in (False, True):
        j_local = np.stack([
            np.stack([np.asarray(jsk.build_local(jcols(b), jnp.int32(len(b)), bits, use_range))
                      for b in (blk, blk[::-1])])
            for blk in blocks
        ])  # [P, S=2, L]: a second "side" from the same keys reversed
        t_local = [torch.stack([tsk.build_local(tcols(b), bits, use_range) for b in (blk, blk[::-1])])
                   for blk in blocks]
        for p in range(world):
            np.testing.assert_array_equal(t_local[p].numpy().view(np.uint32), j_local[p])
        j_comb = np.asarray(jax.vmap(lambda x: jsk.combine_pair(x, "i", world), axis_name="i")(
            jnp.asarray(j_local)))
        comm = ctt.CylonContext.init_distributed(
            ctt.GPUConfig(device="cpu", world_size=world)).comm
        t_comb = tsk.combine_pair(t_local, comm)
        for p in range(world):
            np.testing.assert_array_equal(t_comb[p].numpy().view(np.uint32), j_comb[p])
        # probe keys: a third of the built ones, then as many new ones
        pdata = np.concatenate([data[::3], (data[::3] * 3 + 40001).astype(data.dtype)])
        pvalid = None if valid is None else np.concatenate([valid[::3], valid[::3]])
        pj = np.asarray(jsk.probe([(jnp.asarray(pdata), None if pvalid is None else jnp.asarray(pvalid))],
                                  jnp.asarray(j_comb[0][0]), use_range))
        pt = tsk.probe([(torch.from_numpy(pdata), None if pvalid is None else torch.from_numpy(pvalid))],
                       t_comb[0][0], use_range).numpy()
        np.testing.assert_array_equal(pt, pj)
        assert pt[: len(pt) // 2].all() and not pt.all()


def test_sketch_sizing_and_sides_match_reference():
    for rows in (0, 1, 1000, 5000, 10**6):
        for cap in (20, 32, 4096, 5000, 1 << 21):
            assert tsk.sketch_bits_for(rows, cap) == jsk.sketch_bits_for(rows, cap)
    for how in ("inner", "left", "right", "outer"):
        assert tsk.join_filter_sides(how) == jsk.join_filter_sides(how)
    for op in ("union", "subtract", "intersect"):
        assert tsk.setop_filter_sides(op) == jsk.setop_filter_sides(op)
    for dt, np_dt in ((torch.int32, np.int32), (torch.int64, np.int64), (torch.uint8, np.uint8),
                      (torch.float32, np.float32), (torch.float64, np.float64),
                      (torch.bool, np.bool_)):
        assert tsk.hash_class(dt) == jsk.hash_class(np_dt)
        assert tsk.range_class(dt) == jsk.range_class(np_dt)
    assert tsk.sketch_len(4096) == jsk.sketch_len(4096)
    assert (tsk.PROBE_BITS, tsk.RANGE_WORDS, tsk._SEED_WORD, tsk._SEED_BITS) == (
        jsk.PROBE_BITS, jsk.RANGE_WORDS, jsk._SEED_WORD, jsk._SEED_BITS)


# ----------------------------------------------------------------------
# whole operations, shard by shard
# ----------------------------------------------------------------------

def _pair(rng, n, sel, l_dtype=np.int32, r_dtype=np.int32, nulls=False):
    """benchmarks/semi_filter_bench.make_pair's shape at a small size: the
    left keys in [0, n), the right keys a fraction ``sel`` of them, the
    rest disjoint above them; a float32 payload a side."""
    lk = rng.permutation(n).astype(l_dtype)
    m = int(n * sel)
    rk = np.concatenate([rng.choice(lk, m, replace=False), np.arange(n, 2 * n - m)]).astype(r_dtype)
    left = {"k": lk, "v": rng.normal(size=n).astype(np.float32),
            "b": rng.integers(0, 9, n).astype(np.int32)}
    right = {"k": rng.permutation(rk), "w": rng.normal(size=n).astype(np.float32)}
    if nulls:
        for side in (left, right):
            k = side["k"].astype(object)
            k[rng.choice(n, n // 20, replace=False)] = None
            side["k"] = k
    return left, right


def _both(world, left, right):
    jctx, tctx = _contexts(world)
    l_enc, r_enc = _encode(left), _encode(right)
    return ((ct.Table.from_encoded(jctx, l_enc), ct.Table.from_encoded(jctx, r_enc)),
            (ctt.Table.from_encoded(tctx, l_enc), ctt.Table.from_encoded(tctx, r_enc)))


@pytest.mark.parametrize("world,how,nulls", [
    (4, "inner", False), (4, "left", True), (4, "right", False), (4, "outer", False),
    (2, "inner", True),
])
def test_distributed_join_matches_reference(defaults, world, how, nulls):
    rng = np.random.default_rng(world * 10 + len(how))
    left, right = _pair(rng, 1600, 0.1, nulls=nulls)
    (jl, jr), (tl, tr) = _both(world, left, right)
    _shards_equal(jl.distributed_join(jr, on="k", how=how),
                  tl.distributed_join(tr, on="k", how=how))
    got = counters_equal()
    if how == "outer":
        assert "semi_filter.sketch_bytes" not in got
    else:
        assert got["shuffle.semi_filter.applied"][0] >= 1, got


@pytest.mark.parametrize("op", ["intersect", "subtract"])
def test_distributed_setops_match_reference(defaults, op):
    rng = np.random.default_rng(3)
    n = 1600
    a = {"k": rng.permutation(n).astype(np.int32), "b": rng.integers(0, 3, n).astype(np.int32)}
    b = {"k": np.concatenate([a["k"][: n // 10], np.arange(n, 2 * n - n // 10)]).astype(np.int32),
         "b": rng.integers(0, 3, n).astype(np.int32)}
    (ja, jb), (ta, tb) = _both(4, a, b)
    _shards_equal(getattr(ja, "distributed_" + op)(jb), getattr(ta, "distributed_" + op)(tb))
    got = counters_equal()
    assert got["shuffle.semi_filter.applied"][0] >= 1, got


@pytest.mark.parametrize("sel,applied", [(0.1, True), (1.0, False)])
def test_semi_gate_applies_at_10_percent_and_skips_at_100(defaults, sel, applied):
    rng = np.random.default_rng(11)
    left, right = _pair(rng, 2400, sel)
    (jl, jr), (tl, tr) = _both(4, left, right)
    _shards_equal(jl.distributed_join(jr, on="k"), tl.distributed_join(tr, on="k"))
    got = counters_equal()
    took, other = "shuffle.semi_filter.applied", "shuffle.semi_filter.gate_skipped"
    if not applied:
        took, other = other, took
    assert got[took][0] == 2 and other not in got, got
    assert _gauge(ttr.report, "shuffle.semi_filter.selectivity") == pytest.approx(
        _gauge(jtr.report, "shuffle.semi_filter.selectivity"))
    if applied:
        assert got["shuffle.semi_filter.pruned_rows"][1] > 0


def test_kill_switch_gives_the_unfiltered_result(defaults):
    rng = np.random.default_rng(5)
    left, right = _pair(rng, 1600, 0.1)
    (_jl, _jr), (tl, tr) = _both(4, left, right)
    on = tl.distributed_join(tr, on="k")
    with tsk.disabled():
        ttr.reset_trace()
        off = tl.distributed_join(tr, on="k")
        assert not counters(ttr.report).get("shuffle.semi_filter.applied")
    with tsk.disabled(), tst.disabled():
        plain = tl.distributed_join(tr, on="k")
    for t in (on, off):
        for s in range(4):
            for c in plain.column_names:
                torch.testing.assert_close(t._shards[s][c].data, plain._shards[s][c].data,
                                           rtol=0, atol=0)


# ----------------------------------------------------------------------
# the planner: the semi_filter rule, -- stats:, fingerprints
# ----------------------------------------------------------------------

def test_explain_and_rules_match_reference_and_gates_miss_the_cache(defaults):
    rng = np.random.default_rng(2)
    left, right = _pair(rng, 1600, 0.1)
    right["rk"] = right.pop("k")
    (jl, jr), (tl, tr) = _both(4, left, right)
    # a shuffle measures every statable column: the scans print their widths
    jl, jr = jl.shuffle(["k"]), jr.shuffle(["rk"])
    tl, tr = tl.shuffle(["k"]), tr.shuffle(["rk"])

    def q(l, r):
        return l.lazy().join(r.lazy(), left_on="b", right_on="rk").groupby("b", {"v": "sum"})

    jq, tq = q(jl, jr), q(tl, tr)
    text = tq.explain()
    assert text == jq.explain()
    assert "semi-filter=both" in text and "-- stats:" in text
    ttr.reset_trace()
    jtr.reset_trace()
    _shards_equal(jq.collect(), tq.collect(), agg=True)
    assert {k: v["count"] for k, v in ttr.report("plan.rule.").items()} == {
        k: v["count"] for k, v in jtr.report("plan.rule.").items()}
    assert ttr.get_count("plan.rule.semi_filter") == 1
    counters_equal()
    # the gate counter families the JAX package renders per node
    want = {k: v["count"] for p in jlazy._GATE_PREFIXES for k, v in jtr.report(p).items()}
    assert {k: v["count"] for k, v in tlazy.gate_report().items()} == want
    for gate in (tsk.disabled, tst.disabled, tord.disabled):
        before = ttr.get_count("plan.cache.miss")
        with gate():
            tq.collect()
        assert ttr.get_count("plan.cache.miss") == before + 1, gate
    with tsk.disabled():
        assert "semi-filter" not in tq.explain()
