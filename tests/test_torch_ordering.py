"""The port's order descriptors against the JAX package's, on the CPU: the
``Ordering`` functions, what each op attaches, carries and drops, every
consumer's fast path (``ordering.*`` counters), the key-order join emit and
the fused join-sum pushdown, fed one host encoding made with numpy from a
fixed seed.

Each consumer is held twice: against the JAX package on the same tables
(the same rows in the same order, the same counters bumped), and against
the port itself under ``ordering.disabled()``, where every op takes the
path of an unordered input. Keys, counts and row order compare exactly;
float32 sums at rtol 1e-5 and float64 at rtol 1e-6
(tests/test_torch_slice.py). At world 1 the JAX side sorts through its
Pallas radix pass and emits through its windowed expand (interpret mode);
at world 4 it runs its default sort and emit, as in
tests/test_torch_shuffle_slice.py (ROADMAP.md C). Joins stay inside its
speculative capacity: past it, its key-order emit falls back to left order
with no descriptor, a path the port does not have (ROADMAP.md C).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import cylon_tpu as ct
import cylon_tpu_torch as ctt
from cylon_tpu import ordering as jord
from cylon_tpu.ops import join as jjoin
from cylon_tpu.utils import tracing as jtr
from cylon_tpu_torch import ordering as tord
from cylon_tpu_torch.ops import join as tjoin
from cylon_tpu_torch.utils import tracing as ttr
from test_torch_shuffle_slice import _contexts, _shard_frame, _shards_equal, rounds  # noqa: F401

torch.set_num_threads(1)

REF_ENV = ("CYLON_TPU_NO_SEMI_FILTER", "CYLON_TPU_NO_LANE_PACK", "CYLON_TPU_NO_QUANT",
           "CYLON_TPU_NO_TOPO", "CYLON_TPU_NO_AUTOTUNE",
           "CYLON_TPU_TORCH_NO_SEMI_FILTER", "CYLON_TPU_TORCH_NO_LANE_PACK")


@pytest.fixture
def ref(monkeypatch):
    for k in REF_ENV:
        monkeypatch.setenv(k, "1")
    monkeypatch.setenv("CYLON_TPU_SORT_IMPL", "radix_pallas")
    monkeypatch.setenv("CYLON_TPU_EMIT_IMPL", "windowed")


@pytest.fixture
def ref4(monkeypatch):
    for k in REF_ENV:
        monkeypatch.setenv(k, "1")


def _encode(cols):
    return {k: ct.Column.encode_host(np.asarray(v)) for k, v in cols.items()}


def _sides(seed=0, n=600, null_v=False):
    """A left side with repeated keys (k, and v with ties), a right side of
    unique keys: joins stay inside the JAX package's speculative capacity."""
    rng = np.random.default_rng(seed)
    v = rng.integers(0, 8, n).astype(np.float32) / 4
    a = {"k": rng.integers(0, n // 2, n).astype(np.int32), "v": v,
         "x": rng.normal(size=n)}
    if null_v:
        a["v"] = np.where(rng.random(n) < 0.1, np.nan, v)
    b = {"k": rng.permutation(n // 2).astype(np.int32), "w": rng.normal(size=n // 2).astype(np.float32)}
    return a, b


def _both(world, *sides):
    jctx, tctx = _contexts(world)
    return [(ct.Table.from_encoded(jctx, _encode(c)), ctt.Table.from_encoded(tctx, _encode(c)))
            for c in sides]


def _counts(tr):
    return {k: v["count"] for k, v in tr.report("ordering.").items()}


def _consumer(op, pair, agg=False):
    """``op(table...)`` in both packages and in the port with the gate off:
    equal results, and the same ordering counters as the JAX package."""
    jtr.reset_trace()
    ttr.reset_trace()
    want = op(*[j for j, _t in pair])
    got = op(*[t for _j, t in pair])
    assert _counts(ttr) == _counts(jtr) and _counts(ttr), _counts(ttr)
    _shards_equal(want, got, agg=agg)
    with tord.disabled():
        ttr.reset_trace()
        plain = op(*[t for _j, t in pair])
        # only the key-order emit, which the caller asks for, still counts
        assert set(_counts(ttr)) <= {"ordering.join_key_order_emit"}
    for s in range(len(got.row_counts)):
        fg, fp = _shard_frame(got, s, True), _shard_frame(plain, s, True)
        if agg:
            np.testing.assert_allclose(fg.select_dtypes("number"), fp.select_dtypes("number"),
                                       rtol=1e-5, atol=1e-5)
        else:
            assert fg.equals(fp)
    assert got.ordering == want.ordering
    return got


# ----------------------------------------------------------------------
# the descriptor and its life cycle
# ----------------------------------------------------------------------
_O = dict(keys=("a", "b"), ascending=(True, True))
_CASES = [
    ("validate", (dict(_O), ["a", "b"])),
    ("validate", (dict(_O, keys=("a", "z")), ["a", "b"])),
    ("validate", (dict(_O, keys=()), ["a"])),
    ("validate", (dict(_O, ascending=(True,)), ["a", "b"])),
    ("validate", (dict(_O, scope="world"), ["a", "b"])),
    ("validate", (dict(_O, ascending=(True, False), canonical=True), ["a", "b"])),
    ("covers_prefix", (dict(_O, canonical=True), ["a"])),
    ("covers_prefix", (dict(_O), ["a"])),
    ("covers_prefix", (dict(_O), ["b"])),
    ("matches_sort_spec", (dict(_O, lexsort_exact=True), ["a", "b", "c"], [True, True, True])),
    ("matches_sort_spec", (dict(_O, lexsort_exact=True), ["a"], [False])),
    ("matches_sort_spec", (dict(_O), ["a"], [True])),
    ("rename", (dict(_O), {"a": "x"})),
    ("truncate_to", (dict(_O), ["a", "c"])),
    ("truncate_to", (dict(_O), ["b"])),
]


@pytest.mark.parametrize("i", range(len(_CASES)))
def test_descriptor_functions_match_reference(i):
    name, (fields, *rest) = _CASES[i]
    results = []
    for mod in (jord, tord):
        try:
            r = getattr(mod, name)(mod.Ordering(**fields), *rest)
            results.append(tuple(r) if isinstance(r, tuple) else r)
        except (TypeError, ValueError) as e:
            results.append(type(e))
    assert results[0] == results[1]
    with tord.disabled():
        assert not tord.covers_prefix(tord.Ordering(**dict(_O, canonical=True)), ["a"])


def test_ops_attach_carry_and_drop_like_reference(ref):
    (a, _b) = _both(1, *_sides())
    got = []
    for t in (a[0], a[1]):
        s = t.sort(["k", "v"])
        outs = [s, s.filter(np.asarray(s.to_pandas()["x"] > 0)), s.project(["k"]),
                s.project(["v"]), s.rename({"k": "key"}), s.drop(["v"]), s.set_index("k"),
                s.unique(["k"]), s.take([0, 1, 2]), t.groupby("k", {"v": "sum"}),
                s.sort("k", ascending=False)]
        got.append([None if o.ordering is None else tuple(o.ordering) for o in outs])
        with pytest.raises(ValueError):
            t.with_ordering(type(s.ordering)(keys=("zz",), ascending=(True,)))
    assert got[1] == got[0]
    assert got[1][0] == (("k", "v"), (True, True), True, "shard", True, True)


@pytest.mark.parametrize("budget_bytes", [None, 2048])
def test_shuffle_drops_the_descriptor(budget_bytes, rounds):
    """At one round and at several (a K > 1 shuffle interleaves the rounds'
    key ranges on a shard)."""
    tctx = _contexts(4)[1]
    rng = np.random.default_rng(4)
    t = ctt.Table.from_pydict(tctx, {"k": rng.integers(0, 50, 4000).astype(np.int32),
                                     "v": rng.normal(size=4000)})
    s = t.sort("k")
    assert s.ordering is not None
    out = s.shuffle(["k"], byte_budget=budget_bytes)
    assert out.ordering is None
    assert (rounds[-1][1] > 1) == (budget_bytes is not None)


def test_inplace_mutation_drops_descriptor(ref):
    (a, _b) = _both(1, *_sides())
    for t in (a[0], a[1]):
        s = t.sort("k")
        s["v2"] = np.arange(s.row_count, dtype=np.float32)
        assert s.ordering is None
        e = t.sort("k").sort("k")  # elided: a fresh handle, the source untouched
        e["z"] = np.zeros(e.row_count, np.float32)
        assert "z" not in t.sort("k").column_names


# ----------------------------------------------------------------------
# the consumers, each against the JAX package and the gate-off oracle
# ----------------------------------------------------------------------
def test_sort_elided_and_suffix(ref):
    (a, _b) = _both(1, *_sides())
    s = (a[0].sort("k"), a[1].sort("k"))
    _consumer(lambda t: t.sort("k"), [s])
    _consumer(lambda t: t.sort(["k", "v"], [True, False]), [s])


def test_dist_sort_elided(ref4):
    (a, _b) = _both(4, *_sides())
    s = (a[0].distributed_sort("k"), a[1].distributed_sort("k"))
    assert s[1].ordering.scope == "global" and s[1].ordering == s[0].ordering
    _consumer(lambda t: t.distributed_sort("k"), [s])


def test_groupby_run_detect(ref):
    (a, _b) = _both(1, *_sides(null_v=True))
    s = (a[0].sort("k"), a[1].sort("k"))
    _consumer(lambda t: t.groupby("k", {"v": ["sum", "count", "mean"], "x": "max"}), [s], agg=True)


@pytest.mark.parametrize("keep", ["first", "last"])
def test_unique_run_detect(ref, keep):
    (a, _b) = _both(1, *_sides())
    s = (a[0].sort(["k", "v"]), a[1].sort(["k", "v"]))
    _consumer(lambda t: t.unique(["k"], keep=keep), [s])


@pytest.mark.parametrize("op", ["union", "subtract", "intersect"])
def test_setop_sorted_probe(ref, op):
    (a, b) = _both(1, *_sides())
    ls = (a[0].project(["k"]).sort("k"), a[1].project(["k"]).sort("k"))
    rs = (b[0].project(["k"]).sort("k"), b[1].project(["k"]).sort("k"))
    _consumer(lambda x, y: getattr(x, op)(y), [ls, rs])


def test_join_presorted_probe(ref):
    (a, b) = _both(1, *_sides())
    rs = (b[0].sort("k"), b[1].sort("k"))
    _consumer(lambda x, y: x.join(y, on="k"), [a, rs])


def test_filtered_keys_decline_like_reference(ref4):
    """A ``filter`` gives every column the JAX package's all-true mask
    (ROADMAP.md C1), so ``sort(["k", "v"])`` over a filtered ``sort("k")``
    declines the run-id prefix (``ordering.sort_suffix``) as the JAX
    package declines on a masked key, and a join probing a filtered sorted
    right side counts what the JAX package counts: the ``ordering.*``
    counters agree, and so do the rows."""
    (a, b) = _both(1, *_sides())
    keep_a = np.asarray(a[1].sort("k").to_pandas()["x"] > 0)
    keep_b = np.asarray(b[1].sort("k").to_pandas()["w"] > 0)
    for flow in (lambda t, u: t.sort("k").filter(keep_a).sort(["k", "v"]),
                 lambda t, u: t.join(u.sort("k").filter(keep_b), on="k")):
        jtr.reset_trace()
        ttr.reset_trace()
        want = flow(a[0], b[0])
        got = flow(a[1], b[1])
        assert _counts(ttr) == _counts(jtr)
        assert "ordering.sort_suffix" not in _counts(ttr)
        _shards_equal(want, got)


# ----------------------------------------------------------------------
# the key-order emit and the fused pushdown
# ----------------------------------------------------------------------
@pytest.mark.parametrize("how", ["inner", "left"])
def test_key_order_emit_matches_reference_function(ref, how):
    """The JAX package's ``_key_order_emit`` and the port's key-order
    emit (``spec_probe(emit_key_order=True)``, then ``spec_emit``) on the
    same keys and columns."""
    rng = np.random.default_rng(11)
    nl, nr = 300, 200
    lk = rng.integers(0, 250, nl).astype(np.int32)
    rk = rng.integers(0, 250, nr).astype(np.int32)
    lv = rng.normal(size=nl).astype(np.float32)
    rv = rng.normal(size=nr)
    rs = np.argsort(rk, kind="stable")
    howi = tjoin.join_type_id(how)
    j_ids = jjoin._canonical_ids([(jnp.asarray(lk), None)], [(jnp.asarray(rk), None)],
                                 nl, nr, nl, nr)
    cap = 1024
    jout, jtotal, _shadow = jjoin._key_order_emit(
        *j_ids, [(jnp.asarray(lk), None), (jnp.asarray(lv), None)],
        [(jnp.asarray(rk[rs]), None), (jnp.asarray(rv[rs]), None)],
        jnp.int32(nl), jnp.int32(nr), howi, cap, nl, nr)
    l_cols = [(torch.from_numpy(lk), None), (torch.from_numpy(lv), None)]
    r_cols = [(torch.from_numpy(rk), None), (torch.from_numpy(rv), None)]
    probe = tjoin.spec_probe(l_cols[:1], r_cols[:1], r_cols, howi, emit_key_order=True)
    ttotal = int(probe["total"])
    tout = tjoin.spec_emit(probe, l_cols, r_cols, howi, ttotal)
    assert ttotal == int(jtotal) and 0 < ttotal <= cap
    for (jd, jv), (td, tv) in zip(jout, tout):
        want_valid = np.ones(ttotal, bool) if jv is None else np.asarray(jv)[:ttotal]
        got_valid = np.ones(ttotal, bool) if tv is None else tv.numpy()
        np.testing.assert_array_equal(got_valid, want_valid)
        np.testing.assert_array_equal(td.numpy()[got_valid], np.asarray(jd)[:ttotal][want_valid])
    assert (np.diff(tout[0][0].numpy()) >= 0).all()


@pytest.mark.parametrize("case", ["plain", "null_values", "int_values", "empty_right"])
def test_pushdown_matches_reference_function(ref, case):
    """``join_sum_by_key_pushdown`` of the port against the JAX package's
    with ``return_reps``: group sums, the group count, the join count,
    the representative left rows and the valid-value counts."""
    rng = np.random.default_rng(12)
    nl, nr = 400, 0 if case == "empty_right" else 300
    lk = rng.integers(0, 120, nl).astype(np.int32)
    rk = rng.integers(0, 120, nr).astype(np.int32)
    lv = rng.normal(size=nl).astype(np.float32)
    if case == "int_values":
        lv = rng.integers(-50, 50, nl).astype(np.int32)
    valid = rng.random(nl) > 0.2 if case == "null_values" else None
    gc = min(nl, nr)
    j = jjoin.join_sum_by_key_pushdown(
        [(jnp.asarray(lk), None)], [(jnp.asarray(rk), None)],
        (jnp.asarray(lv), None if valid is None else jnp.asarray(valid)),
        jnp.int32(nl), jnp.int32(nr), max(gc, 1), return_reps=True)
    t = tjoin.join_sum_by_key_pushdown(
        [(torch.from_numpy(lk), None)], [(torch.from_numpy(rk), None)],
        (torch.from_numpy(lv), None if valid is None else torch.from_numpy(valid)))
    ng = int(t[1])
    assert all(x.shape[0] == gc for x in (t[0], t[3], t[4]))
    assert ng == int(j[1]) and int(t[2]) == int(j[2]) and int(j[3]) == 0
    assert t[0].dtype == torch.float32
    np.testing.assert_allclose(t[0][:ng].numpy(), np.asarray(j[0])[:ng], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(t[3][:ng].numpy(), np.asarray(j[4])[:ng])
    np.testing.assert_array_equal(t[4][:ng].numpy(), np.asarray(j[5])[:ng])


@pytest.mark.parametrize("world,how", [(1, "inner"), (1, "left"), (4, "inner")])
def test_key_order_join_matches_reference(ref, monkeypatch, world, how):
    """``distributed_join(emit_order='key')``: the same rows in the same
    order on every shard, the same descriptor, then a groupby that
    run-detects (``run_bench.py``'s q3_ordered)."""
    if world > 1:
        monkeypatch.delenv("CYLON_TPU_SORT_IMPL")
        monkeypatch.delenv("CYLON_TPU_EMIT_IMPL")
    (a, b) = _both(world, *_sides(null_v=True))

    def q(x, y):
        return x.distributed_join(y, on="k", how=how, emit_order="key")

    jtr.reset_trace()
    ttr.reset_trace()
    want, got = q(a[0], b[0]), q(a[1], b[1])
    _shards_equal(want, got)
    assert got.ordering == want.ordering and got.ordering.keys == ("k_x",)
    g = (want.distributed_groupby("k_x", {"v": "sum"}), got.distributed_groupby("k_x", {"v": "sum"}))
    _shards_equal(*g, agg=True)
    assert _counts(ttr) == _counts(jtr)
    assert ttr.get_count("ordering.groupby_run_detect") >= 1


def test_key_order_with_null_keys_then_groupby(ref):
    """Null join keys through the key-order emit and a run-detected
    groupby: the canonical order keeps the null run together."""
    rng = np.random.default_rng(14)
    k = rng.integers(0, 40, 600).astype(np.float64)
    k[rng.random(600) < 0.2] = np.nan
    left = {"k": k, "v": rng.normal(size=600).astype(np.float32)}
    right = {"k": rng.permutation(np.arange(40).astype(np.float64)),
             "w": rng.normal(size=40).astype(np.float32)}
    (a, b) = _both(1, left, right)
    _consumer(lambda x, y: x.join(y, on="k", how="left", emit_order="key").groupby(
        "k_x", {"v": "sum"}), [a, b], agg=True)


def test_key_order_rejects_right_and_outer(ref):
    (a, b) = _both(1, *_sides(n=40))
    for how in ("right", "outer"):
        with pytest.raises(ValueError, match="emit_order='key'"):
            a[0].join(b[0], on="k", how=how, emit_order="key")
        with pytest.raises(ValueError, match="emit_order='key'"):
            a[1].join(b[1], on="k", how=how, emit_order="key")
    with pytest.raises(ValueError, match="pallas_pk"):
        a[1].join(b[1], on="k", emit_order="key", algorithm="pallas_pk")
