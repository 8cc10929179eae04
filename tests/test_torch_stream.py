"""Streaming ingest and incremental views (cylon_tpu_torch/stream/) against
the JAX package's cylon_tpu/stream and the properties of its
tests/test_stream.py.

- DIFFERENTIAL: the same seeded append sequences (a groupby over sum,
  count, min and max on string keys with 10% nulls; a join with both sides
  streaming, under a groupby and with no aggregate; a filter-only view with
  duplicate rows across appends; ``mean``, which falls back; an empty
  append) run through ``cylon_tpu.stream.view(...).refresh()``, computed
  once a session, and through the port's, at worlds 1 and 4 (8 under
  -m slow). Every refresh equals the JAX package's result as a multiset of
  rows with equal dtypes, with equal ``stats``, generations and
  watermarks, and equals the port's own ``CYLON_TPU_TORCH_NO_IVM=1``
  oracle. Payloads are integer-valued float32, so sums compare exactly.
- BEHAVIOUR: fingerprints keyed by generation (and frozen on detached
  Scans), descriptor invalidation, schema rejection with rollback,
  watermarks and the state budget, chunked staging, both fault seams and
  the seam-spec validation, subscriptions (re-resolution,
  ``refresh_async``, a failed refresh staying stale, two subscriptions of
  one view at one generation), an append during an in-flight refresh;
  each held to the JAX package's outcome where its test asserts one.
- RANKS (-m slow): two gloo ranks appending the same batches keep the
  views of one process at world 2.
"""
import numpy as np
import pytest
import torch

import cylon_tpu as ct
import cylon_tpu_torch as ctt
from cylon_tpu import fault as jfault
from cylon_tpu.fault import inject as jinject
from cylon_tpu_torch import fault as tfault
from cylon_tpu_torch.fault import inject as tinject
from cylon_tpu_torch.fault.errors import CylonError, StreamIngestError
from cylon_tpu_torch.plan import lower as tlower
from cylon_tpu_torch.plan.lazy import gated_fingerprint
from cylon_tpu_torch.utils import tracing
import _torch_mp_worker as W
from test_torch_shuffle_slice import _contexts

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _disarm(monkeypatch):
    for var in ("CYLON_TPU_FAULTS", "CYLON_TPU_NO_IVM", "CYLON_TPU_TORCH_FAULTS",
                "CYLON_TPU_TORCH_NO_IVM"):
        monkeypatch.delenv(var, raising=False)
    jfault.reset()
    tfault.reset()
    yield
    jfault.reset()
    tfault.reset()


# ----------------------------------------------------------------------
# data, canonical form, the sequences
# ----------------------------------------------------------------------

def _str_keys(rng, n, keyspace=16, null_p=0.1):
    k = rng.choice([f"s{i:02d}" for i in range(keyspace)], n).astype(object)
    if null_p:
        k[rng.random(n) < null_p] = None
    return k


def _batch(rng, n, null_p=0.1):
    """tests/test_stream.py's batch: string keys with nulls and an
    integer-valued float32 payload (float sums associate exactly)."""
    return {"k": _str_keys(rng, n, null_p=null_p),
            "v": rng.integers(-40, 40, n).astype(np.float32)}


def _rbatch(rng, n):
    return {"rk": _str_keys(rng, n), "w": rng.integers(0, 30, n).astype(np.float32)}


def _isnull(v):
    return v is None or (isinstance(v, float) and v != v)


def canon(t):
    """(names, dtypes, sorted rows) of a table of either package. Null-aware:
    a null of any column (None, or NaN in a float column) sorts first and
    equals only a null, so no NaN != NaN comparison (pandas 3 gives string
    columns its ``str`` dtype, whose nulls stay NaN) can split two equal
    results."""
    d = t.to_pydict()
    names = list(d)
    dtypes = [str(np.asarray(d[c]).dtype) for c in names]
    rows = sorted(zip(*(
        [(0,) if _isnull(v) else (1, v.item() if hasattr(v, "item") else v) for v in d[c]]
        for c in names
    )))
    return names, dtypes, rows


def _views_equal(got, want, what):
    g, w = canon(got), canon(want)
    assert g[0] == w[0], (what, g[0], w[0])
    assert g[1] == w[1], (what, g[1], w[1])
    assert len(g[2]) == len(w[2]), (what, len(g[2]), len(w[2]))
    assert g[2] == w[2], what


def _agg_view(mod, tab):
    return mod.stream.view(
        lambda t: t.lazy().filter(mod.col("v") > -10).groupby(
            "k", {"v": ["sum", "count", "min", "max"]}), tab)


# The sizes keep every snapshot, and every delta, of a sequence in one
# power-of-two shard capacity at worlds 1 and 4, so the JAX package compiles
# each term's program once.

def _seq_groupby(mod, ctx, rng):
    tab = mod.stream.AppendableTable(ctx, _batch(rng, 300))
    v = _agg_view(mod, tab)
    yield v, [tab]
    for n in (60, 1, 40):  # a one-row delta among them
        tab.append(_batch(rng, n))
        yield v, [tab]


def _join_build(mod, agg):
    def build(lt, rt):
        lf = lt.lazy()
        if not agg:
            lf = lf.filter(mod.col("v") >= 0)
        lf = lf.join(rt.lazy(), left_on="k", right_on="rk")
        return lf.groupby("k", {"v": "sum", "w": "max"}) if agg else lf
    return build


def _seq_join(mod, ctx, rng, agg=True):
    left = mod.stream.AppendableTable(ctx, _batch(rng, 180))
    right = mod.stream.AppendableTable(ctx, _rbatch(rng, 40))
    v = mod.stream.view(_join_build(mod, agg), left, right)
    yield v, [left, right]
    # two left appends and a right one folded into one refresh
    left.append(_batch(rng, 40))
    right.append(_rbatch(rng, 20))
    left.append(_batch(rng, 20))
    yield v, [left, right]
    right.append(_rbatch(rng, 4))   # the L_prev join dR term alone
    yield v, [left, right]
    left.append(_batch(rng, 60))    # the dL join R_cur term alone
    yield v, [left, right]


def _seq_join_rows(mod, ctx, rng):
    return _seq_join(mod, ctx, rng, agg=False)


def _seq_filter(mod, ctx, rng):
    tab = mod.stream.AppendableTable(ctx, _batch(rng, 200))
    v = mod.stream.view(lambda t: t.lazy().filter(mod.col("v") >= 0), tab)
    yield v, [tab]
    b = _batch(rng, 80)
    tab.append(b)
    tab.append(b)  # the same rows twice: a bag, no dedup
    yield v, [tab]


def _seq_mean(mod, ctx, rng):
    tab = mod.stream.AppendableTable(ctx, _batch(rng, 150))
    v = mod.stream.view(lambda t: t.lazy().groupby("k", {"v": "mean"}), tab)
    yield v, [tab]
    tab.append(_batch(rng, 60))
    yield v, [tab]


def _seq_empty(mod, ctx, rng):
    tab = mod.stream.AppendableTable(ctx, _batch(rng, 200))
    v = mod.stream.view(lambda t: t.lazy().filter(mod.col("v") >= 0), tab)
    yield v, [tab]
    assert tab.append({"k": np.array([], object), "v": np.array([], np.float32)}) == 0
    yield v, [tab]  # nothing moved: a no-op refresh
    tab.append(_batch(rng, 80))
    yield v, [tab]


SEQS = {"groupby": _seq_groupby, "join": _seq_join, "join_rows": _seq_join_rows,
        "filter": _seq_filter, "mean": _seq_mean, "empty": _seq_empty}
#: the sequences held against the JAX package. ``join_rows`` concatenates
#: the retained result with each delta's, through a dictionary unification
#: that fails on the JAX side when a filtered delta keeps no string value
#: (ROADMAP.md C2), so the port holds it to its own oracle alone
JAX_HELD = ("groupby", "join", "filter", "mean", "empty")


def _seed(name, world):
    return sum(map(ord, name)) * 10 + world


def _run(mod, ctx, name, world, check=None):
    """One record a refresh of the sequence: the result's canonical form,
    the view's stats and generations and every source's watermarks.
    ``check(result, view, sources)`` runs right after each refresh."""
    out = []
    for v, sources in SEQS[name](mod, ctx, np.random.default_rng(_seed(name, world))):
        before = v._result
        res = v.refresh()
        if check is not None:
            check(res, v, sources)
        out.append({"canon": canon(res), "stats": dict(v.stats), "gens": v.generations,
                    "marks": [[s.watermark(g) for g in range(s.generation + 1)]
                              for s in sources],
                    "same": res is before})
    return out


def _jax_ref(tmp_path_factory, name, world):
    """The JAX package's records of one sequence at one world, made once a
    session (one key a sequence and world, so no xdist worker waits on
    another's sequences)."""
    return W.shared_result(tmp_path_factory, f"jax_stream_{name}_w{world}",
                           lambda: _run(ct, _contexts(world)[0], name, world))


def _oracle(build, sources):
    with ctt.stream.ivm_disabled():
        return ctt.stream.view(build, *sources).refresh()


def _run_checked(name, world):
    """The port's run of a sequence, each refresh held to the port's own
    NO_IVM oracle over the same snapshots; returns the records and the
    view's final stats."""
    stats = []

    def check(res, view, sources):
        _views_equal(res, _oracle(view._build, sources),
                     f"{name} w{world} refresh {len(stats)} (oracle)")
        stats.append(dict(view.stats))

    return _run(ctt, _contexts(world)[1], name, world, check), stats[-1]


WORLDS = [1, 4, pytest.param(8, marks=pytest.mark.slow)]
EXPECT_INC = {"groupby": 3, "join": 3, "join_rows": 3, "filter": 1, "mean": 0, "empty": 1}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", JAX_HELD)
def test_refreshes_equal_the_jax_package_and_the_oracle(tmp_path_factory, name, world):
    want = _jax_ref(tmp_path_factory, name, world)
    got, last = _run_checked(name, world)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        what = f"{name} w{world} refresh {i}"
        assert g["canon"][:2] == w["canon"][:2], (what, g["canon"][:2], w["canon"][:2])
        assert g["canon"][2] == w["canon"][2], what
        assert (g["stats"], g["gens"], g["marks"], g["same"]) == (
            w["stats"], w["gens"], w["marks"], w["same"]), what
    assert last["inc"] == EXPECT_INC[name] and last["full"] == 1
    assert last["fallback"] == (1 if name == "mean" else 0)


@pytest.mark.parametrize("world", WORLDS)
def test_join_rows_view_equals_its_oracle(world):
    """A join with no aggregate over two streaming sides: the retained
    result concatenated with both delta terms' rows, string dictionaries
    unified, equals the full recompute at every refresh."""
    got, last = _run_checked("join_rows", world)
    assert len(got) == 4 and last == {"noop": 0, "full": 1, "fallback": 0, "inc": 3}
    assert got[-1]["marks"] == [[180, 220, 240, 300], [40, 60, 64]]


# ----------------------------------------------------------------------
# generation identity: plans never alias across refreshes
# ----------------------------------------------------------------------

def _sum_view(mod, tab):
    return mod.stream.view(lambda t: t.lazy().groupby("k", {"v": "sum"}), tab)


def test_generation_keyed_fingerprint_no_aliasing(rng):
    ctx = _contexts(4)[1]
    tab = ctt.AppendableTable(ctx, _batch(rng, 100))
    build = lambda t: t.lazy().groupby("k", {"v": "sum"})  # noqa: E731
    fps, stamps = [], []
    for g in range(3):
        snap = tab.table()
        plan = build(snap).plan
        fps.append(gated_fingerprint(plan))
        stamps.append(snap._stream_gen)
        # a detached stub freezes the generation it was compiled under
        stub = tlower.detach_scans(plan).children[0]
        assert stub.table is None and stub.stream_gen() == (tab._token, g)
        tab.append(_batch(rng, 30))
    assert len(set(fps)) == 3, "one plan shape aliased across generations"
    assert stamps == [(tab._token, g) for g in range(3)]
    d = tab.delta_table(0)
    assert d._stream_gen == (tab._token, 0, 3)
    assert gated_fingerprint(build(d).plan) not in fps
    # the JAX package separates the same generations
    jtab = ct.stream.AppendableTable(_contexts(4)[0], _batch(np.random.default_rng(1), 100))
    from cylon_tpu.plan import lazy as jlazy
    jfps = []
    for _ in range(3):
        jfps.append(jlazy.gated_fingerprint(build(jtab.table()).plan))
        jtab.append(_batch(rng, 30))
    assert len(set(jfps)) == len(set(fps))
    # an ordinary table's Scan carries no generation
    plain = ctt.Table.from_pydict(ctx, _batch(rng, 10))
    assert build(plain).plan.children[0].stream_gen() is None


def test_snapshot_descriptors_invalidated():
    """Appends void order and range-stat descriptors: every snapshot is a
    fresh encode and never inherits an older generation's."""
    ctx = _contexts(4)[1]
    tab = ctt.AppendableTable(ctx, {"k": np.arange(64, dtype=np.int64),
                                    "v": np.ones(64, np.float32)})
    s0 = tab.table()
    assert tab.table() is s0  # one snapshot a generation
    s0.sort("k")
    s0.ensure_stats(["k"])
    assert len(s0._stats) > 0
    tab.append({"k": np.array([3, 1], np.int64), "v": np.array([1.0, 1.0], np.float32)})
    s1 = tab.table()
    assert s1 is not s0
    assert s1._ordering is None and len(s1._stats) == 0
    d = tab.delta_table(0)
    assert d._ordering is None and len(d._stats) == 0
    assert tab.table(at_gen=0).row_count == 64 and tab.table(at_gen=0) is not s0


# ----------------------------------------------------------------------
# the ingest contract: schema validation, rollback, budget, watermarks
# ----------------------------------------------------------------------

def _bad_batches(rng):
    return (
        {"k": _str_keys(rng, 4), "WRONG": np.ones(4, np.float32)},
        {"k": _str_keys(rng, 4)},                                  # a missing column
        {"k": np.arange(4), "v": np.ones(4, np.float32)},          # int keys
        {"k": _str_keys(rng, 4), "v": np.ones(3, np.float32)},     # ragged
        {"k": _str_keys(rng, 4), "v": np.array(["x"] * 4, object)},
        {"k": _str_keys(rng, 4), "v": np.array([1, 2, None, "x"], object)},
    )


@pytest.mark.parametrize("mod", [ct, ctt], ids=["jax", "port"])
def test_append_schema_rejected_and_rolled_back(mod, rng):
    tab = mod.stream.AppendableTable(_contexts(4)[mod is ctt], _batch(rng, 50))
    g, rows = tab.generation, tab.row_count
    before = canon(tab.table())
    err = mod.StreamIngestError if mod is ct else StreamIngestError
    for bad in _bad_batches(rng):
        with pytest.raises(err) as ei:
            tab.append(bad)
        assert ei.value.retryable and ei.value.scope == "table"
    assert tab.generation == g and tab.row_count == rows
    assert canon(tab.table()) == before  # the prior generation still queryable
    # the initial batch is validated the same way
    for bad in ({}, {"k": np.array([None, None], object)}, {"k": np.array([1 + 2j])},
                {"k": np.array([], np.int32)}):
        with pytest.raises(ValueError):
            mod.stream.AppendableTable(_contexts(4)[mod is ctt], bad)


def test_watermarks_and_state_budget(rng, monkeypatch):
    got = {}
    for mod, prefix in ((ct, "CYLON_TPU_"), (ctt, "CYLON_TPU_TORCH_")):
        r = np.random.default_rng(3)
        tab = mod.stream.AppendableTable(_contexts(4)[mod is ctt], _batch(r, 100))
        tab.append(_batch(r, 40))
        tab.append(_batch(r, 7))
        assert tab.rows_since(1) == 7 and tab.rows_since(0) == 47
        assert tab.delta_table(1).row_count == 7
        with pytest.raises(ValueError):
            tab.watermark(3)
        with pytest.raises(ValueError):
            tab.delta_table(2)  # no rows after the current generation
        monkeypatch.setenv(prefix + "STREAM_STATE_BUDGET", "1")
        with pytest.raises(StreamIngestError if mod is ctt else ct.StreamIngestError):
            tab.append(_batch(r, 10))
        monkeypatch.delenv(prefix + "STREAM_STATE_BUDGET")
        got[mod.__name__] = ([tab.watermark(g) for g in range(3)], tab.generation,
                             tab.row_count, canon(tab.delta_table(0)))
    assert got["cylon_tpu_torch"] == got["cylon_tpu"]
    assert got["cylon_tpu_torch"][:3] == ([100, 140, 147], 2, 147)


def test_chunked_staging(monkeypatch):
    monkeypatch.setenv("CYLON_TPU_TORCH_STREAM_CHUNK_ROWS", "16")
    rng = np.random.default_rng(5)
    tab = ctt.AppendableTable(_contexts(4)[1], _batch(rng, 10))
    tracing.reset_trace()
    tab.append(_batch(rng, 50))
    assert tracing.get_count("stream.append.chunks") == 4  # 16 + 16 + 16 + 2
    assert tab.row_count == 60
    build = lambda t: t.lazy().groupby("k", {"v": "sum"})  # noqa: E731
    _views_equal(ctt.stream.view(build, tab).refresh(), _oracle(build, [tab]), "chunked")


# ----------------------------------------------------------------------
# the fault seams: typed failures, state kept
# ----------------------------------------------------------------------

@pytest.mark.parametrize("mod", [ct, ctt], ids=["jax", "port"])
def test_fault_append_rolls_back(mod, monkeypatch):
    rng = np.random.default_rng(9)
    tab = mod.stream.AppendableTable(_contexts(4)[mod is ctt], _batch(rng, 80))
    snap = canon(tab.table())
    var, fault, inject = (("CYLON_TPU_TORCH_FAULTS", tfault, tinject) if mod is ctt
                          else ("CYLON_TPU_FAULTS", jfault, jinject))
    monkeypatch.setenv(var, "stream.append:n=1")
    fault.reset()
    with pytest.raises(StreamIngestError if mod is ctt else ct.StreamIngestError) as ei:
        tab.append(_batch(rng, 20))
    assert "ENOSPC" in str(ei.value)
    assert inject.fired("stream.append") == 1
    assert tab.generation == 0 and tab.row_count == 80
    assert canon(tab.table()) == snap
    assert tab.append(_batch(rng, 20)) == 1  # the injector spent: recovers
    assert tab.row_count == 100


def test_fault_refresh_retains_state(monkeypatch):
    rng = np.random.default_rng(10)
    tab = ctt.AppendableTable(_contexts(4)[1], _batch(rng, 80))
    v = _sum_view(ctt, tab)
    r0 = v.refresh()
    tab.append(_batch(rng, 30))
    monkeypatch.setenv("CYLON_TPU_TORCH_FAULTS", "stream.refresh:n=1")
    tfault.reset()
    with pytest.raises(CylonError):
        v.refresh()
    assert tinject.fired("stream.refresh") == 1
    assert v._result is r0 and v.generations == [0]  # untouched
    _views_equal(v.refresh(), _oracle(v._build, [tab]), "retried")
    assert v.stats == {"noop": 0, "full": 1, "fallback": 0, "inc": 1}
    # a real failure inside the planner surfaces typed too, state kept
    tab.append(_batch(rng, 5))
    bad = ctt.stream.view(lambda t: t.lazy().groupby("missing", {"v": "sum"}), tab)
    with pytest.raises(CylonError):
        bad.refresh()
    assert bad.generations is None and bad._result is None


@pytest.mark.parametrize("mod", [jinject, tinject], ids=["jax", "port"])
def test_stream_fault_spec_validation(mod):
    with pytest.raises(mod.FaultSpecError):
        mod.parse_spec("stream.append:kind=exec")  # an errno-only seam
    mod.parse_spec("stream.append:n=1:kind=ENOSPC")
    mod.parse_spec("stream.refresh:kind=timeout")  # a typed-kind seam
    assert mod.parse_spec("stream.refresh")["stream.refresh"].kind == "exec"
    assert mod.parse_spec("stream.append")["stream.append"].kind == "ENOSPC"
    with pytest.raises(mod.FaultSpecError):
        mod.parse_spec("stream.refresh:match=abc")  # an unkeyed seam


# ----------------------------------------------------------------------
# subscriptions and in-flight refreshes
# ----------------------------------------------------------------------

def test_subscription_re_resolution():
    rng = np.random.default_rng(12)
    tab = ctt.AppendableTable(_contexts(4)[1], _batch(rng, 200))
    sub = ctt.stream.subscribe(_sum_view(ctt, tab))
    r1 = sub.result()
    assert sub.done() and not sub.stale()
    assert sub.result() is r1               # fresh: the retained result, no launch
    tab.append(_batch(rng, 60))
    assert sub.stale() and not sub.done()   # the append marked it stale
    _views_equal(sub.result(), _oracle(sub._view._build, [tab]), "re-resolved")
    assert sub.done()
    del sub  # a dropped subscription unsubscribes (a weak listener)
    tab.append(_batch(rng, 5))
    assert tab._listeners == []


def test_subscription_refresh_async_future():
    rng = np.random.default_rng(13)
    tab = ctt.AppendableTable(_contexts(4)[1], _batch(rng, 150))
    sub = ctt.stream.subscribe(_sum_view(ctt, tab))
    fut = sub.refresh_async()
    _views_equal(fut.result(timeout=120), _oracle(sub._view._build, [tab]), "first")
    tab.append(_batch(rng, 40))
    fut2 = sub.refresh_async()              # rides the serving scheduler
    _views_equal(fut2.result(timeout=120), _oracle(sub._view._build, [tab]), "second")
    assert sub._view.stats["inc"] == 1
    noop = sub.refresh_async()              # nothing moved: fulfilled at once
    assert noop.done() and noop.result() is sub._view._result
    sub.close()


def test_subscription_failed_refresh_stays_stale(monkeypatch):
    rng = np.random.default_rng(14)
    tab = ctt.AppendableTable(_contexts(4)[1], _batch(rng, 100))
    sub = ctt.stream.subscribe(_sum_view(ctt, tab))
    sub.result()
    tab.append(_batch(rng, 30))
    monkeypatch.setenv("CYLON_TPU_TORCH_FAULTS", "stream.refresh:n=1")
    tfault.reset()
    with pytest.raises(CylonError):
        sub.result()
    assert sub.stale()                      # not left fresh
    monkeypatch.delenv("CYLON_TPU_TORCH_FAULTS")
    tfault.reset()
    _views_equal(sub.result(), _oracle(sub._view._build, [tab]), "after the fault")


def test_two_subscriptions_of_one_generation_equal_a_single_refresh():
    """Two subscriptions of one view at one generation plan the same
    stamped delta plan (one fingerprint: one serving group); each result
    equals a single refresh of a twin view, with no serving error and no
    fallback out of a stacked batch."""
    rng = np.random.default_rng(15)
    ctx = _contexts(4)[1]
    tab = ctt.AppendableTable(ctx, _batch(rng, 200))
    view = _sum_view(ctt, tab)
    s1, s2 = ctt.stream.subscribe(view), ctt.stream.subscribe(view)
    s1.result()
    tab.append(_batch(rng, 50))
    _m1, lf1, _c1 = view._plan_refresh()
    _m2, lf2, _c2 = view._plan_refresh()
    assert gated_fingerprint(lf1.plan) == gated_fingerprint(lf2.plan)
    tracing.reset_trace()
    f1, f2 = s1.refresh_async(), s2.refresh_async()
    r1, r2 = f1.result(timeout=120), f2.result(timeout=120)
    want = _oracle(view._build, [tab])
    _views_equal(r1, want, "subscription 1")
    _views_equal(r2, want, "subscription 2")
    assert tracing.get_count("serve.errors") == 0
    assert tracing.get_count("serve.batch_fallback") == 0
    assert view.generations == [1] and not s1.stale() and not s2.stale()


@pytest.mark.parametrize("mod", [ct, ctt], ids=["jax", "port"])
def test_append_during_inflight_refresh(mod):
    """An append between plan and commit is not folded in: the commit
    publishes the planned generation and the view stays stale, so the next
    refresh takes the new rows."""
    rng = np.random.default_rng(16)
    tab = mod.stream.AppendableTable(_contexts(4)[mod is ctt], _batch(rng, 200))
    v = _sum_view(mod, tab)
    v.refresh()
    tab.append(_batch(rng, 50))
    mode, lf, commit = v._plan_refresh()     # a refresh in flight
    assert mode == "inc"
    tab.append(_batch(rng, 70))              # lands mid-flight
    commit(lf.collect())
    assert v.generations == [1] and v.stale()
    got = v.refresh()
    assert v.generations == [2] and v.stats["inc"] == 2
    if mod is ctt:
        _views_equal(got, _oracle(v._build, [tab]), "after the in-flight append")


# ----------------------------------------------------------------------
# torch.distributed: every rank appends the same batches
# ----------------------------------------------------------------------

@pytest.mark.slow
def test_ranks_appending_the_same_batches_keep_one_process_views(tmp_path):
    """Two gloo ranks, each appending the same batches to its own arena:
    every refresh's shard on rank d equals shard d of the same views in one
    process at world 2, and the refresh modes are the same."""
    codes, logs, _secs = W.run_ranks(tmp_path, 2, ["stream"], limit=120.0)
    assert codes == [0, 0], logs
    ranks = W.load_ranks(tmp_path, 2)
    one = W.stream_calls(ctt.CylonContext.init_distributed(
        ctt.GPUConfig(device="cpu", world_size=2)))
    assert one["stats"] == ({"noop": 0, "full": 1, "fallback": 0, "inc": 2},) * 2
    for d, r in enumerate(ranks):
        got = r["stream"]
        assert got["stats"] == one["stats"]
        for k, t in one.items():
            if k != "stats":
                W.record_equal(got[k], W.record(t, [d]), f"rank {d} {k}", d)
