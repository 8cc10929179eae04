"""The port's observability layer (``cylon_tpu_torch/obs/``) held against
the JAX package's (``cylon_tpu/obs/``), on the cases of tests/test_obs.py.

Both packages run the same inputs at world 4 on the contexts of
tests/test_torch_shuffle_slice.py (the JAX side's 4-device CPU mesh, the
port's four shards in one process), with the shuffle tiers off on both
sides and the JAX package's autotune off. The JAX side's traced runs are
made once per module (``jax_ref``); each test compares the port's trace,
export, histogram or explain output with it where the JAX test has an
output: the span trees of a lazy q3 and of an eager chain (names, nesting
and node ids), the ``explain(analyze=True)`` text with its times masked,
the Chrome export's events and tracks, the flight ring's eviction, the
histogram quantiles, the plan order of a shared subplan, and the
profiler's straggler ratios. Port-only checks: the disabled tracer
allocates nothing, a traced call reads the host as often as an untraced
one (``host_sync``) and gives bit-equal outputs, the ``obs.prof`` and
``obs.journal`` fault seams degrade without failing a query, the ops
endpoint on localhost, the resource ledger, and the arena pool's reserved
bytes after two equal CSV writes (ROADMAP.md C6).
"""
import gc
import json
import re
import urllib.request

import numpy as np
import pytest

import cylon_tpu as ct
import cylon_tpu_torch as ctt
from cylon_tpu.obs import export as jexport
from cylon_tpu.obs import metrics as jmetrics
from cylon_tpu.plan import lower as jlower
from cylon_tpu.utils import tracing as jtr
from cylon_tpu_torch import fault as tfault
from cylon_tpu_torch.obs import export as texport
from cylon_tpu_torch.obs import metrics as tmetrics
from cylon_tpu_torch.obs import prof as tprof
from cylon_tpu_torch.obs import resource as tresource
from cylon_tpu_torch.obs import store as tstore
from cylon_tpu_torch.obs import trace as ttrace
from cylon_tpu_torch.plan import lower as tlower
from cylon_tpu_torch.utils import tracing as ttr

import _torch_mp_worker as W
from test_torch_plan import REF_ENV, _acceptance, _both, _data
from test_torch_shuffle_slice import _contexts, _encode

WORLD = 4


def _q3(pkg, a, b, salt=0.0):
    return (a.lazy().join(b.lazy(), left_on="k", right_on="rk")
            .filter(pkg.col("w") > salt).groupby("k", {"v": "sum"}))


def _tree(spans):
    """A span forest's shape: (name, node_id, children) nested."""
    return [(sp.name, sp.attrs.get("node_id"), _tree(sp.children)) for sp in spans]


def _traces(ring):
    return [(q.kind, q.name, _tree(q.spans)) for q in ring]


def _mask(text):
    """An explain(analyze=True) text with its measured times, critical
    shares and fingerprint masked."""
    text = re.sub(r"\d+\.\d+ ms \(self \d+\.\d+\)", "T ms (self T)", text)
    text = re.sub(r"crit \d+%", "crit P%", text)
    text = re.sub(r"total \d+\.\d+ ms", "total T ms", text)
    return re.sub(r"Plan fingerprint: [0-9a-f]+", "Plan fingerprint: F", text)


def _hot(n=4096):
    return {"k": np.zeros(n, np.int32)}


def _uniform(n=4096, seed=5):
    return {"k": np.random.default_rng(seed).integers(0, 2000, n).astype(np.int32)}


def _like(cols, k):
    """``cols`` (the left side of ``_data()``) with its key column
    replaced: the same schema and rows, so a shuffle of it reuses the JAX
    side's compiled programs."""
    return dict(cols, k=np.asarray(k, np.int32))


def _run_package(pkg, tables, export, tracing, env, mp, tmp):
    """Every traced run the comparisons need, in one package: returns a
    dict of plain values."""
    (a, b) = tables
    out = {}
    mp.setenv(env + "TRACE", "tree")
    lf = _acceptance(pkg, a, b)
    lf.collect()  # warm: the cached plan
    export.reset_ring()
    lf.collect()
    q = [q for q in export.traces() if q.kind == "plan"][-1]
    out["q3_tree"] = _tree(q.spans)
    out["q3_counters"] = {k: v[0] for k, v in q.counters.items() if k.startswith("plan.")}
    fused = next(sp for sp in q.all_spans() if sp.name == "plan.node.FusedJoinGroupBySum")
    out["q3_coll_bytes"] = fused.attrs.get("coll_bytes")
    # the Chrome export of two collects
    export.reset_ring()
    lf.collect()
    lf.collect()
    path = str(tmp / f"{env}trace.json")
    n_events = export.write_chrome(path)
    doc = export.load_chrome(path)
    out["chrome"] = (n_events, len(doc["traceEvents"]),
                     sum(len(list(q.all_spans())) for q in export.traces()),
                     len(export.traces()), export.validate_chrome(doc),
                     sorted(t["spans"] for t in export.summarize(doc).values()))
    # the ring under a capacity of 4
    mp.setenv(env + "TRACE_RING", "4")
    export.reset_ring()
    for _ in range(6):
        lf.collect()
    qids = [q.qid for q in export.traces()]
    out["ring"] = (len(qids), qids == sorted(qids), len(set(qids)))
    mp.delenv(env + "TRACE_RING")
    # eager chains: one shuffle, the join -> groupby
    export.reset_ring()
    a.shuffle(["k"])
    out["shuffle_traces"] = _traces(export.traces())
    export.reset_ring()
    a.distributed_join(b, left_on="k", right_on="rk").distributed_groupby("k", {"v": "sum"})
    out["join_groupby_traces"] = _traces(export.traces())
    out["explain"] = _q3(pkg, a, b, salt=0.111).explain(analyze=True)
    # the profiler's straggler ratios: a uniform and a one-hot shuffle
    mp.setenv(env + "PROF", "1")
    ctx, left = a.ctx, _data()[0]
    for name, k in (("uniform", left["k"]), ("one_hot", np.zeros(len(left["k"])))):
        tracing.reset_trace()
        pkg.Table.from_encoded(ctx, _encode(_like(left, k))).shuffle(["k"])
        rep = tracing.report("prof.")
        out[name] = {k[len("prof.straggler_ratio"):]: v["last"] for k, v in rep.items()
                     if k.startswith("prof.straggler_ratio")}
    mp.delenv(env + "PROF")
    mp.delenv(env + "TRACE")
    export.reset_ring()
    return out


@pytest.fixture(scope="module")
def tables():
    with pytest.MonkeyPatch.context() as mp:
        for k in REF_ENV:
            mp.setenv(k, "1")
        return _both(WORLD, *_data())


def _package_run(tmp_path_factory, pkg, tables, export, tracing, env, key):
    """:func:`_run_package` once per test session, shared by the xdist
    workers (its values are plain)."""

    def compute():
        with pytest.MonkeyPatch.context() as mp:
            for k in REF_ENV:
                mp.setenv(k, "1")
            return _run_package(pkg, tables, export, tracing, env, mp,
                                tmp_path_factory.mktemp(key))

    return W.shared_result(tmp_path_factory, f"obs_{key}", compute)


@pytest.fixture(scope="module")
def jax_ref(tables, tmp_path_factory):
    return _package_run(tmp_path_factory, ct, [j for j, _t in tables], jexport, jtr,
                        "CYLON_TPU_", "jax")


@pytest.fixture(scope="module")
def port_run(tables, tmp_path_factory):
    return _package_run(tmp_path_factory, ctt, [t for _j, t in tables], texport, ttr,
                        "CYLON_TPU_TORCH_", "port")


@pytest.fixture
def ref(monkeypatch):
    for k in REF_ENV:
        monkeypatch.setenv(k, "1")


@pytest.fixture
def traced(monkeypatch, ref):
    monkeypatch.setenv("CYLON_TPU_TORCH_TRACE", "tree")
    texport.reset_ring()
    yield
    texport.reset_ring()


def _port(tables):
    return [t for _j, t in tables]


# ----------------------------------------------------------------------
# span trees, explain(analyze=True), the Chrome export, the ring
# ----------------------------------------------------------------------

def test_q3_span_tree_shape(jax_ref, port_run):
    """A traced collect of the filtered q3: plan.optimize, plan.lower,
    plan.execute; the plan nodes nested under it with their node ids, the
    pair's count phases, the exchange and its rounds, the fused join-sum;
    the collect's cache hit and rules counted on its own trace; the
    collective bytes on the fused node."""
    assert port_run["q3_tree"] == jax_ref["q3_tree"]
    assert [n for n, _i, _c in port_run["q3_tree"]] == ["plan.optimize", "plan.lower",
                                                        "plan.execute"]
    assert port_run["q3_counters"] == jax_ref["q3_counters"]
    assert port_run["q3_counters"]["plan.cache.hit"] == 1
    assert port_run["q3_coll_bytes"] == jax_ref["q3_coll_bytes"] > 0


def test_eager_chain_implicit_trace(jax_ref, port_run):
    """Each outermost span of an eager chain opens its own op trace: a
    shuffle's count phase and exchange, a join -> groupby's count phases,
    exchanges, speculative join and groupby emits, in the same order."""
    assert port_run["shuffle_traces"] == jax_ref["shuffle_traces"]
    assert "shuffle.exchange" in [t[1] for t in port_run["shuffle_traces"]]
    assert port_run["join_groupby_traces"] == jax_ref["join_groupby_traces"]


def test_explain_analyze_golden_q3(jax_ref, port_run, tables, ref):
    """The analyzed plan: the same tree, rows in -> out, collective MB,
    critical-path column and rules as the JAX package's, times and the
    fingerprint masked; an analyzed run lands no latency sample."""
    assert _mask(port_run["explain"]) == _mask(jax_ref["explain"])
    text = port_run["explain"]
    assert "== Analyzed plan (executed) ==" in text
    scans = [ln for ln in text.splitlines() if "Scan [" in ln and "**" in ln]
    assert len(scans) == 2 and all("rows=" in ln for ln in scans), text
    fused = next(ln for ln in text.splitlines() if "FusedJoinGroupBySum" in ln)
    assert " ms (self " in fused and "coll=" in fused and "->" in fused
    tmetrics.reset_latency()
    _q3(ctt, *_port(tables), salt=0.111).explain(analyze=True)
    assert tmetrics.latency_report() == {}


def test_explain_analyze_crit_column(port_run):
    shares = [int(m) for m in re.findall(r"crit (\d+)%", port_run["explain"])]
    assert shares and 90 <= sum(shares) <= 110


def test_chrome_export_schema_and_roundtrip(jax_ref, port_run):
    """Two collects written and loaded back: one thread_name and one
    query event a trace plus one event a span, the schema clean, the same
    tracks and span counts as the JAX package's export."""
    n_events, n_loaded, n_spans, n_traces, problems, track_spans = port_run["chrome"]
    assert problems == [] and n_events == n_loaded == n_spans + 2 * n_traces
    assert port_run["chrome"] == jax_ref["chrome"]


def test_ring_eviction(jax_ref, port_run):
    assert port_run["ring"] == jax_ref["ring"] == (4, True, 4)


# ----------------------------------------------------------------------
# the metrics registry
# ----------------------------------------------------------------------

def test_histogram_quantiles_unit():
    samples = np.random.default_rng(2).gamma(2.0, 0.01, 500)
    got, want = tmetrics.Histogram(), jmetrics.Histogram()
    for x in list(samples) + [i / 1e3 for i in range(1, 101)]:
        got.record(x)
        want.record(x)
    for q in (0.0, 0.5, 0.95, 0.99, 1.0):
        assert got.quantile(q) == want.quantile(q)
    assert got.quantile(0.5) == pytest.approx(np.quantile(samples, 0.5), rel=0.3)
    assert tmetrics.Histogram().quantile(0.5) == 0.0


def test_collect_observes_fingerprint_histogram(tables, ref, monkeypatch):
    """The histogram fills without tracing: three collects, one key,
    labeled with the fused node; quantiles ordered."""
    monkeypatch.delenv("CYLON_TPU_TORCH_TRACE", raising=False)
    tmetrics.reset_latency()
    lf = _q3(ctt, *_port(tables), salt=0.444)
    for _ in range(3):
        lf.collect()
    [(key, ent)] = list(tmetrics.latency_report().items())
    assert "FusedJoinGroupBySum" in ent["label"] and ent["count"] == 3
    assert 0 < ent["p50_s"] <= ent["p95_s"] <= ent["p99_s"]
    assert tmetrics.latency_quantiles("no-such-key") is None
    assert tmetrics.latency_quantiles(key)["count"] == 3


def test_q3_metrics_all_declared(tables, ref):
    ttr.reset_trace()
    lf = _q3(ctt, *_port(tables), salt=0.555)
    lf.collect()
    lf.collect()
    _port(tables)[0].shuffle(["k"])
    assert [n for n in ttr.get_trace_report() if not tmetrics.is_declared(n)] == []


def test_disabled_span_still_feeds_rollup():
    for tr in (ttr, jtr):
        tr.reset_trace()
        with tr.span("unit.disabled", rows=7):
            pass
        tr.bump("unit.bump", rows=3)
        tr.gauge("unit.gauge", 0.5)
    got, want = ttr.get_trace_report(), jtr.get_trace_report()
    for name in ("unit.disabled", "unit.bump", "unit.gauge"):
        g, w = dict(got[name]), dict(want[name])
        assert g.pop("total_s") == pytest.approx(w.pop("total_s"), abs=1e-3)
        g.pop("max_s"), w.pop("max_s")
        assert g == w, name


def test_disabled_tracer_allocates_nothing(tables, ref, monkeypatch):
    monkeypatch.delenv("CYLON_TPU_TORCH_TRACE", raising=False)
    lf = _q3(ctt, *_port(tables), salt=0.333)
    lf.collect()
    texport.reset_ring()
    gc.collect()
    count = lambda: sum(isinstance(o, (ttrace.Span, ttrace.QueryTrace))  # noqa: E731
                        for o in gc.get_objects())
    before = count()
    lf.collect()
    gc.collect()
    assert count() == before and texport.traces() == [] and ttrace.current() is None


def test_plan_order_unique_ids_on_shared_subplan(tables, ref):
    """A reused LazyFrame shares nodes (a DAG): the pre-order ids keep the
    first visit, as the JAX package's do, and the analyzed run renders."""
    (ja, ta) = tables[0]
    lazies = []
    for pkg, t in ((ct, ja), (ctt, ta)):
        base = t.lazy().filter(pkg.col("v") > 0)
        lazies.append(base.union(base))
    jids = list(jlower.plan_order(lazies[0]._plan).values())
    tids = list(tlower.plan_order(lazies[1]._plan).values())
    assert tids == jids and len(tids) == len(set(tids))
    assert "== Analyzed plan (executed) ==" in lazies[1].explain(analyze=True)


# ----------------------------------------------------------------------
# the profiler
# ----------------------------------------------------------------------

def test_stage_clocks_uniform_vs_one_hot(jax_ref, port_run, tables, traced, monkeypatch):
    """The straggler ledger: equal per-stage max/mean ratios to the JAX
    package's (they are functions of the measured counts alone), about 1
    on a uniform shuffle and the world on a one-hot one; the stage clocks
    annotate the exchange span."""
    for name in ("uniform", "one_hot"):
        got, want = port_run[name], jax_ref[name]
        assert set(got) == set(want), name
        for stage in want:
            assert got[stage] == pytest.approx(want[stage], rel=1e-9), (name, stage)
    assert port_run["uniform"][""] < 1.5 and port_run["one_hot"][""] > 3.0
    monkeypatch.setenv("CYLON_TPU_TORCH_PROF", "1")
    tprof.reset()
    ctt.Table.from_encoded(_port(tables)[0].ctx, _encode(_hot())).shuffle(["k"])
    q = [q for q in texport.traces() if q.kind == "op"][-1]
    ex = next(sp for sp in q.all_spans() if sp.name == "shuffle.exchange")
    assert ex.attrs["prof_straggler"] > 3.0
    assert any(k.startswith("prof_") and k.endswith("_ms") for k in ex.attrs)
    doc = texport.chrome_doc()
    assert texport.validate_chrome(doc) == []
    assert sum(e["name"].startswith("prof.") for e in doc["traceEvents"] if e["ph"] == "X") \
        >= WORLD


def test_two_hop_shuffle_has_per_axis_clocks(traced, monkeypatch):
    """On a 2x2 mesh the collective clock splits per axis (``coll_inner``,
    ``coll_outer``), the inputs of the hop-mode decision; the flat shuffle
    of the same table keeps one ``collective`` clock."""
    from cylon_tpu_torch.parallel import topo

    monkeypatch.setenv("CYLON_TPU_TORCH_PROF", "1")
    tprof.reset()
    ctx22 = ctt.CylonContext.init_distributed(ctt.GPUConfig(device="cpu", world_size=WORLD,
                                                            mesh_shape="2x2"))
    t = ctt.Table.from_encoded(ctx22, _encode(_uniform()))
    for disabled, want in ((False, {"coll_inner", "coll_outer"}), (True, {"collective"})):
        ttr.reset_trace()
        if disabled:
            with topo.disabled():
                t.shuffle(["k"])
        else:
            t.shuffle(["k"])
        stages = {k[len("prof.stage_ms."):] for k in ttr.report("prof.stage_ms.")}
        assert want <= stages and not ({"collective", "coll_inner"} - want) & stages, stages
        assert {"pack", "compact"} <= stages


def test_disabled_profiler_records_nothing(tables, traced, monkeypatch):
    monkeypatch.delenv("CYLON_TPU_TORCH_PROF", raising=False)
    ttr.reset_trace()
    _port(tables)[0].shuffle(["k"])
    assert not ttr.report("prof.")
    q = [q for q in texport.traces() if q.kind == "op"][-1]
    assert tprof.PROF_ATTR not in q.attrs


def test_prof_fault_seam_degrades_not_fails(tables, ref, monkeypatch):
    """An armed ``obs.prof`` seam turns the profiler off (counted
    ``prof.degraded``); the shuffle's result equals the unprofiled one."""
    t = _port(tables)[0]
    want = t.shuffle(["k"])
    monkeypatch.setenv("CYLON_TPU_TORCH_PROF", "1")
    monkeypatch.setenv("CYLON_TPU_TORCH_FAULTS", "obs.prof:p=1")
    tfault.reset()
    tprof.reset()
    c0 = tmetrics.get_count("prof.degraded")
    try:
        got = t.shuffle(["k"])
        assert tfault.inject.fired("obs.prof") >= 1
        assert tmetrics.get_count("prof.degraded") == c0 + 1
        assert tprof.degraded() and not tprof.profiling_active()
    finally:
        monkeypatch.delenv("CYLON_TPU_TORCH_FAULTS")
        tfault.reset()
        tprof.reset()
    assert list(got.row_counts) == list(want.row_counts)
    for s in range(WORLD):
        for c in got.column_names:
            assert got._shards[s][c].data.equal(want._shards[s][c].data)


# ----------------------------------------------------------------------
# the tracer's cost: no added host read, the same outputs
# ----------------------------------------------------------------------

def test_traced_and_untraced_calls_read_the_host_alike(tables, ref, monkeypatch):
    """The eager join -> groupby, the lazy q3 and explain's analyzed run
    read the host as often traced (and profiled) as untraced, and give
    bit-equal outputs."""
    ta, tb = _port(tables)

    def calls():
        j = ta.distributed_join(tb, left_on="k", right_on="rk")
        return [j.distributed_groupby("k", {"v": "sum"}), _q3(ctt, ta, tb, 0.2).collect()]

    outs, syncs = [], []
    for knobs in ({}, {"CYLON_TPU_TORCH_TRACE": "tree", "CYLON_TPU_TORCH_PROF": "1"}):
        for k, v in knobs.items():
            monkeypatch.setenv(k, v)
        before = ttr.get_count("host_sync")
        outs.append(calls())
        syncs.append(ttr.get_count("host_sync") - before)
    assert syncs[0] == syncs[1] > 0
    for got, want in zip(*outs):
        assert list(got.row_counts) == list(want.row_counts)
        for s in range(WORLD):
            for c in want.column_names:
                assert got._shards[s][c].data.equal(want._shards[s][c].data), c


# ----------------------------------------------------------------------
# exporters, the ledger, the store
# ----------------------------------------------------------------------

def test_prometheus_text_and_ops_endpoint(port_run):
    """The exposition validates under both packages' validators; the ops
    endpoint on localhost serves it, the health report and the ring."""
    text = texport.prometheus_text()
    assert texport.validate_prometheus(text) == [] == jexport.validate_prometheus(text)
    assert "cylon_tpu_torch_host_sync_total" in text
    srv = texport.OpsServer(0)
    port = srv.start()
    try:
        base = f"http://127.0.0.1:{port}"
        got = urllib.request.urlopen(base + "/metrics", timeout=10).read().decode()
        assert texport.validate_prometheus(got) == []
        assert json.loads(urllib.request.urlopen(base + "/healthz", timeout=10).read()) == {
            "ok": True, "reasons": []}
        assert isinstance(json.loads(urllib.request.urlopen(base + "/queries", timeout=10)
                                     .read()), list)
    finally:
        srv.stop()


def test_resource_ledger_tracks_and_frees(ref, monkeypatch):
    """A table registers its shards' bytes under tracing; a projection
    shares them (no new bytes); dropping the tables frees them."""
    monkeypatch.setenv("CYLON_TPU_TORCH_TRACE", "tree")
    ctx = _contexts(WORLD)[1]
    led = tresource.ledger(ctx)
    gc.collect()
    base = led.snapshot()["device_bytes"]
    t = ctt.Table.from_encoded(ctx, _encode({"a": np.arange(1000, dtype=np.int64),
                                             "b": np.ones(1000)}))
    assert led.snapshot()["device_bytes"] == base + 16000
    p = t.project(["a"])
    assert led.snapshot()["device_bytes"] == base + 16000
    del t, p
    gc.collect()
    assert led.snapshot()["device_bytes"] == base


def test_observation_store_journal_and_seam(tables, ref, monkeypatch, tmp_path):
    """Under CYLON_TPU_TORCH_OBS_DIR a collect journals its exec and
    latency records under the plan's key; an armed ``obs.journal`` seam
    turns the store to in-memory telemetry and the collect still
    succeeds."""
    monkeypatch.setenv("CYLON_TPU_TORCH_OBS_DIR", str(tmp_path))
    tstore.reset_stores()
    lf = _q3(ctt, *_port(tables), salt=0.7)
    want = lf.collect()
    st = tstore.store()
    st.flush()
    [(key, prof)] = list(st.summary().items())
    assert prof["n"] >= 1 and prof["lat_n"] >= 1
    assert any(f.startswith("journal-") for f in __import__("os").listdir(tmp_path))
    monkeypatch.setenv("CYLON_TPU_TORCH_FAULTS", "obs.journal:p=1")
    tfault.reset()
    try:
        got = lf.collect()
        assert tstore.store().journal_degraded
    finally:
        monkeypatch.delenv("CYLON_TPU_TORCH_FAULTS")
        tfault.reset()
        tstore.reset_stores()
    assert list(got.row_counts) == list(want.row_counts)


def test_profile_passthrough_writes_a_trace(tmp_path):
    import torch

    with ttr.profile(str(tmp_path / "prof")):
        (torch.arange(128) * 3).sum()
    files = list((tmp_path / "prof").iterdir())
    assert files and json.loads(files[0].read_text())


# ----------------------------------------------------------------------
# ROADMAP.md C6: the arena pool after large CSV writes
# ----------------------------------------------------------------------

def test_pool_reserved_after_two_equal_writes(tmp_path):
    """A column above the pool's block size (1 MiB) gets a dedicated block,
    freed at the next write's reset: the reserved bytes after two equal
    writes equal those after one, and the files equal the JAX package's
    writer byte for byte."""
    jctx, tctx = _contexts(1)
    rng = np.random.default_rng(6)
    enc = _encode({"k": rng.integers(-9, 9, 200_000).astype(np.int32),
                   "x": rng.normal(size=200_000).astype(np.float32)})
    t = ctt.Table.from_encoded(tctx, enc)
    pool = tctx.memory_pool
    ctt.write_csv(t, str(tmp_path / "a.csv"))
    reserved = pool.bytes_reserved
    assert reserved >= 2 * 200_000 * 8  # the two staged columns' blocks
    ctt.write_csv(t, str(tmp_path / "b.csv"))
    assert pool.bytes_reserved == reserved
    ct.write_csv(ct.Table.from_encoded(jctx, enc), str(tmp_path / "j.csv"))
    want = (tmp_path / "j.csv").read_bytes()
    assert (tmp_path / "a.csv").read_bytes() == (tmp_path / "b.csv").read_bytes() == want
