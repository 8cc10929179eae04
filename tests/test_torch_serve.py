"""Query serving (cylon_tpu_torch/serve/, obs/slo.py, ``collect_async``)
against the JAX package's cylon_tpu/serve and its tests/test_serving.py and
tests/test_concurrent_dispatch.py properties.

- DIFFERENTIAL: B same-fingerprint bindings run as ONE stacked execution
  give, per binding, the rows of that binding's serial ``collect()`` (q3 at
  worlds 1 and 4, dictionary-encoded string keys with nulls, the sort,
  left-join + project, right-join and multi-aggregate tails; values
  integer-valued float32, so sums compare exactly; the sort, left-join and
  right-join cases under -m slow), and the first
  binding of q3, of the string keys and of the multi-aggregate tail at
  world 4 equals the JAX package's collect, computed once a session.
- ADMISSION: backpressure, the shed error contract, leases released on
  consumption and by the dropped-future finalizer, one batched executor a
  bucket, the fault seams' fallback and supervision.
- THREADS (the port alone, against its serial results): eight threads
  hammering ``collect_async`` and ``collect`` are bit-equal to the serial
  run, a stampede on a cold fingerprint builds one executor, and eight
  readers of one future get one table with one lease release.
- SLO: ``SLOMonitor``'s states equal the JAX package's on the same
  latencies and counters, and ``/healthz`` reports them.
"""
import contextlib
import gc
import json
import os
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pandas as pd
import pytest
import torch

import cylon_tpu as ct
import cylon_tpu_torch as ctt
from cylon_tpu.obs import slo as jslo
from cylon_tpu_torch import col
from cylon_tpu_torch.fault import inject as tfault
from cylon_tpu_torch.obs import export as texport
from cylon_tpu_torch.obs import metrics as tmetrics
from cylon_tpu_torch.obs import slo as tslo
from cylon_tpu_torch.plan.lower import scan_tables
from cylon_tpu_torch.serve import (QueryExecError, QueryFuture, ServeOverloadError,
                                   ServeScheduler, WorkerDiedError, estimate_query_bytes,
                                   is_batchable)
from cylon_tpu_torch.utils import tracing
import _torch_mp_worker as W
from test_torch_shuffle_slice import _contexts, _encode

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_monitors():
    yield
    # a monitor made here must not carry this test's counters into a later
    # test's window
    tslo.reset_monitor()
    jslo.reset_monitor()


def _binding(rng, n, strings=False, nulls=False):
    """One (left, right) parameter binding as host columns; values are
    integer-valued float32, so reduction order cannot move a sum."""
    if strings:
        k = rng.choice([f"s{i}" for i in range(12)], n).astype(object)
        rk = rng.choice([f"s{i}" for i in range(15)], n).astype(object)
        if nulls:
            k[rng.random(n) < 0.1] = None
    else:
        k = rng.integers(0, 20, n).astype(np.int32)
        rk = rng.integers(0, 20, n).astype(np.int32)
    return ({"k": k, "v": rng.integers(-50, 50, n).astype(np.float32)},
            {"rk": rk, "w": rng.integers(-50, 50, n).astype(np.float32)})


def _q3(a, b, c=col):
    return (a.lazy().join(b.lazy(), left_on="k", right_on="rk")
            .filter(c("w") > 0.0).groupby("k", {"v": "sum"}))


#: shape(left, right, the package's col) -> LazyFrame
SHAPES = {
    "q3": _q3,
    "sort": lambda a, b, c: a.lazy().join(b.lazy(), left_on="k", right_on="rk").sort(["k", "v"]),
    "left_project": lambda a, b, c: a.lazy().join(b.lazy(), left_on="k", right_on="rk",
                                                  how="left").select(["k", "w"]),
    "right": lambda a, b, c: a.lazy().join(b.lazy(), left_on="k", right_on="rk", how="right"),
    "multi_agg": lambda a, b, c: a.lazy().filter(c("v") > 0.0).groupby(
        "k", {"v": ["min", "count", "mean"]}),
}

#: (case, world, shape, bindings, strings): the differential cases
CASES = {
    "q3_w1": (1, "q3", 4, False),
    "q3_w4": (4, "q3", 4, False),
    "strings_w4": (4, "q3", 3, True),
    "sort_w4": (4, "sort", 2, False),
    "left_project_w4": (4, "left_project", 2, False),
    "right_w4": (4, "right", 2, False),
    "multi_agg_w4": (4, "multi_agg", 2, False),
}


#: the cases whose first binding is held against the JAX package's collect
#: (the q3 shape, string keys with nulls and the multi-aggregate tail;
#: each costs the JAX package a program set of its own)
JAX_HELD = ("q3_w4", "strings_w4", "multi_agg_w4")


def _case_bindings(name):
    world, shape, n_b, strings = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    # sizes inside one power-of-two bucket: the JAX package compiles once
    return [_binding(rng, 130 + 29 * i, strings, nulls=strings) for i in range(n_b)]


def _plans(mod, ctx, name):
    shape = SHAPES[CASES[name][1]]
    return [shape(mod.Table.from_encoded(ctx, _encode(left)),
                  mod.Table.from_encoded(ctx, _encode(right)), mod.col)
            for left, right in _case_bindings(name)]


def _jax_collects():
    """The JAX package's collect of the first binding of each case in
    ``JAX_HELD`` (every batched binding is held against the port's serial
    collect, which the port's other tests hold against the JAX package)."""
    out = {}
    for name in JAX_HELD:
        out[name] = _plans(ct, _contexts(CASES[name][0])[0], name)[0].collect().to_pydict()
    return out


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    return W.shared_result(tmp_path_factory, "jax_serving", _jax_collects)


def _canon(pydict):
    """Canonical row order with nulls made comparable: a batch gives each
    binding's exact rows (and, for a sort, their order), not the serial
    shard concatenation order."""
    df = pd.DataFrame(pydict)
    for c in df.columns:
        if df[c].dtype == object:
            df[c] = df[c].map(lambda v: "\0null" if v is None else str(v))
    df = df.fillna("\0null").astype(str)
    return df.sort_values(list(df.columns)).reset_index(drop=True)


def _same_rows(got, want, label=""):
    assert list(got) == list(want), (label, list(got), list(want))
    pd.testing.assert_frame_equal(_canon(got), _canon(want), check_dtype=False, obj=label)


def _run_batched(ctx, plans):
    s = ServeScheduler(ctx, auto_start=False)
    futs = [s.submit(p) for p in plans]
    s.run_pending()
    return [f.result(timeout=120) for f in futs]


# ----------------------------------------------------------------------
# the differential
# ----------------------------------------------------------------------
#: the cases no JAX reference holds, beyond q3's at world 1, run under -m slow
SLOW_CASES = ("sort_w4", "left_project_w4", "right_w4")


@pytest.mark.parametrize("name", [pytest.param(n, marks=pytest.mark.slow) if n in SLOW_CASES
                                  else n for n in CASES])
def test_batched_equals_serial_and_the_jax_collect(jax_results, name):
    world = CASES[name][0]
    tctx = _contexts(world)[1]
    plans = _plans(ctt, tctx, name)
    serial = [p.collect().to_pydict() for p in plans]
    b0, m0 = tracing.get_count("serve.batches"), tracing.get_count("serve.batch_cache.miss")
    got = _run_batched(tctx, plans)
    assert tracing.get_count("serve.batches") == b0 + 1
    assert tracing.get_count("serve.batch_cache.miss") <= m0 + 1
    for i, t in enumerate(got):
        g = t.to_pydict()
        _same_rows(g, serial[i], f"{name} binding {i} vs serial")
        if i == 0 and name in jax_results:
            _same_rows(g, jax_results[name], f"{name} binding 0 vs the JAX package")
        if CASES[name][1] == "sort":
            # each binding's slice in its requested order (qid-led sort,
            # stable split)
            order = np.lexsort((np.asarray(g["v"]), np.asarray(g["k"])))
            assert np.array_equal(order, np.arange(len(g["k"])))


def test_unbatchable_limit_falls_back_to_singles():
    tctx = _contexts(4)[1]
    t = ctt.Table.from_pydict(tctx, {"k": np.arange(80, dtype=np.int32) % 13,
                                     "v": np.arange(80, dtype=np.float32)})
    lf = t.lazy().sort("k").limit(7)
    assert not is_batchable(lf.plan)
    before = tracing.get_count("serve.singles")
    s = ServeScheduler(tctx, auto_start=False)
    futs = [s.submit(lf), s.submit(t.lazy().sort("k").limit(7))]
    s.run_pending()
    want = lf.collect().to_pydict()
    for f in futs:
        got = f.result(timeout=60).to_pydict()
        for c in got:
            W.same_bits(got[c], want[c], c)
    assert tracing.get_count("serve.singles") == before + 2


def test_collect_async_round_trip():
    """LazyFrame and DataFrame ``collect_async`` through the context's
    shared scheduler: a future whose result equals ``collect()`` (a
    DataFrame for a DataFrame)."""
    tctx = _contexts(4)[1]
    rng = np.random.default_rng(3)
    df = ctt.DataFrame({"a": np.arange(40, dtype=np.int64),
                        "b": rng.integers(0, 9, 40).astype(np.int32)}, ctx=tctx)
    fut = df.collect_async()
    assert isinstance(fut, QueryFuture)
    out = fut.result(timeout=60)
    assert isinstance(out, ctt.DataFrame)
    _same_rows(out.to_table().to_pydict(), df.to_table().to_pydict())
    left, right = _binding(rng, 90)
    lf = _q3(ctt.Table.from_pydict(tctx, left), ctt.Table.from_pydict(tctx, right))
    _same_rows(lf.collect_async().result(timeout=60).to_pydict(), lf.collect().to_pydict())


# ----------------------------------------------------------------------
# admission, leases, caches, failures
# ----------------------------------------------------------------------
def _port_q3(ctx, rng, n):
    left, right = _binding(rng, n)
    return _q3(ctt.Table.from_pydict(ctx, left), ctt.Table.from_pydict(ctx, right))


def test_backpressure_loses_nothing(monkeypatch):
    """16 threads submit and consume their own binding through a worker
    scheduler whose budget admits about three unconsumed queries: with the
    drain frozen the submitters wait (backpressure), a shed past the hard
    cap is retried like a client would, and every query resolves once to
    its own binding's serial result."""
    tctx = _contexts(4)[1]
    rng = np.random.default_rng(4)
    plans = [_port_q3(tctx, rng, 120 + 7 * i) for i in range(16)]
    oracle = [p.collect().to_pydict() for p in plans]
    est = estimate_query_bytes(scan_tables(plans[0].plan))
    monkeypatch.setenv("CYLON_TPU_TORCH_SERVE_INFLIGHT_BYTES", str(3 * max(est, 1)))
    wait0 = tracing.get_count("serve.backpressure.wait")
    s = ServeScheduler(tctx, auto_start=True)
    s.pause()
    barrier = threading.Barrier(16)

    def worker(i):
        barrier.wait()
        while True:
            try:
                fut = s.submit(plans[i])
                break
            except ServeOverloadError:
                time.sleep(0.005)
        return i, fut.result(timeout=120).to_pydict()

    with ThreadPoolExecutor(max_workers=16) as ex:
        pending = [ex.submit(worker, i) for i in range(16)]
        deadline = time.monotonic() + 30
        while tracing.get_count("serve.backpressure.wait") == wait0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert tracing.get_count("serve.backpressure.wait") > wait0
        s.resume()
        results = dict(p.result(timeout=180) for p in pending)
    assert sorted(results) == list(range(16))
    for i in range(16):
        _same_rows(results[i], oracle[i], f"binding {i}")
    assert s.drain(timeout=30) and s.stats()["inflight_bytes"] == 0
    s.close()


def test_shed_error_contract(monkeypatch):
    tctx = _contexts(4)[1]
    rng = np.random.default_rng(5)
    lf = _port_q3(tctx, rng, 100)
    budget0 = tracing.get_count("serve.shed.admission_budget")
    queue0 = tracing.get_count("serve.shed.queue_depth")
    # (a) an estimate alone above the budget sheds at submit, blocking or not
    monkeypatch.setenv("CYLON_TPU_TORCH_SERVE_INFLIGHT_BYTES", "1")
    s = ServeScheduler(tctx, auto_start=False)
    with pytest.raises(ServeOverloadError):
        s.submit(lf)
    assert tracing.get_count("serve.shed.admission_budget") == budget0 + 1
    monkeypatch.delenv("CYLON_TPU_TORCH_SERVE_INFLIGHT_BYTES")
    # (b) a full queue sheds a block=False submit and loses nothing admitted
    monkeypatch.setenv("CYLON_TPU_TORCH_SERVE_QUEUE_DEPTH", "2")
    f1 = s.submit(lf)
    f2 = s.submit(_port_q3(tctx, rng, 90))
    with pytest.raises(ServeOverloadError) as e:
        s.submit(_port_q3(tctx, rng, 80), block=False)
    assert e.value.retryable
    assert tracing.get_count("serve.shed.queue_depth") == queue0 + 1
    s.run_pending()
    assert f1.result(timeout=60).row_count == lf.collect().row_count
    assert f2.exception(timeout=60) is None


def test_lease_released_on_consumption():
    """Leases stay held after dispatch (the split's copy added), release at
    ``result()``, and through the finalizer when a future is dropped."""
    tctx = _contexts(4)[1]
    rng = np.random.default_rng(6)
    s = ServeScheduler(tctx, auto_start=False)
    futs = [s.submit(_port_q3(tctx, rng, 70)) for _ in range(3)]
    held = s.stats()["inflight_bytes"]
    assert held > 0 and s.stats()["leases"] == 3
    s.run_pending()
    assert all(f.done() for f in futs)
    assert s.stats()["inflight_bytes"] > held  # the split's surcharge
    for f in futs:
        f.result(timeout=60)
    assert s.stats()["inflight_bytes"] == 0 and s.stats()["leases"] == 0
    fut = s.submit(_port_q3(tctx, rng, 60))
    s.run_pending()
    assert s.stats()["inflight_bytes"] > 0
    del fut
    gc.collect()
    assert s.stats()["inflight_bytes"] == 0


def test_one_batched_executor_per_bucket(monkeypatch):
    """Eight bindings build one batched executor (bucket 8), the same eight
    again hit it, three build the bucket-4 one."""
    monkeypatch.setenv("CYLON_TPU_TORCH_SERVE_BATCH_MAX", "8")
    tctx = _contexts(4)[1]
    rng = np.random.default_rng(7)
    tables = [_binding(rng, 90 + 5 * i) for i in range(8)]
    tables = [(ctt.Table.from_pydict(tctx, a), ctt.Table.from_pydict(tctx, b)) for a, b in tables]

    def build(a, b):  # a literal no other test uses: a fresh fingerprint
        return (a.lazy().join(b.lazy(), left_on="k", right_on="rk")
                .filter(col("w") > 0.3216549).groupby("k", {"v": "sum"}))

    miss0, hit0 = (tracing.get_count(f"serve.batch_cache.{k}") for k in ("miss", "hit"))
    s = ServeScheduler(tctx, auto_start=False)

    def serve_all(n):
        futs = [s.submit(build(a, b)) for a, b in tables[:n]]
        s.run_pending()
        return [f.result(timeout=120) for f in futs]

    serve_all(8)
    assert tracing.get_count("serve.batch_cache.miss") == miss0 + 1
    serve_all(8)
    assert tracing.get_count("serve.batch_cache.miss") == miss0 + 1
    assert tracing.get_count("serve.batch_cache.hit") == hit0 + 1
    serve_all(3)
    assert tracing.get_count("serve.batch_cache.miss") == miss0 + 2


def test_fault_seams_isolate_the_poisoned_binding(monkeypatch):
    """``serve.batch_exec`` + ``serve.single_exec`` armed on one binding:
    the batch falls back to singles, only that binding fails (typed, its
    lease released), the others return their serial results; a
    ``serve.worker`` death fails its group typed and the next submit
    respawns the worker."""
    tctx = _contexts(4)[1]
    rng = np.random.default_rng(8)
    plans = [_port_q3(tctx, rng, 60 + 3 * i) for i in range(4)]
    oracle = [p.collect().to_pydict() for p in plans]
    monkeypatch.setenv("CYLON_TPU_TORCH_FAULTS",
                       "serve.batch_exec:match=#q2,serve.single_exec:match=#q2")
    tfault.reset()
    try:
        s = ServeScheduler(tctx, auto_start=False)
        futs = [s.submit(p) for p in plans]
        fb0 = tracing.get_count("serve.batch_fallback")
        s.run_pending()
        assert tracing.get_count("serve.batch_fallback") == fb0 + 1
        for i, f in enumerate(futs):
            if i == 2:
                err = f.exception(timeout=30)
                assert isinstance(err, QueryExecError) and err.binding.endswith("#q2")
            else:
                _same_rows(f.result(timeout=30).to_pydict(), oracle[i], f"binding {i}")
        assert s.stats()["leases"] == 0
        monkeypatch.setenv("CYLON_TPU_TORCH_FAULTS", "serve.worker:n=1")
        tfault.reset()
        s2 = ServeScheduler(tctx, auto_start=True)
        f_dead = s2.submit(plans[0])
        assert isinstance(f_dead.exception(timeout=30), WorkerDiedError)
        resp0 = tracing.get_count("serve.worker_respawn")
        f_ok = s2.submit(plans[1])
        _same_rows(f_ok.result(timeout=60).to_pydict(), oracle[1], "after respawn")
        assert tracing.get_count("serve.worker_respawn") >= resp0 + 1
        s2.close()
    finally:
        monkeypatch.delenv("CYLON_TPU_TORCH_FAULTS")
        tfault.reset()


# ----------------------------------------------------------------------
# threads: the port against its own serial results
# ----------------------------------------------------------------------
def test_eight_threads_are_bit_equal_to_serial():
    """Eight threads, each running a mix of cached plans by ``collect``
    and by ``collect_async`` through the shared scheduler, give the serial
    results: ``collect`` bit for bit (one executor, one order), a served
    query its binding's rows (a batch may order them otherwise; a sort
    tail keeps its requested order). The plan cache, the trace ring, the
    metrics and the scheduler under concurrent use."""
    tctx = _contexts(4)[1]
    rng = np.random.default_rng(9)
    plans = [_port_q3(tctx, rng, 100 + 11 * i) for i in range(4)]
    plans += _plans(ctt, tctx, "sort_w4")
    serial = [p.collect().to_pydict() for p in plans]

    def hammer(tid):
        out = []
        for r in range(4):
            i = (tid + r) % len(plans)
            served = (tid + r) % 2 == 0
            t = plans[i].collect_async().result(60) if served else plans[i].collect()
            out.append((i, served, t.to_pydict()))
        return out

    with ThreadPoolExecutor(max_workers=8) as ex:
        for res in ex.map(hammer, range(8)):
            for i, served, got in res:
                assert list(got) == list(serial[i])
                if served:
                    _same_rows(got, serial[i], f"plan {i}")
                    if i >= 4:
                        order = np.lexsort((np.asarray(got["v"]), np.asarray(got["k"])))
                        assert np.array_equal(order, np.arange(len(got["k"])))
                else:
                    for c in got:
                        W.same_bits(got[c], serial[i][c], c)


def test_stampede_builds_one_executor():
    """Eight threads collecting one cold fingerprint at once: one miss,
    seven hits, equal results."""
    tctx = _contexts(4)[1]
    rng = np.random.default_rng(10)
    left, right = _binding(rng, 150)
    a, b = ctt.Table.from_pydict(tctx, left), ctt.Table.from_pydict(tctx, right)
    lf = (a.lazy().join(b.lazy(), left_on="k", right_on="rk")
          .filter(col("w") > 0.7777123).groupby("k", {"v": "sum"}))
    miss0, hit0 = (tracing.get_count(f"plan.cache.{k}") for k in ("miss", "hit"))
    barrier = threading.Barrier(8)

    def go(_):
        barrier.wait()
        return lf.collect().to_pydict()

    with ThreadPoolExecutor(max_workers=8) as ex:
        outs = list(ex.map(go, range(8)))
    assert tracing.get_count("plan.cache.miss") == miss0 + 1
    assert tracing.get_count("plan.cache.hit") >= hit0 + 7
    for o in outs[1:]:
        for c in o:
            W.same_bits(o[c], outs[0][c], c)


def test_eight_readers_of_one_future_release_once():
    """Eight threads reading one future's result get the same table, add
    no host read, and release its lease once (the concurrent materialize
    of the JAX package's tests: one fetch)."""
    tctx = _contexts(4)[1]
    s = ServeScheduler(tctx, auto_start=False)
    fut = s.submit(_port_q3(tctx, np.random.default_rng(12), 80))
    s.run_pending()
    sync0 = tracing.get_count("host_sync")
    with ThreadPoolExecutor(max_workers=8) as ex:
        tables = list(ex.map(lambda _: fut.result(timeout=30), range(8)))
    assert all(t is tables[0] for t in tables)
    assert tracing.get_count("host_sync") == sync0
    assert s.stats()["leases"] == 0 and s.stats()["inflight_bytes"] == 0


# ----------------------------------------------------------------------
# the SLO monitor
# ----------------------------------------------------------------------
@contextlib.contextmanager
def _both_env(**kv):
    saved = {}
    for k, v in kv.items():
        for var in (f"CYLON_TPU_{k}", f"CYLON_TPU_TORCH_{k}"):
            saved[var] = os.environ.get(var)
            os.environ[var] = str(v)
    try:
        yield
    finally:
        for var, v in saved.items():
            if v is None:
                os.environ.pop(var, None)
            else:
                os.environ[var] = v


def test_slo_states_equal_the_jax_packages():
    """The same latencies and counters into both packages' registries: the
    states of every rule after each step, and the ``healthy()`` reasons,
    are the JAX package's; the transitions land in the flight ring."""
    from cylon_tpu.obs import metrics as jmetrics
    from cylon_tpu.utils import tracing as jtr

    key = "slo-rules-fingerprint"
    with _both_env(SERVE_P99_TARGET_MS=10):
        tm, jm = tslo.SLOMonitor(window=1000.0), jslo.SLOMonitor(window=1000.0)
        steps = [
            lambda bump, obs: None,
            lambda bump, obs: [obs(key, 0.004) for _ in range(6)],  # under target
            lambda bump, obs: [obs(key, 0.015) for _ in range(6)],  # warn
            lambda bump, obs: [obs(key, 0.09) for _ in range(30)],  # breach
            lambda bump, obs: bump("serve.shed.admission_budget"),
            lambda bump, obs: bump("serve.shed.unconsumed_cap"),
            lambda bump, obs: bump("serve.errors"),
        ]
        for i, step in enumerate(steps):
            step(tracing.bump, tmetrics.observe_latency)
            step(jtr.bump, jmetrics.observe_latency)
            got, want = tm.evaluate(), jm.evaluate()
            mine = {r: s for r, s in got.items() if not r.startswith("p99:") or key in r}
            theirs = {r: s for r, s in want.items() if not r.startswith("p99:") or key in r}
            assert mine == theirs, (i, mine, theirs)
        assert mine[f"p99:{key}"] == tslo.STATE_BREACH and mine["leak"] == tslo.STATE_BREACH
        assert tm.healthy() == jm.healthy()
        assert any(q.kind == "slo" for q in texport.traces())


def test_healthz_reports_the_slo_rules():
    """The ops endpoint's ``/healthz`` is 200 while no rule breaches and
    503 with the breached rules once one does; ``/metrics`` exposes the
    rule states."""
    tslo.reset_monitor()
    srv = texport.OpsServer(0)
    port = srv.start()
    try:
        base = f"http://127.0.0.1:{port}"
        assert json.loads(urllib.request.urlopen(base + "/healthz", timeout=10).read()) == {
            "ok": True, "reasons": []}
        tracing.bump("serve.shed.unconsumed_cap")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(base + "/healthz", timeout=10)
        assert e.value.code == 503
        assert json.loads(e.value.read()) == {"ok": False, "reasons": ["leak=BREACH"]}
        text = urllib.request.urlopen(base + "/metrics", timeout=10).read().decode()
        assert 'cylon_tpu_torch_slo_state{rule="leak"} 2' in text
        assert texport.validate_prometheus(text) == []
    finally:
        srv.stop()
