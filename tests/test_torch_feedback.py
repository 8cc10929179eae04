"""The feedback re-coster (cylon_tpu_torch/plan/feedback.py and its seams in
obs/store.py, plan/lazy.py, table.py and parallel/spill.py) against the
JAX package's cylon_tpu/plan/feedback.py.

- Pure functions, no JAX compile: every proposer, ``effective_decisions``,
  ``update_profile_decisions`` (through ``ObsStore.record`` sequences: the
  hysteresis, the serve bucket, the spill tier, the sort and codec
  walk-backs), ``describe``, ``plan_schedule(trigger=)`` and the per-axis
  stage clocks give the JAX package's results on the same inputs.
- End to end (tests/test_feedback.py's scenarios): the same sequence of
  collects through both packages, each with an observation directory of
  its own, gives the same sequence of ``Decisions`` (the footprint field
  compared as set or not: the port's exact-length tables hold fewer bytes
  than the JAX package's padded ones, ROADMAP.md C3), one new executor a
  flip, and results equal to the port's ``NO_AUTOTUNE`` oracle (bit for
  bit where the decisions keep each shard's arrival order; under the
  tuned skew trigger the relayed rows arrive last, so float sums agree to
  float32 rounding), which equals the JAX package's. The JAX sequences run once a session
  (``_torch_mp_worker.shared_result``).
- Two gloo ranks whose journals differ take rank 0's decisions, and the
  tuned hop mode at 4x2 equals the JAX package's (both under -m slow).
"""
import contextlib
import os

import numpy as np
import pandas as pd
import pytest
import torch

import cylon_tpu as ct
import cylon_tpu_torch as ctt
from cylon_tpu.obs import prof as jprof
from cylon_tpu.obs import store as jstore
from cylon_tpu.plan import feedback as jfb
from cylon_tpu_torch.obs import prof as tprof
from cylon_tpu_torch.obs import store as tstore
from cylon_tpu_torch.plan import feedback as tfb
from cylon_tpu_torch.plan.lazy import gated_fingerprint as tgf
from cylon_tpu_torch.utils import tracing as ttr
import _torch_mp_worker as W
from test_torch_shuffle_slice import _contexts, _encode
from test_torch_slice import _frames_equal_agg
from test_torch_topology import env  # noqa: F401 - the topology tests' fixture

torch.set_num_threads(1)

#: one knob, both packages' names
KNOBS = ("AUTOTUNE_MIN_OBS", "AUTOTUNE_MARGIN", "SERVE_P99_TARGET_MS", "SERVE_BATCH_MAX",
         "SPILL_DEVICE_BUDGET", "OBS_DIR", "PROF", "NO_AUTOTUNE")


@contextlib.contextmanager
def knobs(**kv):
    """Set each knob under both packages' names (CYLON_TPU_X and
    CYLON_TPU_TORCH_X) for the block, then restore the environment."""
    saved = {}
    for k, v in kv.items():
        for var in (f"CYLON_TPU_{k}", f"CYLON_TPU_TORCH_{k}"):
            saved[var] = os.environ.get(var)
            if v is None:
                os.environ.pop(var, None)
            else:
                os.environ[var] = str(v)
    try:
        yield
    finally:
        for var, v in saved.items():
            if v is None:
                os.environ.pop(var, None)
            else:
                os.environ[var] = v


@pytest.fixture(autouse=True)
def _clean_knobs():
    with knobs(**{k: None for k in KNOBS}):
        tstore.reset_stores()
        yield
        tstore.reset_stores()


# ----------------------------------------------------------------------
# the pure functions
# ----------------------------------------------------------------------
def _profiles():
    """Synthetic profiles that reach every branch of every proposer."""
    base = {"n": 8, "world": 4, "row_bytes": 8, "hot": 64, "mean_bucket": 20,
            "static_budget": 0, "dec": {}}
    return {
        "budget_shrink": dict(base, hot=64),
        "budget_grow": dict(base, hot=3_000_000, row_bytes=24, mean_bucket=40_000),
        "budget_static": dict(base, hot=1 << 18, row_bytes=16),
        "budget_custom_ctx": dict(base, hot=900, static_budget=1 << 22),
        "budget_incumbent": dict(base, hot=500_000, row_bytes=12, dec={"shuffle_budget": 1 << 20}),
        "skew_mild": dict(base, hot=5000, mean_bucket=2200, strag_n=8, strag_sum=24.0),
        "skew_no_straggler": dict(base, hot=5000, mean_bucket=2200, strag_n=8, strag_sum=8.0),
        "skew_heavy": dict(base, hot=9000, mean_bucket=2000, strag_n=8, strag_sum=40.0),
        "skew_too_mild": dict(base, hot=2500, mean_bucket=2000, strag_n=8, strag_sum=40.0),
        "skew_small": dict(base, hot=30, mean_bucket=14, strag_n=8, strag_sum=40.0),
        "hop_saving": dict(base, hop_n=4, hop_i2_sum=400, hop_i1_sum=4000, topo=[4, 2]),
        "hop_no_saving": dict(base, hop_n=4, hop_i2_sum=4000, hop_i1_sum=4000, topo=[4, 2]),
        "hop_degenerate": dict(base, hop_n=4, hop_i2_sum=0, hop_i1_sum=0, topo=[4, 2]),
        "semi_on": dict(base, sel_n=8, sel_sum=0.8),
        "semi_off": dict(base, sel_n=8, sel_sum=7.6),
        "semi_mid": dict(base, sel_n=8, sel_sum=6.0),
        "sort_port_radix": dict(base, sort_ev={"radix": [8, 40.0, 16, 0]}),
        "sort_both_bitonic": dict(base, sort_ev={"radix": [8, 40.0, 16, 32],
                                                 "bitonic": [8, 10.0, 32, 16]}),
        "sort_both_radix": dict(base, sort_ev={"radix": [8, 4.0, 16, 32],
                                               "bitonic": [8, 10.0, 32, 16]}),
        "sort_radix_only_slow": dict(base, sort_ev={"radix_pallas": [8, 80.0, 16, 8]}),
        "sort_bitonic_only": dict(base, sort_ev={"bitonic": [8, 8.0, 16, 64]}),
        "sort_thin": dict(base, sort_ev={"radix": [1, 8.0, 2, 2]}),
        "codec_port": dict(base, codec_ev={"cuda": [8, 2.0, 24, 8], "plain": [8, 9.0, 24, 8]}),
        "codec_both_xla": dict(base, codec_ev={"xla": [8, 2.0, 24, 8], "pallas": [8, 9.0, 8, 24]}),
        "codec_pallas_only": dict(base, codec_ev={"pallas": [8, 2.0, 8, 24]}),
        "codec_xla_only": dict(base, codec_ev={"xla": [8, 9.0, 24, 8]}),
        "footprint": dict(base, foot={"b": {"100": 5, "104": 3}, "n": 8, "total": 1.0,
                                      "min": 9.0e9, "max": 2.5e10}),
        "serve_slow": dict(base, serve_lat={"b": {"-24": 8}, "n": 8, "total": 0.8, "min": 0.1,
                                            "max": 0.1}, lat={"b": {}, "n": 0}),
        "serve_fast": dict(base, dec={"serve_bucket": 4},
                           serve_lat={"b": {"-96": 8}, "n": 8, "total": 8e-4, "min": 1e-4,
                                      "max": 1e-4}, lat={"b": {}, "n": 0}),
    }


PROFILES = _profiles()


@pytest.mark.parametrize("name", list(PROFILES))
def test_proposers_equal_the_jax_packages(name):
    """Every proposer, the exec and the latency proposal sets and
    ``effective_decisions`` on one profile, against the JAX package's."""
    p = PROFILES[name]
    with knobs(AUTOTUNE_MIN_OBS=4, SERVE_P99_TARGET_MS=20, SPILL_DEVICE_BUDGET=1 << 16):
        for mg in (0.0, 0.2):
            for fn in ("_budget_proposal", "_skew_trigger_proposal", "_hop_mode_proposal"):
                if fn == "_budget_proposal" or p.get("strag_n") or p.get("hop_n"):
                    assert getattr(tfb, fn)(dict(p), mg) == getattr(jfb, fn)(dict(p), mg), fn
            for fn in ("_sort_impl_proposal", "_codec_impl_proposal"):
                assert getattr(tfb, fn)(dict(p), mg, 4) == getattr(jfb, fn)(dict(p), mg, 4), fn
            if "serve_lat" in p:
                assert tfb._serve_bucket_proposal(dict(p), 0.02, mg) == \
                    jfb._serve_bucket_proposal(dict(p), 0.02, mg)
        for kind in ("exec", "lat"):
            assert tfb._proposals(dict(p), kind) == jfb._proposals(dict(p), kind), kind
        for dec in ({}, {"semi_mode": "static", "sort_impl": "static", "codec_impl": "xla"},
                    {"hop_mode": "1hop", "skew_trigger": 2, "footprint": 4096}):
            assert tfb.effective_decisions(dict(p, dec=dec)) == \
                jfb.effective_decisions(dict(p, dec=dec))


def _rec(kind, **kv):
    return dict({"k": kind, "fp": "shape"}, **kv)


SEQUENCES = {
    # alternating selectivity around the middle band: no flapping, then a
    # consistent low selectivity flips the semi gate once (the no-flap pin)
    "hysteresis": [_rec("exec", world=4, row_bytes=8, hot=64, sel=[s, s], sketch_built=2)
                   for s in [0.3, 0.95] * 30 + [0.05] * 30],
    # 10 ms against a 1 ms target halves the bucket; fast samples under
    # the new bucket walk it back to the maximum
    "serve_bucket": [_rec("lat", s=0.010, b=16)] * 4 + [_rec("lat", s=0.0001, b=8)] * 8,
    # staged at 90% of the device budget: promote before the line; then
    # under the low-water mark: release
    "spill_tier": [_rec("exec", world=4, row_bytes=8, hot=64, staged=int(0.9 * (1 << 20)),
                        tier=0)] * 4
    + [_rec("exec", world=4, row_bytes=8, hot=64, staged=1 << 10, tier=0)] * 4,
    # mild skew with straggler evidence flips the trigger; budget too
    "skew": [_rec("exec", world=8, row_bytes=12, hot=2000, mean_bucket=900, strag=3.5)] * 6,
    "hop": [_rec("exec", world=8, row_bytes=8, hot=50, topo=[4, 2], hop2=True, intra=100,
                 inter=900, inter_alt=1000)] * 5,
    # the port's own sort and codec evidence proposes nothing; the JAX
    # package's engines' evidence walks back
    "impls": [_rec("exec", world=1, row_bytes=8, hot=0, sort={"radix": [1, 4.0, 4, 0]},
                   codec={"cuda": [1, 1.0, 3, 0]})] * 4
    + [_rec("exec", world=1, row_bytes=8, hot=0, sort={"radix": [1, 40.0, 4, 2]},
            codec={"pallas": [1, 9.0, 1, 3]})] * 8,
    "footprint": [_rec("exec", world=2, row_bytes=8, hot=10, dev=d) for d in
                  [5000, 7000, 6000, 120000, 8000, 9000, 7000, 7500]],
}


@pytest.mark.parametrize("name", list(SEQUENCES))
def test_store_decision_sequences_equal_the_jax_packages(tmp_path, name):
    """The same records into both packages' stores: after every record the
    tuned decisions, the hysteresis streaks, the flips and the cached
    effective tuple are the JAX package's."""
    with knobs(AUTOTUNE_MIN_OBS=3 if name == "hysteresis" else 2, SERVE_P99_TARGET_MS=1.0,
               SERVE_BATCH_MAX=16, SPILL_DEVICE_BUDGET=1 << 20):
        ts = tstore.ObsStore(str(tmp_path / "t"), compact_every=10 ** 9)
        js = jstore.ObsStore(str(tmp_path / "j"), compact_every=10 ** 9)
        seen = []
        for rec in SEQUENCES[name]:
            ts.record(dict(rec))
            js.record(dict(rec))
            tp, jp = ts.profiles["shape"], js.profiles["shape"]
            assert (tp["dec"], tp["pend"], tp["flips"], tp["_dec"]) == \
                (jp["dec"], jp["pend"], jp["flips"], jp["_dec"])
            seen.append(tp["_dec"])
        ts.close()
        js.close()
    assert len(set(seen)) > 1, "the sequence never moved a decision"
    if name == "hysteresis":
        assert tp["dec"].get("semi_mode") == "on" and tp["flips"] <= 3
    if name == "serve_bucket":
        assert tp["lat"]["n"] == 12 and tp["dec"].get("serve_bucket") in (16, None)
    if name == "impls":
        # the port's one sort engine and one codec propose nothing; the
        # JAX package's radix/bitonic evidence walks the sort back
        assert [d[7:] for d in seen[:4]] == [(None, None)] * 4
        assert seen[-1][7] == "bitonic"


def test_describe_equals_the_jax_packages(tmp_path):
    """The ``explain(analyze=True)`` annotations of a profile that tuned
    every gate, line for line (the port's footprint value is its own)."""
    base = ("plan", True, True, True, ("gates",))
    with knobs(OBS_DIR=str(tmp_path), AUTOTUNE_MIN_OBS=1, SPILL_DEVICE_BUDGET=1 << 20,
               SERVE_P99_TARGET_MS=1.0):
        tstore.reset_stores()
        jstore.reset_stores()
        assert tfb.base_key(base) == jfb.base_key(base)
        recs = [_rec("exec", world=8, row_bytes=12, hot=2000, mean_bucket=900, strag=3.5,
                     sel=[0.1, 0.1], sketch_built=2, topo=[4, 2], hop2=True, inter=900,
                     inter_alt=1000, staged=int(0.9 * (1 << 20)), dev=5000),
                _rec("lat", s=0.01, b=16)]
        for _ in range(8):
            for r in recs:
                r = dict(r, fp=tfb.base_key(base))
                tstore.store().record(dict(r))
                jstore.store().record(dict(r))
        got, want = tfb.describe(base), jfb.describe(base)
        assert len(got) >= 6 and got == want
        assert tfb.decisions_for(base) == tfb.Decisions(*jfb.decisions_for(base))
        with tfb.autotune_disabled():
            assert tfb.describe(base) == [] and tfb.fingerprint_component(base) == \
                (False, tfb.DECISIONS_OFF)
        jstore.reset_stores()


def test_plan_schedule_trigger_equals_the_jax_schedule():
    """``spill.plan_schedule(trigger=)`` (the tuned skew trigger) against
    the JAX package's on mild, heavy and uniform count matrices."""
    from cylon_tpu.parallel import spill as jspill
    from cylon_tpu_torch.parallel import spill as tspill

    rng = np.random.default_rng(5)
    for world in (4, 8):
        mats = [np.full((world, world), 100, np.int64), rng.integers(0, 400, (world, world))]
        for hot in (250, 380, 1200):
            m = np.full((world, world), 100, np.int64)
            m[:, 1] = hot
            mats.append(m)
        for m in mats:
            for trigger in (None, 2, 3, 4):
                for budget in (1 << 12, 1 << 16, 1 << 20):
                    got = tspill.plan_schedule(m, 8, world, budget, trigger=trigger)
                    want = jspill.plan_schedule(m, 8, world, budget, trigger=trigger)
                    assert (got.bucket_cap, got.n_rounds) == (want.bucket_cap, want.n_rounds)
                    assert (got.relay is None) == (want.relay is None)
                    if got.relay is not None:
                        np.testing.assert_array_equal(got.relay, want.relay)
    assert tspill.choose_tier(1024, tuned=1) == 1 and tspill.choose_tier(1024) == 0


def test_per_axis_stage_clocks_equal_the_jax_packages():
    """A two-hop plan splits the collective clock per axis, a flat one
    keeps the merged track (the JAX package's tests/test_topology.py);
    the per-axis units equal the JAX package's, whose weights they share."""
    counts = np.full((8, 8), 10, np.int64)
    for topo_plan in (None, (4, 2, 32, 1)):
        got = tprof.shuffle_units([(counts, 1, 16, None, topo_plan)], 8)
        want = jprof.shuffle_units([(counts, 1, 16, None, topo_plan)], 8)
        assert set(got) == set(want)
        for stage in ("collective", "coll_inner", "coll_outer", "compact"):
            if stage in want:
                np.testing.assert_array_equal(got[stage], want[stage])
    assert "collective" not in got and got["coll_inner"].sum() > 0


# ----------------------------------------------------------------------
# end to end against the JAX package's sequences
# ----------------------------------------------------------------------
RUNS = 7


#: the scenarios run through the JAX package too (``pair`` is the port's
#: alone: its decisions are a prefix of ``skew``'s, the semi decision and
#: the budget, which the store tests above hold against the JAX package)
JAX_HELD = ("skew",)
#: each scenario's value column: a plan shape (and its executors) of its own
VALUE = {"pair": "v", "skew": "sk"}


def _scenario(name):
    """(left, right) host columns: ``pair``, tests/test_feedback.py's
    ``_pair`` at selectivity 1.0 (3000 rows); ``skew``, its
    ``_mild_skew_pair`` (12,000 rows, 40% on one key: about 2.2x the
    mean bucket)."""
    rng = np.random.default_rng(11)
    if name == "pair":
        n = 3000
        ks = n // 6
        lk = rng.integers(0, ks, n).astype(np.int32)
        rk = rng.integers(0, ks, n // 2).astype(np.int32)
        return ({"k": lk, VALUE[name]: rng.random(n).astype(np.float32)},
                {"rk": rk, "w": rng.random(n // 2).astype(np.float32)})
    n = 12_000
    nh = int(n * 0.4)
    k = rng.permutation(np.concatenate([np.zeros(nh, np.int32),
                                        rng.integers(1, n // 3, n - nh).astype(np.int32)]))
    return ({"k": k, VALUE[name]: rng.random(n).astype(np.float32)},
            {"rk": k.copy(), "w": rng.random(n).astype(np.float32)})


def _plan(mod, ctx, name):
    left, right = (_encode(c) for c in _scenario(name))
    lt, rt = mod.Table.from_encoded(ctx, left), mod.Table.from_encoded(ctx, right)
    return lt.lazy().join(rt.lazy(), left_on="k", right_on="rk", how="inner").groupby(
        "k", {VALUE[name]: "sum"})


def _dec_key(d):
    """A Decisions record with the footprint read as set or not."""
    return tuple(d)[:4] + (d.footprint is not None,) + tuple(d)[5:]


def _sorted_frame(pydict):
    return pd.DataFrame(pydict).sort_values("k").reset_index(drop=True)


def _drive(mod, tr, gf, fb, store, ctx, name, obs_dir):
    """The scenario's sequence of collects under a fresh store: the
    Decisions after each, new executors, flips, shipped bytes a run, each
    result, the NO_AUTOTUNE oracle and the tuned-gates lines."""
    env = dict(OBS_DIR=obs_dir, AUTOTUNE_MIN_OBS=2, PROF=1 if name == "skew" else None)
    with knobs(**env):
        store.reset_stores()
        lf = _plan(mod, ctx, name)
        m0 = tr.get_count("plan.cache.miss")
        decs, shipped, results = [], [], []
        for _ in range(RUNS):
            b0 = tr.get_trace_report().get("shuffle.exchanged_bytes", {}).get("rows", 0)
            results.append(lf.collect().to_pydict())
            shipped.append(tr.get_trace_report()["shuffle.exchanged_bytes"]["rows"] - b0)
            decs.append(_dec_key(gf(lf.plan)[-1][1]))
        misses = tr.get_count("plan.cache.miss") - m0
        flips = sum(p.get("flips", 0) for p in store.store().profiles.values())
        # the footprint line's bytes are each package's own (C3)
        tuned = [ln for ln in lf.explain(analyze=True).splitlines()
                 if "tuned:" in ln and "footprint" not in ln]
        oracle = None
        if mod is ctt:
            with fb.autotune_disabled():
                oracle = lf.collect().to_pydict()
        store.reset_stores()
    return {"decs": decs, "misses": misses, "flips": flips, "shipped": shipped,
            "results": results, "oracle": oracle, "tuned": tuned}


def _jax_sequences(tmp):
    from cylon_tpu.plan.lazy import gated_fingerprint as jgf
    from cylon_tpu.utils import tracing as jtr

    jctx = _contexts(4)[0]
    out = {}
    with knobs(NO_AUTOTUNE=None), contextlib.ExitStack() as st:
        for k in ("CYLON_TPU_NO_QUANT", "CYLON_TPU_NO_TOPO"):
            st.enter_context(_env_var(k, "1"))
        for name in JAX_HELD:
            jprof.reset()
            got = _drive(ct, jtr, jgf, jfb, jstore, jctx, name, str(tmp / f"jax_{name}"))
            # the JAX package's own test holds its tuned result to its
            # NO_AUTOTUNE oracle: its last tuned result stands for both
            got["oracle"] = got.pop("results")[-1]
            out[name] = got
    return out


@contextlib.contextmanager
def _env_var(var, value):
    prev = os.environ.get(var)
    os.environ[var] = value
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop(var, None)
        else:
            os.environ[var] = prev


@pytest.fixture(scope="module")
def jax_sequences(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_feedback")
    return W.shared_result(tmp_path_factory, "jax_feedback", lambda: _jax_sequences(tmp))


@pytest.mark.parametrize("name", ["pair", "skew"])
def test_decision_sequence_equals_the_jax_packages(jax_sequences, tmp_path, name):
    """tests/test_feedback.py's warm-up, flip and skew-trigger scenarios:
    each flip builds exactly one new executor (1 + flips misses, as
    there), every tuned result equals the NO_AUTOTUNE oracle (bit for bit
    in ``pair``); in ``skew`` the Decisions after every collect, the
    misses, the flips and the tuned-gates lines are the JAX package's, and
    the oracle equals its result."""
    tctx = _contexts(4)[1]
    tprof.reset()
    got = _drive(ctt, ttr, tgf, tfb, tstore, tctx, name, str(tmp_path / "obs"))
    want = jax_sequences.get(name)
    if want is not None:
        assert got["decs"] == want["decs"]
        assert (got["misses"], got["flips"]) == (want["misses"], want["flips"])
        _frames_equal_agg(_sorted_frame(got["oracle"]), _sorted_frame(want["oracle"]))
        assert got["tuned"] == want["tuned"]
    assert got["flips"] >= 2 and got["misses"] == 1 + got["flips"]
    assert [d[1] for d in got["decs"][:2]] == ["explore", "off"]
    for res in got["results"]:
        if name == "pair":
            for c in got["oracle"]:
                W.same_bits(res[c], got["oracle"][c], c)
        else:
            # the tuned trigger relays the hot key's tail, which reaches
            # its shard after the rounds' rows: the same rows and groups,
            # float sums added in another order (the JAX package's test
            # compares them with allclose too)
            _frames_equal_agg(_sorted_frame(res), _sorted_frame(got["oracle"]))
    if name == "skew":
        assert got["decs"][-1][5] == tfb.SKEW_TRIGGER_TUNED
        assert got["shipped"][-1] < got["shipped"][0], got["shipped"]
    else:
        assert got["decs"][-1][1] == "off"  # the semi decision settled
    assert any(ln.strip().startswith("semi_filter tuned: off (was payoff>=")
               for ln in got["tuned"])


def test_kill_switch_rekeys_and_settled_store_builds_nothing(tmp_path):
    """The kill switch re-keys the fingerprint (the component is (active,
    Decisions), the constant off state without a store, as in the JAX
    package); a settled store's collects hit the plan cache."""
    tctx = _contexts(4)[1]
    with knobs(OBS_DIR=str(tmp_path), AUTOTUNE_MIN_OBS=2):
        tstore.reset_stores()
        lf = _plan(ctt, tctx, "pair")
        fp_on = tgf(lf.plan)
        with tfb.autotune_disabled():
            fp_off = tgf(lf.plan)
        assert fp_on != fp_off and fp_on[-1] == (True, tfb.Decisions(semi_mode="explore"))
        assert fp_off[-1] == (False, tfb.DECISIONS_OFF)
        for _ in range(6):
            lf.collect()
        m1 = ttr.get_count("plan.cache.miss")
        for _ in range(3):
            lf.collect()
        assert ttr.get_count("plan.cache.miss") == m1
    tstore.reset_stores()
    assert tgf(lf.plan)[-1] == (False, tfb.DECISIONS_OFF)


def test_skew_trigger_stays_static_without_straggler_evidence(tmp_path):
    """No profiler, no straggler evidence: the skew trigger never flips
    (the proposer asks for measured shard-time ratios, not a histogram)."""
    tctx = _contexts(4)[1]
    with knobs(OBS_DIR=str(tmp_path), AUTOTUNE_MIN_OBS=2, PROF=None):
        tstore.reset_stores()
        lf = _plan(ctt, tctx, "skew")
        for _ in range(5):
            lf.collect()
        assert all(p.get("dec", {}).get("skew_trigger") is None
                   for p in tstore.store().profiles.values())


@pytest.mark.slow
def test_tuned_hop_mode_equals_the_jax_package(env):
    """Under a tuned ``hop_mode="1hop"`` a 4x2 shuffle takes the flat
    exchange, shard for shard and counter for counter the JAX package's
    under the same decision; its ``inter_alt`` carries the two-hop
    cross-outer bytes and its ``inter`` the flat ones, the pair the
    hop-mode proposer compares."""
    from cylon_tpu.utils import tracing as jtr
    from test_torch_topology import (_locality_shards, _shards_equal, _tables, counters_equal,
                                     multisets_equal)

    rng = np.random.default_rng(23)
    k = _locality_shards(rng, 8, 2, 512)
    jt, tt = _tables("4x2", 8, {"k": k, "v": rng.normal(size=k.size).astype(np.float32)})
    got2 = tt.shuffle(["k"])
    _shards_equal(jt.shuffle(["k"]), got2)
    c2 = counters_equal()
    jtr.reset_trace()
    ttr.reset_trace()
    with tfb.applying((True, tfb.Decisions(hop_mode="1hop"))), \
            jfb.applying((True, jfb.Decisions(hop_mode="1hop"))):
        got1 = tt.shuffle(["k"])
        _shards_equal(jt.shuffle(["k"]), got1)
    c1 = counters_equal()
    assert c1["shuffle.coll_bytes.inter_alt"][1] == c2["shuffle.coll_bytes.inter"][1]
    assert c1["shuffle.coll_bytes.inter"][1] == c2["shuffle.coll_bytes.inter_alt"][1]
    assert c1["shuffle.coll_bytes.inter"][1] > c2["shuffle.coll_bytes.inter"][1]
    multisets_equal(got1, got2)


@pytest.mark.slow
def test_ranks_with_different_journals_take_the_same_decisions(tmp_path):
    """Two gloo ranks, rank 0's journal holding high-selectivity evidence
    (semi "off": no sketch) and rank 1's none (semi "explore": build the
    sketch, a collective): both take rank 0's decisions, and the result
    equals one process's collect."""
    codes, logs, _secs = W.run_ranks(tmp_path, 2, ["feedback"], limit=120.0)
    assert codes == [0, 0], logs
    ranks = W.load_ranks(tmp_path, 2)
    comps = [r["feedback"]["component"] for r in ranks]
    assert comps[0] == comps[1] and comps[0][1].semi_mode == "off", comps
    assert [r["feedback"]["own"] for r in ranks] == ["off", "explore"]
    one = ctt.CylonContext.init_distributed(ctt.GPUConfig(device="cpu", world_size=2))
    want = W.case_feedback_plan(one).collect()
    for d, r in enumerate(ranks):
        got = r["feedback"]["result"]
        assert got["counts"].tolist() == want.row_counts.tolist()
        for c in want.column_names:
            phys, valid = want._host_physical_shard(c, d)
            W.same_bits(got["shards"][d][c][0], phys, c)
